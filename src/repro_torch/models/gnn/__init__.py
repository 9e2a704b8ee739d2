"""GNN models: layers, aggregation layouts and arch-string assembly."""
