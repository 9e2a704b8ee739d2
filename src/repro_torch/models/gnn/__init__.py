"""GNN models: layers, aggregation layouts and arch-string assembly."""
from repro_torch.models.gnn.agg import (
    LAYOUTS,
    AggOperands,
    build_agg_operands,
    choose_layout,
)
from repro_torch.models.gnn.layers import (
    gcn_layer,
    sage_layer,
    gat_layer,
    linear_layer,
    batch_norm,
    mean_aggregate,
    sym_aggregate,
)
from repro_torch.models.gnn.model import (
    GNNModel,
    build_model,
    cross_entropy_on_batch,
    f1_micro,
)

__all__ = [
    "LAYOUTS",
    "AggOperands",
    "build_agg_operands",
    "choose_layout",
    "gcn_layer",
    "sage_layer",
    "gat_layer",
    "linear_layer",
    "batch_norm",
    "mean_aggregate",
    "sym_aggregate",
    "GNNModel",
    "build_model",
    "cross_entropy_on_batch",
    "f1_micro",
]
