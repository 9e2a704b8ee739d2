"""Graph substrate: CSR containers, partitioning, host sampling and
synthetic datasets (numpy; copies of the JAX package's modules)."""
