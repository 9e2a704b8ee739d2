"""Graph substrate: CSR containers, partitioning, sampling, synthetic
datasets and halo plans (numpy, copies of the JAX package's modules; the
device sampler in torch).

* :mod:`repro_torch.graph.csr`        — CSR container + padded neighbor
  tables.
* :mod:`repro_torch.graph.partition`  — partitioners + cut-edge stats.
* :mod:`repro_torch.graph.sampling`   — neighbor sampling on the host and
  on the device (the JAX package's ``jax.random`` stream, bit for bit).
* :mod:`repro_torch.graph.datasets`   — synthetic SBM/R-MAT/grid graphs.
* :mod:`repro_torch.graph.halo`       — halo exchange plans and programs.
"""
from repro_torch.graph.csr import (CSRGraph, build_neighbor_table,
                                   symmetric_normalizers)
from repro_torch.graph.partition import (
    Partition,
    partition_graph,
    greedy_bfs_partition,
    random_partition,
    spectralish_partition,
    cut_edge_stats,
    extract_local_subgraph,
)
from repro_torch.graph.sampling import (
    DeviceCSR,
    NeighborSampler,
    build_device_csr,
    sample_minibatch,
    sample_neighbors,
    sample_round_device,
    sample_serving_tables_device,
)
from repro_torch.graph.datasets import (SyntheticDataset, grid_graph,
                                        make_dataset, rmat_graph, sbm_graph)
from repro_torch.graph.halo import (
    HaloPlan,
    HaloProgram,
    build_halo_plan,
    build_halo_program,
    halo_exchange_reference,
)

__all__ = [
    "CSRGraph",
    "build_neighbor_table",
    "symmetric_normalizers",
    "Partition",
    "partition_graph",
    "greedy_bfs_partition",
    "random_partition",
    "spectralish_partition",
    "cut_edge_stats",
    "extract_local_subgraph",
    "NeighborSampler",
    "sample_neighbors",
    "sample_minibatch",
    "DeviceCSR",
    "build_device_csr",
    "sample_round_device",
    "sample_serving_tables_device",
    "sbm_graph",
    "rmat_graph",
    "grid_graph",
    "SyntheticDataset",
    "make_dataset",
    "HaloPlan",
    "HaloProgram",
    "build_halo_plan",
    "build_halo_program",
    "halo_exchange_reference",
]
