"""Per-layer metric spmm_csr_roofline: the CSR SpMM's share of its bound
(``llcg_bench.bounds.spmm_csr_work`` over ``spmm_csr_kernel``'s device
time)."""
from llcg_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "spmm_csr_kernel", "spmm_csr")
