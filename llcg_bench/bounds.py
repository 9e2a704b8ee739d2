"""Frozen operation and byte counts of the work, from shapes.

A later implementation of the same work is held to the same counts, so
these functions never change.  Each counts what the work needs: every
input byte read once and every output byte written once, whatever a kernel
reads again or saves for a backward, and a multiply-add as two operations.
"""
from __future__ import annotations

from typing import Sequence, Tuple


# --------------------------------------------------------------------------
# CSR SpMM: out = A @ H on an (n, n) matrix with nnz stored entries
# --------------------------------------------------------------------------
def spmm_csr_work(n: int, nnz: int, d: int) -> Tuple[float, float]:
    """``(bytes, operations)`` of one SpMM of width ``d``: indptr, indices
    and values read once, H read once, the output written once; a
    multiply-add per stored entry and column."""
    nbytes = 4 * (n + 1) + 8 * nnz + 4 * n * d + 4 * n * d
    return float(nbytes), 2.0 * nnz * d


# --------------------------------------------------------------------------
# whole-step model FLOPs
# --------------------------------------------------------------------------
def sage_stack_flops(layers: Sequence[Tuple[str, int, int]], n: int,
                     edges: int, backward: bool) -> float:
    """FLOPs of one forward (and, with ``backward``, its backward) of an
    operator stack over ``n`` nodes aggregating over ``edges`` neighbor
    entries.  ``layers`` holds ``(op, d_in, d_out)``: ``S`` (SAGE: two
    d_in x d_out products and a mean over the edges), ``B`` (BatchNorm, 8
    operations an element), ``L``/``G`` (one product; G also a mean).  The
    backward takes the weight gradients of every product and, above the
    first layer, the input gradients (the features take none)."""
    total = 0.0
    for i, (op, d_in, d_out) in enumerate(layers):
        mats = {"S": 2, "G": 1, "L": 1}.get(op, 0)
        mm = 2.0 * n * d_in * d_out * mats
        agg = 2.0 * edges * d_in if op in ("S", "G") else 0.0
        elem = 8.0 * n * d_in if op == "B" else 0.0
        total += mm + agg + elem
        if backward:
            total += mm + elem
            if i > 0:
                total += mm + agg
    return total
