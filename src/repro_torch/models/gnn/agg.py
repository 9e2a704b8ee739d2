"""Aggregation-layout engine: one pluggable aggregate op, several layouts.

Every GNN aggregation lowers by default to the padded neighbor-table form
``h[table] → (N, fanout, d)``, whose cost is ``N·fanout·d`` however much of
the table is padding.  That suits the sampled local rounds; the server
correction runs *full-neighbor* forwards where the table is mostly zeros.
This module makes the layout a selectable property:

``layout="padded"``
    The dense gather + masked reduction (``agg=None`` in the layers).

``layout="bcsr_kernel"``
    Full-graph aggregation through the hand-written SpMM
    (:func:`repro_torch.kernels.spmm.spmm_csr`) with an unnormalized-
    adjacency operand (symmetric, so the backward reuses the same
    operands); the GAT softmax-aggregate routes through the fused
    edge-softmax kernel.  The name is the JAX package's, whose kernel takes
    block-sparse tiles; on the card the operands are CSR.

``layout="csr"``
    The edge-centric segment-sum path of the JAX package.  Not ported yet:
    asking for it raises (ROADMAP Queue 1 item 5).

``layout="auto"``
    :func:`choose_layout` picks per (graph, table width, sampling) with the
    JAX package's cost model.

Operands are built on the host once per graph and cached on the graph
object, so no layout pays a rebuild inside the round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph

#: Selectable aggregation layouts (the JAX package's set).
LAYOUTS = ("padded", "csr", "bcsr_kernel", "auto")

#: ``auto`` picks the edge-centric path once padded work ≥ threshold · edge
#: work.
AUTO_THRESHOLD = 2.0

_CSR_NOT_PORTED = ("the 'csr' aggregation layout is not ported yet "
                   "(ROADMAP Queue 1 item 5, the csr layout); use 'padded' or "
                   "'bcsr_kernel'")


@dataclasses.dataclass(frozen=True)
class BCSROps:
    """Device-resident CSR operands of the UNnormalized adjacency, for the
    ``bcsr_kernel`` layout.

    Normalization is applied outside the kernel as row/column scalings
    (mean = ``diag(1/deg)·A``, sym = ``diag(nrm)·A·diag(nrm)``), so ONE
    operand set serves every aggregate op and — A being symmetric — the
    backward pass reuses the same operands as the forward.
    """

    indptr: torch.Tensor      # (N+1,) int32
    indices: torch.Tensor     # (nnz,) int32
    values: torch.Tensor      # (nnz,) f32
    items: Optional[torch.Tensor]   # (2, n_items) int32 row split, or None
    inv_deg: torch.Tensor     # (N,) f32 — 1/max(deg,1)


@dataclasses.dataclass(frozen=True)
class AggOperands:
    """The resolved layout + its prebuilt operands, threaded through
    ``GNNModel.apply`` down to the aggregate ops.  ``None`` anywhere in the
    stack means the padded path."""

    layout: str               # "bcsr_kernel"
    bcsr: Optional[BCSROps] = None


def _graph_cache(graph: CSRGraph) -> dict:
    cache = graph.__dict__.get("_agg_operand_cache")
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_agg_operand_cache", cache)
    return cache


def bcsr_operands(graph: CSRGraph, device) -> BCSROps:
    """The graph's unnormalized CSR operands + degree scaling, cached."""
    from repro_torch.kernels.ops import csr_device_operands
    device = torch.device(device)
    indptr, indices, values, items = csr_device_operands(graph, device,
                                                         "none")
    cache = _graph_cache(graph)
    key = ("bcsr", str(device))
    ops = cache.get(key)
    if ops is None:
        deg = np.maximum(graph.degrees(), 1).astype(np.float32)
        ops = BCSROps(indptr=indptr, indices=indices, values=values,
                      items=items,
                      inv_deg=torch.from_numpy(1.0 / deg).to(device))
        cache[key] = ops
    return ops


def build_agg_operands(graph: CSRGraph, layout: str,
                       device) -> Optional[AggOperands]:
    """Resolve a concrete (non-auto) layout into its prebuilt operands on
    ``device``.  ``"padded"`` → ``None`` (the dense path)."""
    if layout in (None, "padded"):
        return None
    if layout == "csr":
        raise ValueError(_CSR_NOT_PORTED)
    if layout == "bcsr_kernel":
        return AggOperands("bcsr_kernel", bcsr=bcsr_operands(graph, device))
    raise ValueError(f"unknown aggregation layout {layout!r}; "
                     f"choose one of {LAYOUTS}")


def choose_layout(layout: str, *, num_nodes: int, num_edges: int,
                  width: int, full_width: int, sampled: bool = False,
                  threshold: float = AUTO_THRESHOLD) -> str:
    """Resolve ``"auto"`` via the padding-fraction cost model.

    Padded-table work scales with ``num_nodes·width``; edge-centric work
    with ``num_edges``.  Sampled or narrowed tables (``width <
    full_width``) are different math from the full edge set and always
    resolve to padded.  ``auto`` never picks ``bcsr_kernel``, exactly as in
    the JAX package, so the two resolve every input alike.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown aggregation layout {layout!r}; "
                         f"choose one of {LAYOUTS}")
    if layout != "auto":
        return layout
    if sampled or width < full_width:
        return "padded"
    padded_work = num_nodes * max(int(width), 1)
    if padded_work >= threshold * max(int(num_edges), 1):
        return "csr"
    return "padded"


# --------------------------------------------------------------------------
# SpMM primitives (bcsr_kernel layout)
# --------------------------------------------------------------------------
class _BCSRMatvec(torch.autograd.Function):
    """``A @ x`` through the CSR SpMM.  A is symmetric, so the backward is
    the SAME kernel on the SAME operands applied to the cotangent; the
    operands are structural and get no gradient."""

    @staticmethod
    def forward(ctx, x, ops):
        from repro_torch.kernels.spmm import spmm_csr
        ctx.ops = ops
        ctx.x_dtype = x.dtype
        return spmm_csr(ops.indptr, ops.indices, ops.values, x.float(),
                        ops.items)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.spmm import spmm_csr
        ops = ctx.ops
        gx = spmm_csr(ops.indptr, ops.indices, ops.values, g.float(),
                      ops.items)
        return gx.to(ctx.x_dtype), None


def bcsr_matvec(h: torch.Tensor, ops: BCSROps) -> torch.Tensor:
    """``A @ h`` through the CSR SpMM, dtype-preserving."""
    return _BCSRMatvec.apply(h, ops).to(h.dtype)


def bcsr_mean_aggregate(h: torch.Tensor, ops: BCSROps) -> torch.Tensor:
    return bcsr_matvec(h, ops) * ops.inv_deg[:, None].to(h.dtype)


def bcsr_sym_aggregate(h: torch.Tensor, ops: BCSROps,
                       normalizers: torch.Tensor) -> torch.Tensor:
    nrm = normalizers.to(h.dtype)[:, None]
    return bcsr_matvec(h * nrm, ops) * nrm
