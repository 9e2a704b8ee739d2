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
    The edge-centric path: a segment sum over the graph's edge list costs
    ``E·d`` with no padding.  The mean/sym reductions go through
    :func:`edge_weighted_sum`, an ``autograd.Function`` whose backward is
    the transposed scatter-add over edges, never a dense-table gradient;
    the GAT softmax is a per-edge, segment-max-stabilized softmax.  Plain
    PyTorch (``index_add`` / ``scatter_reduce``), as the JAX package
    computes it outside any Pallas kernel.

``layout="auto"``
    :func:`choose_layout` picks per (graph, table width, sampling) with the
    JAX package's cost model.

Operands are built on the host once per graph and cached on the graph
object, so no layout pays a rebuild inside the round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph

#: Selectable aggregation layouts (the JAX package's set).
LAYOUTS = ("padded", "csr", "bcsr_kernel", "auto")

#: ``auto`` picks the edge-centric path once padded work ≥ threshold · edge
#: work.
AUTO_THRESHOLD = 2.0


@dataclasses.dataclass(frozen=True)
class EdgeCSR:
    """Edge-list operands for the ``csr`` layout, on a device.

    ``seg[e]`` is the owning (destination) row of edge ``e`` and ``nbr[e]``
    the neighbor gathered from; both are int64, torch's index dtype.  One
    graph's operands are ``(E,)`` and have no padding edge.  P stacked
    graphs (:func:`stacked_edge_operands`, the serving backends) are
    ``(P, E_max)``: a machine with fewer edges is padded with edges whose
    ``seg`` is ``num_segments`` and whose ``emask`` and ``w_mean`` are 0,
    which every aggregate op drops, as ``jax.ops.segment_*`` drops an index
    equal to ``num_segments``.  Stacked operands carry their
    :func:`flatten_stacked` form in ``flat``, built with them.
    """

    seg: torch.Tensor         # (E,) | (P, E_max) int64 — owner row per edge
    nbr: torch.Tensor         # (E,) | (P, E_max) int64 — neighbor row
    w_mean: torch.Tensor      # f32 — 1/max(deg,1)[seg], 0 on pad edges
    emask: torch.Tensor       # f32 — 1 on every real edge, 0 on pad edges
    num_segments: int         # output row count (per graph)
    flat: Optional["EdgeCSR"] = None   # stacked: the (P·E_max,) operands


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

    layout: str               # "csr" | "bcsr_kernel"
    edges: Optional[EdgeCSR] = None
    bcsr: Optional[BCSROps] = None


def _graph_cache(graph: CSRGraph) -> dict:
    cache = graph.__dict__.get("_agg_operand_cache")
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_agg_operand_cache", cache)
    return cache


def edge_operands(graph: CSRGraph, num_segments: Optional[int] = None,
                  device="cuda") -> EdgeCSR:
    """One graph's :class:`EdgeCSR` on ``device``, built once per (row
    count, device) and cached on the graph."""
    ns = graph.num_nodes if num_segments is None else int(num_segments)
    device = torch.device(device)
    cache = _graph_cache(graph)
    key = ("edges", ns, str(device))
    ops = cache.get(key)
    if ops is not None:
        return ops
    src, dst = graph.to_edges()
    deg = np.maximum(graph.degrees(), 1).astype(np.float32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ops = EdgeCSR(seg=dev(src.astype(np.int64)), nbr=dev(dst.astype(np.int64)),
                  w_mean=dev((1.0 / deg)[src].astype(np.float32)),
                  emask=dev(np.ones(src.shape[0], np.float32)),
                  num_segments=ns)
    cache[key] = ops
    return ops


def stacked_edge_arrays(graphs: Sequence[CSRGraph], num_segments: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Host ``(seg, nbr, w_mean, emask)`` of :func:`stacked_edge_operands`,
    each ``(P, E_max)``, bit-equal to the JAX package's arrays (int32
    indices, as there)."""
    ns = int(num_segments)
    e_max = max(max(g.num_edges for g in graphs), 1)
    P = len(graphs)
    seg = np.full((P, e_max), ns, np.int32)
    nbr = np.zeros((P, e_max), np.int32)
    w = np.zeros((P, e_max), np.float32)
    em = np.zeros((P, e_max), np.float32)
    for p, g in enumerate(graphs):
        src, dst = g.to_edges()
        deg = np.maximum(g.degrees(), 1).astype(np.float32)
        e = src.shape[0]
        seg[p, :e] = src
        nbr[p, :e] = dst
        w[p, :e] = (1.0 / deg)[src]
        em[p, :e] = 1.0
    return seg, nbr, w, em


def stacked_edge_operands(graphs: Sequence[CSRGraph], num_segments: int,
                          device="cuda") -> EdgeCSR:
    """Stacked ``(P, E_max)`` edge operands for a forward over P
    partition-extended graphs of ``num_segments`` rows each (the serving
    backends).  Machines with fewer edges are padded with dropped edges
    (``seg = num_segments``, ``emask = 0``)."""
    seg, nbr, w, em = stacked_edge_arrays(graphs, num_segments)
    dev = lambda a: torch.from_numpy(a).to(device)
    stacked = EdgeCSR(seg=dev(seg.astype(np.int64)),
                      nbr=dev(nbr.astype(np.int64)), w_mean=dev(w),
                      emask=dev(em), num_segments=int(num_segments))
    return dataclasses.replace(stacked, flat=flatten_stacked(stacked))


def flatten_stacked(edges: EdgeCSR) -> EdgeCSR:
    """``(P, E_max)`` operands over P graphs of N rows → ``(P·E_max,)``
    operands over the flattened ``(P·N)`` rows.  A real edge of graph p is
    offset by ``p·N``; a pad edge goes to ``P·N`` — the flattened
    ``num_segments``, which the ops drop — never into the next graph's
    rows (``seg + p·N`` of a pad edge would be row 0 of graph p + 1)."""
    P, n = edges.seg.shape[0], edges.num_segments
    off = (torch.arange(P, device=edges.seg.device, dtype=torch.int64)
           * n)[:, None]
    seg = torch.where(edges.seg < n, edges.seg + off,
                      torch.full_like(edges.seg, P * n))
    return EdgeCSR(seg=seg.reshape(-1), nbr=(edges.nbr + off).reshape(-1),
                   w_mean=edges.w_mean.reshape(-1),
                   emask=edges.emask.reshape(-1), num_segments=P * n)


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
        return AggOperands("csr", edges=edge_operands(graph, device=device))
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
# Edge-centric primitives (csr layout)
# --------------------------------------------------------------------------
class _EdgeWeightedSum(torch.autograd.Function):
    """``out[i] = Σ_{e: seg[e]=i} w[e]·x[nbr[e]]``.  The backward is the
    transposed scatter-add over edges (the JAX package's ``_ews_bwd``):
    ``x̄[j] = Σ_{e: nbr[e]=j} w[e]·ḡ[seg[e]]``, and ``w̄`` only where it is
    asked for; the index operands get no gradient."""

    @staticmethod
    def forward(ctx, x, w, seg, nbr, num_segments):
        ctx.save_for_backward(x, w, seg, nbr)
        ctx.num_segments = num_segments
        # one sink row past the output takes the pad edges (seg ==
        # num_segments), where jax.ops.segment_sum drops them; index_add_
        # would raise on the CPU and assert on the card
        out = x.new_zeros((num_segments + 1, x.shape[1])).index_add_(
            0, seg, x.index_select(0, nbr) * w[:, None])
        return out[:num_segments]

    @staticmethod
    def backward(ctx, g):
        x, w, seg, nbr = ctx.saved_tensors
        # the sink row's cotangent is 0: a dropped edge gets no gradient
        ge = torch.cat([g, g.new_zeros((1, g.shape[1]))]).index_select(0, seg)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.zeros_like(x).index_add_(0, nbr, ge * w[:, None])
        if ctx.needs_input_grad[1]:
            gw = (ge * x.index_select(0, nbr)).sum(-1).to(w.dtype)
        return gx, gw, None, None, None


def edge_weighted_sum(h: torch.Tensor, seg: torch.Tensor, nbr: torch.Tensor,
                      w: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[i] = Σ_{e: seg[e]=i} w[e]·h[nbr[e]]`` — E·d work, no padding;
    ``w`` is taken in ``h``'s dtype."""
    return _EdgeWeightedSum.apply(h, w.to(h.dtype), seg, nbr,
                                  int(num_segments))


def csr_mean_aggregate(h: torch.Tensor, edges: EdgeCSR) -> torch.Tensor:
    """Edge-centric mean aggregation: the 1/deg normalization is folded
    into the per-edge weights."""
    return edge_weighted_sum(h, edges.seg, edges.nbr, edges.w_mean,
                             edges.num_segments)


def csr_sym_aggregate(h: torch.Tensor, edges: EdgeCSR,
                      normalizers: torch.Tensor) -> torch.Tensor:
    """Edge-centric ``Σ_j h_j · nrm_i · nrm_j`` for any runtime normalizer
    vector."""
    nrm = normalizers.to(h.dtype)
    segc = edges.seg.clamp_max(edges.num_segments - 1)
    w = (edges.emask.to(h.dtype) * nrm.index_select(0, segc)
         * nrm.index_select(0, edges.nbr))
    return edge_weighted_sum(h, edges.seg, edges.nbr, w, edges.num_segments)


def csr_gat_aggregate(z: torch.Tensor, src_score: torch.Tensor,
                      dst_score: torch.Tensor, edges: EdgeCSR,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """Edge-centric masked GAT softmax-aggregate.

    Per-edge scores, a segment-max-stabilized softmax over each node's
    real edges, then the weighted segment sum — all E-sized.  The max is a
    constant shift per segment (its gradient cancels), so it is detached;
    rows with no edge keep the −1e30 fill, so their numerators sum to 0
    and the output row is exactly 0, as on the padded path.
    """
    seg, nbr, emask, ns = edges.seg, edges.nbr, edges.emask, edges.num_segments
    segc = seg.clamp_max(ns - 1)
    e = src_score.index_select(0, segc) + dst_score.index_select(0, nbr)
    e = torch.nn.functional.leaky_relu(e, negative_slope)
    neg = -1e30
    real = emask > 0
    # segment ops over ns + 1 rows: the last is the sink of the pad edges
    # (seg == ns), sliced off, where jax.ops.segment_* drops them
    with torch.no_grad():
        m = torch.full((ns + 1,), neg, dtype=e.dtype, device=e.device)
        m = m.scatter_reduce(0, seg, torch.where(real, e, neg), "amax",
                             include_self=False)
    # a pad edge's exponent is −1e30 before the exp, so neither its value
    # nor its gradient can be inf · 0
    num = torch.exp(torch.where(real, e - m.index_select(0, seg), neg))
    den = num.new_zeros(ns + 1).index_add(0, seg, num)[:ns]
    out = z.new_zeros((ns + 1, z.shape[1])).index_add(
        0, seg, num[:, None] * z.index_select(0, nbr))[:ns]
    return out / den.clamp_min(1e-30)[:, None]


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
