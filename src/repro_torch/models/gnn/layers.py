"""The paper's GNN operator set (Appendix A.2) as functions over tensors.

Every layer works on a *stack* of B graphs of equal padded size, which is
how the port writes out the JAX package's ``vmap`` over machines:

  ``h``      — (B, N, d) node embeddings for all nodes of each graph,
  ``table``  — (B, N, fanout) int32 neighbor ids local to each graph,
  ``mask``   — (B, N, fanout) float {0,1} validity,

and each param leaf carries the same leading B axis (one parameter set per
machine).  The mean aggregation of Eq. 1/3/4 is then one dense gather over
the flattened ``(B·N, d)`` rows + a masked mean.  A single graph is the
B = 1 stack (:meth:`repro_torch.models.gnn.model.GNNModel.apply`).

Aggregate ops also accept prebuilt :class:`repro_torch.models.gnn.agg.
AggOperands` (``agg=``): ``csr`` replaces the ``N·fanout·d`` dense gather
with an ``E·d`` edge-centric segment sum, over one graph (``(E,)``
operands, B = 1) or over B stacked graphs (``(B, E_max)`` operands from
:func:`~repro_torch.models.gnn.agg.stacked_edge_operands`, whose pad edges
are dropped); ``bcsr_kernel`` (one graph) routes the mean aggregation
through the BCSR SpMM kernel and the GAT softmax-aggregate through the
fused edge-softmax kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.gnn.agg import (
    AggOperands, EdgeCSR, bcsr_mean_aggregate, bcsr_sym_aggregate,
    csr_gat_aggregate, csr_mean_aggregate, csr_sym_aggregate,
    flatten_stacked,
)


def _flat_index(table: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N, F) per-graph ids → int64 ids into the flattened (B·N) rows."""
    b = table.shape[0]
    offs = torch.arange(b, device=table.device, dtype=torch.int64) * n
    return table.long() + offs[:, None, None]


def _gather(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``x[b][table[b]]`` for every graph b: (B, N, …) → (B, N, F, …).

    An ``index_select``, whose backward (``index_add_``) sums in a fixed
    order on the CPU; the advanced-indexing backward does not, and runs of
    the same plan would differ in the last bits.
    """
    b, n = x.shape[:2]
    idx = _flat_index(table, n)
    rows = x.reshape(b * n, *x.shape[2:]).index_select(0, idx.reshape(-1))
    return rows.reshape(*idx.shape, *x.shape[2:])


def _single_graph(h: torch.Tensor) -> None:
    if h.shape[0] != 1:
        raise ValueError(f"aggregation operands describe one graph; got a "
                         f"stack of {h.shape[0]}")


def _csr_edges(h: torch.Tensor, edges: EdgeCSR) -> EdgeCSR:
    """The edge operands over ``h``'s flattened ``(B·N)`` rows: one graph's
    as they are (B = 1), B stacked graphs' flattened."""
    b, n = h.shape[:2]
    if edges.seg.dim() == 1:
        _single_graph(h)
        return edges
    if edges.seg.shape[0] != b or edges.num_segments != n:
        raise ValueError(f"stacked edge operands for {edges.seg.shape[0]} "
                         f"graphs of {edges.num_segments} rows; got {b} of "
                         f"{n}")
    return edges.flat if edges.flat is not None else flatten_stacked(edges)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, N, …) → (B·N, …)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _bias(out: torch.Tensor, params: Dict) -> torch.Tensor:
    return out + params["b"][:, None, :] if "b" in params else out


def mean_aggregate(h: torch.Tensor, table: torch.Tensor, mask: torch.Tensor,
                   agg: Optional[AggOperands] = None) -> torch.Tensor:
    """(1/|Ñ(v)|) Σ_{j∈Ñ(v)} h_j — the paper's mean aggregation."""
    if agg is not None:
        if agg.layout == "csr":
            return csr_mean_aggregate(
                _rows(h), _csr_edges(h, agg.edges)).reshape(h.shape)
        _single_graph(h)
        if agg.layout == "bcsr_kernel":
            return bcsr_mean_aggregate(h[0], agg.bcsr)[None]
        raise ValueError(f"unsupported aggregation layout {agg.layout!r}")
    s = torch.einsum("bnfd,bnf->bnd", _gather(h, table), mask)
    return s / mask.sum(-1, keepdim=True).clamp_min(1.0)


def sym_aggregate(h: torch.Tensor, table: torch.Tensor, mask: torch.Tensor,
                  normalizers: torch.Tensor,
                  agg: Optional[AggOperands] = None) -> torch.Tensor:
    """Σ_j h_j / sqrt(deg_i · deg_j) — GCN symmetric-Laplacian aggregation;
    ``normalizers`` is (B, N), one vector per graph."""
    if agg is not None:
        if agg.layout == "csr":
            return csr_sym_aggregate(_rows(h), _csr_edges(h, agg.edges),
                                     normalizers.reshape(-1)
                                     ).reshape(h.shape)
        _single_graph(h)
        if agg.layout == "bcsr_kernel":
            return bcsr_sym_aggregate(h[0], agg.bcsr, normalizers[0])[None]
        raise ValueError(f"unsupported aggregation layout {agg.layout!r}")
    coef = mask * _gather(normalizers, table) * normalizers[..., None]
    return torch.einsum("bnfd,bnf->bnd", _gather(h, table), coef)


def gcn_layer(params: Dict, h: torch.Tensor, table: torch.Tensor,
              mask: torch.Tensor, activation=F.relu,
              agg: Optional[AggOperands] = None) -> torch.Tensor:
    """Eq. 1: σ(mean_{j∈N(v)}(h_j) W)."""
    out = _bias(mean_aggregate(h, table, mask, agg=agg) @ params["w"], params)
    return activation(out) if activation is not None else out


def sage_layer(params: Dict, h: torch.Tensor, table: torch.Tensor,
               mask: torch.Tensor, activation=F.relu,
               agg: Optional[AggOperands] = None) -> torch.Tensor:
    """Eq. 7: σ(h W1 + mean_nbr(h) W2)."""
    a = mean_aggregate(h, table, mask, agg=agg)
    out = _bias(h @ params["w_self"] + a @ params["w_nbr"], params)
    return activation(out) if activation is not None else out


def gat_layer(params: Dict, h: torch.Tensor, table: torch.Tensor,
              mask: torch.Tensor, activation=F.elu,
              negative_slope: float = 0.2, fused: bool = False,
              agg: Optional[AggOperands] = None) -> torch.Tensor:
    """Eq. 10/11: masked edge softmax over the padded neighbor slots.

    ``fused=True`` — or ``agg`` with the ``bcsr_kernel`` layout — routes the
    softmax-aggregate through the edge-softmax kernel with its analytic
    backward; the (B·N, F) rows of every graph go to one launch.  The
    ``csr`` layout computes per-edge scores and an edge-centric segment
    softmax instead of the padded (N, fanout) slots.
    """
    if agg is not None and agg.layout not in ("csr", "bcsr_kernel"):
        raise ValueError(f"unsupported aggregation layout {agg.layout!r}")
    z = h @ params["w"]                                   # (B, N, d')
    src_score = torch.einsum("bnd,bd->bn", z, params["a_src"])
    dst_score = torch.einsum("bnd,bd->bn", z, params["a_dst"])
    if agg is not None and agg.layout == "csr":
        out = csr_gat_aggregate(_rows(z), src_score.reshape(-1),
                                dst_score.reshape(-1),
                                _csr_edges(h, agg.edges),
                                negative_slope).reshape(z.shape)
    else:
        e = src_score[:, :, None] + _gather(dst_score, table)  # (B, N, F)
        e = F.leaky_relu(e, negative_slope)
        zt = _gather(z, table)                            # (B, N, F, d')
        if fused or agg is not None:
            from repro_torch.kernels.ops import (
                edge_softmax_aggregate_trainable)
            b, n, f = e.shape
            out = edge_softmax_aggregate_trainable(
                e.reshape(b * n, f), mask.reshape(b * n, f),
                zt.reshape(b * n, f, -1)).reshape(b, n, -1)
        else:
            e = torch.where(mask > 0, e, torch.full_like(e, -1e30))
            alpha = torch.softmax(e, dim=-1) * mask      # all-pad rows → 0
            out = torch.einsum("bnf,bnfd->bnd", alpha, zt)
    out = _bias(out, params)
    return activation(out) if activation is not None else out


def linear_layer(params: Dict, h: torch.Tensor, *_, activation=None,
                 **__) -> torch.Tensor:
    """Eq. 8: graph-agnostic h W (the paper's 'L' op / the MLP ablation)."""
    out = _bias(h @ params["w"], params)
    return activation(out) if activation is not None else out


def batch_norm(params: Dict, h: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """Eq. 9 over each graph's node axis, with batch statistics (training
    mode) and the population variance, as the JAX package computes it."""
    mean = h.mean(dim=1, keepdim=True)
    var = h.var(dim=1, keepdim=True, correction=0)
    hhat = (h - mean) / torch.sqrt(var + eps)
    return hhat * params["gamma"][:, None, :] + params["beta"][:, None, :]


def appnp_propagate(h0: torch.Tensor, table: torch.Tensor, mask: torch.Tensor,
                    num_steps: int, beta: float,
                    agg: Optional[AggOperands] = None) -> torch.Tensor:
    """Eq. 12: h ← β h0 + (1−β) Â h, iterated ``num_steps`` times."""
    h = h0
    for _ in range(num_steps):
        h = beta * h0 + (1.0 - beta) * mean_aggregate(h, table, mask, agg=agg)
    return h
