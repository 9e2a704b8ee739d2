"""Public wrappers around the port's kernels: operand caching and
gradients.

Every op takes natural-layout tensors and dispatches on the tensors'
device: CUDA tensors go to the hand-written kernels (each counts its own
launches), CPU tensors to the plain versions in :mod:`repro_torch.kernels.
ref`.  That device split plays the role of the JAX package's Pallas
interpret mode.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.edge_softmax import edge_softmax
from repro_torch.kernels.linear_scan import (is_traced, linear_scan_chunked,
                                            linear_scan_chunked_bwd)
from repro_torch.kernels.quantize import (dequantize_rows,
                                         dequantize_rows_many, quantize_rows)
from repro_torch.kernels.ref import edge_softmax_alpha
from repro_torch.kernels.spmm import build_csr, row_split, spmm_csr


# --------------------------------------------------------------------------
# SpMM aggregation
# --------------------------------------------------------------------------
def csr_device_operands(graph: CSRGraph, device,
                        normalization: str = "mean"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """Device-resident ``(indptr, indices, values, items)`` of Â — the CSR
    operands of :func:`~repro_torch.kernels.spmm.spmm_csr` and its row
    split (``None`` when no row is long) — built once per (graph, device,
    normalization) and cached on the graph object, so repeated aggregate
    calls never re-pay the host-side build or the copy to the device."""
    cache = graph.__dict__.get("_csr_cache")
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_csr_cache", cache)  # frozen dataclass
    device = torch.device(device)
    key = (str(device), normalization)
    entry = cache.get(key)
    if entry is None:
        indptr, indices, values = build_csr(graph, normalization)
        items = row_split(indptr)
        entry = tuple(None if x is None else torch.from_numpy(x).to(device)
                      for x in (indptr, indices, values, items))
        cache[key] = entry
    return entry


def spmm_aggregate(graph: CSRGraph, h: torch.Tensor,
                   normalization: str = "mean") -> torch.Tensor:
    """Full-graph Â @ H via the CSR kernel.  Returns (N, D) in h's dtype."""
    indptr, indices, values, items = csr_device_operands(
        graph, h.device, normalization=normalization)
    return spmm_csr(indptr, indices, values, h.float(), items).to(h.dtype)


# --------------------------------------------------------------------------
# GAT fused edge softmax
# --------------------------------------------------------------------------
class _EdgeSoftmaxAggregate(torch.autograd.Function):
    """Kernel forward, analytic backward.

    With ``α = softmax over the masked slots`` and ``gv[n,f] = g[n]·v[n,f]``
    the VJP of ``out = Σ_f α v`` is ``dv = α ⊗ g`` and ``ds = α ⊙ (gv −
    Σ_f α gv)`` — the same cotangents as the JAX package's oracle VJP
    (masked slots and fully masked rows get zero, as there), written as
    explicit torch ops.  The mask gets no gradient.

    As in the JAX op, the kernel computes in f32 on f32 copies of the
    operands (a no-op for f32 ones), the output comes back in
    ``vals.dtype`` and each cotangent in its primal's dtype.
    """

    @staticmethod
    def forward(ctx, scores, mask, vals):
        scores32, mask32, vals32 = scores.float(), mask.float(), vals.float()
        ctx.save_for_backward(scores32, mask32, vals32)
        ctx.dtypes = (scores.dtype, vals.dtype)
        return edge_softmax(scores32, mask32, vals32).to(vals.dtype)

    @staticmethod
    def backward(ctx, g):
        scores, mask, vals = ctx.saved_tensors
        scores_dtype, vals_dtype = ctx.dtypes
        alpha = edge_softmax_alpha(scores, mask)              # (N, F) f32
        g = g.float()
        gv = torch.einsum("nfd,nd->nf", vals, g)
        ds = alpha * (gv - (alpha * gv).sum(dim=-1, keepdim=True))
        dv = alpha[:, :, None] * g[:, None, :]
        return ds.to(scores_dtype), None, dv.to(vals_dtype)


def edge_softmax_aggregate_trainable(scores: torch.Tensor, mask: torch.Tensor,
                                     vals: torch.Tensor) -> torch.Tensor:
    """Differentiable fused edge-softmax: kernel forward, analytic backward.
    Used by the GAT layer when ``fused_gat=True``."""
    return _EdgeSoftmaxAggregate.apply(scores, mask, vals)


# --------------------------------------------------------------------------
# Row-wise int8 quantize/dequantize (compressed communication wire format)
# --------------------------------------------------------------------------
def quantize_int8_rows(x: torch.Tensor, u: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric int8 quantization with stochastic rounding.

    x: (R, C) float; u: (R, C) uniforms in [0, 1) (None → deterministic
    round-half-up).  Returns ``(q int8 (R, C), scale f32 (R, 1))`` — the
    compressed-communication wire format (1 byte/value + 4 bytes/row).
    The kernel takes any row count, so unlike the Pallas one it needs no
    block padding.
    """
    return quantize_rows(x.float(), None if u is None else u.float())


def dequantize_int8_rows(vals: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_rows`: f32 (R, C) ← q·scale."""
    return dequantize_rows(vals, scale.float())


def dequantize_int8_rows_many(vals: List[torch.Tensor],
                              scales: List[torch.Tensor]
                              ) -> List[torch.Tensor]:
    """:func:`dequantize_int8_rows` of each ``(vals[i] (R, …), scales[i]
    (R, 1))``, in ``vals[i]``'s shape, all in one kernel launch on the card
    (up to 32 pairs a launch)."""
    return dequantize_rows_many(
        vals, [s if s.dtype is torch.float32 else s.float() for s in scales])


# --------------------------------------------------------------------------
# Gated linear scan (Mamba2 / RWKV6)
# --------------------------------------------------------------------------
class _LinearScan(torch.autograd.Function):
    """The scan with a hand-written gradient, in all three modes (strict
    with ``u``, plain per-key, scalar decay).

    On the card the forward kernel also writes the chunk-start states,
    saved with h_T for the gradient's kernel, which walks the chunks in
    reverse from them; on the CPU the backward recomputes the plain
    version under autograd.  Either way one backward call per forward
    (:func:`~repro_torch.kernels.linear_scan.linear_scan_chunked_bwd`).
    An unused h_T passes no cotangent.
    """

    @staticmethod
    def forward(ctx, q, k, v, log_w, h0, u, chunk, strict):
        ctx.set_materialize_grads(False)
        # the kernel saves its chunk-start states (and so does the dry
        # run's stand-in on fake tensors); the plain version recomputes
        saved = q.device.type == "cuda" or is_traced(q)
        out = linear_scan_chunked(q, k, v, log_w, h0, u=u, chunk=chunk,
                                  strict=strict, ragged=True,
                                  save_states=saved)
        y, h_t = out[:2]
        ctx.save_for_backward(q, k, v, log_w, h0, u,
                              out[2] if saved else None, h_t)
        ctx.chunk, ctx.strict = chunk, strict
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        q, k, v, log_w, h0, u, h_in, h_t = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros((*q.shape[:2], v.shape[-1]), dtype=torch.float32,
                             device=q.device)
        grads = linear_scan_chunked_bwd(q, k, v, log_w, h0, u, h_in, h_t,
                                        dy.float(), None if dh_t is None
                                        else dh_t.float(), chunk=ctx.chunk,
                                        strict=ctx.strict)
        return (*grads, None, None)


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, h0: Optional[torch.Tensor] = None,
                chunk: int = 64, strict: bool = False,
                u: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched gated linear recurrence.

    q,k: (BH, T, dk); v: (BH, T, dv); log_w: (BH, T, dk), or (BH, T) for a
    decay that is one value per step and batch·head (Mamba2's), which runs
    the scan's scalar-decay mode: the segsum form, finite however strong
    the decay.  ``strict``/``u`` select the RWKV6 output convention (y_t
    reads h_{t−1} + u-bonus).  Returns (y (BH,T,dv) f32, h_T (BH,dk,dv)
    f32).

    A T that is not a multiple of ``chunk`` runs as is: the kernel masks
    the last chunk; the plain version on the CPU takes it zero-padded
    (q = k = v = 0, log_w = 0: decay 1 and no input, so ``h_T`` is
    unchanged) and ``y`` cut back to T — where the JAX op leaves its kernel
    for the oracle.

    Where autograd records (an operand requires grad), the call goes
    through :class:`_LinearScan`, whose backward is the hand-written
    gradient kernel on the card; otherwise (serving) the forward kernel
    runs alone and saves nothing.
    """
    args = (q.float(), k.float(), v.float(), log_w.float(),
            None if h0 is None else h0.float(),
            None if u is None or not strict else u.float())
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in args):
        return _LinearScan.apply(*args, chunk, strict)
    return linear_scan_chunked(*args[:5], u=args[5], chunk=chunk,
                               strict=strict, ragged=True)
