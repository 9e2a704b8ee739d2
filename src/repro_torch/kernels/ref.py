"""Plain PyTorch versions of the port's kernels — the definitions of
correctness.

Each function is the obvious, untiled formulation of what its kernel
computes, on the same operand layout.  The kernel wrappers run them for
tensors that lie on the CPU (the tests), and ``chip_smoke.py`` holds every
CUDA kernel against them on the card.  They mirror the JAX package's
``kernels/ref.py`` oracles line for line.
"""
from __future__ import annotations

import torch


def spmm_bcsr_ref(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """BCSR reference: same data layout as the kernel, contracted naively.

    tile_cols: (n_row_blocks, max_tiles) int32 — column-block index per tile
               (padding tiles point at block 0 with all-zero values).
    tile_vals: (n_row_blocks, max_tiles, BM, BN) float — dense tile contents.
    h:         (n_col_blocks * BN, D).
    Returns (n_row_blocks * BM, D) float32.
    """
    n_rb, max_t, bm, bn = tile_vals.shape
    d = h.shape[-1]
    h_blocks = h.float().reshape(-1, bn, d)
    gathered = h_blocks[tile_cols.long()]             # (n_rb, max_t, BN, D)
    out = torch.einsum("rkmn,rknd->rmd", tile_vals.float(), gathered)
    return out.reshape(n_rb * bm, d)


def edge_softmax_alpha(scores: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax weights ``α (N, F)`` in f32; all-masked rows are 0.

    Masked slots score −1e30 and the denominator is clamped at 1e-30, as in
    the JAX package's Pallas kernel.
    """
    m = mask.float()
    s = torch.where(m > 0, scores.float(), torch.full_like(m, -1e30))
    s = s - s.max(dim=-1, keepdim=True).values
    e = torch.exp(s) * m
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def edge_softmax_ref(scores: torch.Tensor, mask: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_f softmax_f(scores[n])·vals[n,f] with masked slots.

    scores: (N, F); mask: (N, F) {0,1}; vals: (N, F, D).  Returns (N, D)
    float32; rows with zero mask produce zeros.
    """
    alpha = edge_softmax_alpha(scores, mask)
    return torch.einsum("nf,nfd->nd", alpha, vals.float())


def quantize_int8_rows_ref(x: torch.Tensor, u: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Wire format of the compressed communication layer.

    Each row of ``x (R, C)`` is scaled by ``scale[r] = max(|x[r]|, eps)/127``
    and rounded to int8 as ``clip(floor(x/scale + u), -127, 127)``.  With
    ``u ~ U[0,1)`` this is *stochastic* rounding — the dequantized estimate
    ``q·scale`` is unbiased, the property error-feedback averaging relies
    on.  ``u=None`` means a constant 0.5, i.e. deterministic round-half-up
    (used for halo feature compression, which needs no unbiasedness).
    Returns ``(q int8 (R, C), scale float32 (R, 1))``.
    """
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor, never by a Python number: PyTorch's CUDA division
    # by a host scalar multiplies by its reciprocal, which is not the
    # correctly rounded quotient the CUDA kernel computes
    scale = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
    uu = torch.full_like(x, 0.5) if u is None else u.float()
    q = torch.clamp(torch.floor(x / scale + uu), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_int8_rows_ref(q: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_rows_ref`: ``q·scale`` as float32."""
    return q.float() * scale.float()
