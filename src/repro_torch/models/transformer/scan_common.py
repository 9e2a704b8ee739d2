"""Chunked gated linear scan — shared by Mamba2 (SSD) and RWKV6.

Two output conventions:

* ``strict=False`` (Mamba2):  y_t = h_tᵀ q_t          (includes k_t v_tᵀ)
* ``strict=True``  (RWKV6):   y_t = h_{t−1}ᵀ r_t + (r_t·(u⊙k_t))·v_t
  (the current token enters only through the learned "bonus" u).

:func:`chunked_scan` keeps the JAX package's signature and passes on to
:func:`repro_torch.kernels.ops.linear_scan`, which picks the route by device
(the CUDA kernel, or the plain chunked form on the CPU).
:func:`scan_decode_step` is the one-token recurrence, plain tensor math as
in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def chunked_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_w: torch.Tensor, h0: Optional[torch.Tensor] = None,
                 chunk: int = 64, strict: bool = False,
                 u: Optional[torch.Tensor] = None,
                 use_pallas: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k,log_w: (BH, T, dk); v: (BH, T, dv); u: (BH, dk) bonus (strict
    only).  Returns (y (BH,T,dv) f32, h_T (BH,dk,dv) f32).

    The scalar-decay route: ``log_w`` of shape (BH, T), one decay per step
    and batch·head (Mamba2's, not broadcast over dk), takes the scan's
    segsum form, finite where the JAX package's factored form overflows
    (ROADMAP.md Queue 3) and equal to it wherever that is finite.

    ``use_pallas`` is kept for the JAX signature and ignored: the route
    follows the tensors' device.
    """
    return ops.linear_scan(q, k, v, log_w, h0, chunk=chunk, strict=strict,
                           u=u)


def scan_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, h: torch.Tensor,
                     strict: bool = False, u: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  q,k,log_w: (BH, dk); v: (BH, dv);
    h: (BH, dk, dv).  Returns (y (BH, dv), h')."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    if strict:
        y = torch.einsum("bd,bdv->bv", q32, h)
        if u is not None:
            y = y + torch.einsum("bd,bd->b", q32, u * k32)[:, None] * v32
        h = w[:, :, None] * h + k32[:, :, None] * v32[:, None, :]
    else:
        h = w[:, :, None] * h + k32[:, :, None] * v32[:, None, :]
        y = torch.einsum("bd,bdv->bv", q32, h)
    return y, h
