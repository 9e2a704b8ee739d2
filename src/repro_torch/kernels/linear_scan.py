"""Chunked gated linear scan — the RWKV6 / Mamba2 compute core — as a
hand-written CUDA kernel for Hopper.

Replaces the JAX package's Pallas TPU kernel ``linear_scan_chunked``
(``src/repro/kernels/linear_scan.py``), in both of its conventions
(``strict=True`` for RWKV6, ``False`` for Mamba2).  The kernel
(``csrc/linear_scan.cu``) runs one CTA per batch·head and walks its chunks
in order with the ``(dk, dv)`` state in shared memory; the plain version is
:func:`repro_torch.kernels.ref.chunked_scan_ref`.  On a CPU tensor the
wrapper runs that plain version; on a CUDA tensor it launches the kernel or
raises, and counts the launch in ``linear_scan_chunked.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import chunked_scan_ref

#: chunk, dk and dv limit of the kernel's shared-memory tiles
MAX_DIM = 64

_ENTRY = []


def _kernel():
    """The ctypes entry of ``csrc/linear_scan.cu``, built at first use."""
    if not _ENTRY:
        fn = build.load("linear_scan").linear_scan_chunked_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def linear_scan_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_w: torch.Tensor,
                        h0: Optional[torch.Tensor] = None,
                        u: Optional[torch.Tensor] = None, chunk: int = 64,
                        strict: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched chunked scan.

    q,k,log_w: (BH, T, dk); v: (BH, T, dv); h0: (BH, dk, dv) or None
    (zeros); u: (BH, dk) strict-mode bonus or None; ``T % chunk == 0``.
    Returns (y (BH,T,dv) f32, h_T (BH,dk,dv) f32).
    """
    if q.dim() != 3 or k.shape != q.shape or log_w.shape != q.shape \
            or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"q, k, log_w must be (BH, T, dk) and v (BH, T, dv)"
                         f", got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(log_w.shape)}, {tuple(v.shape)}")
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if h0 is not None and h0.shape != (bh, dk, dv):
        raise ValueError(f"h0 must be {(bh, dk, dv)}, got {tuple(h0.shape)}")
    if u is not None and u.shape != (bh, dk):
        raise ValueError(f"u must be {(bh, dk)}, got {tuple(u.shape)}")
    if not 1 <= chunk <= MAX_DIM or t % chunk:
        raise ValueError(f"chunk must be in [1, {MAX_DIM}] and divide "
                         f"T={t}, got {chunk}")
    if q.device.type == "cpu":
        return chunked_scan_ref(q, k, v, log_w, h0, chunk=chunk,
                                strict=strict, u=u)
    ops = [x for x in (q, k, v, log_w, h0, u) if x is not None]
    if q.device.type != "cuda" or any(x.device != q.device for x in ops):
        raise ValueError(f"linear_scan_chunked runs on cpu or cuda, with "
                         f"every operand on one device; got "
                         f"{[str(x.device) for x in ops]}")
    if any(x.dtype != torch.float32 for x in ops):
        raise ValueError("linear_scan_chunked takes float32 operands, got "
                         f"{[x.dtype for x in ops]}")
    if dk > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"the kernel takes dk, dv <= {MAX_DIM}, got "
                         f"{dk}, {dv}")
    q, k, v, log_w = (x.contiguous() for x in (q, k, v, log_w))
    h0 = None if h0 is None else h0.contiguous()
    u = None if u is None or not strict else u.contiguous()
    y = torch.empty((bh, t, dv), dtype=torch.float32, device=q.device)
    h_t = torch.empty((bh, dk, dv), dtype=torch.float32, device=q.device)
    if bh == 0:
        return y, h_t
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_w.data_ptr(), ptr(h0), ptr(u), y.data_ptr(),
                        h_t.data_ptr(), bh, t, dk, dv, chunk, int(strict),
                        stream)
    if err != 0:
        raise RuntimeError(f"linear_scan_chunked kernel launch failed "
                           f"(cudaError {err})")
    linear_scan_chunked.launches += 1
    return y, h_t


#: Kernel launches since the last reset (the plain CPU path never counts).
linear_scan_chunked.launches = 0
