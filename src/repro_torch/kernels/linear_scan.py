"""Chunked gated linear scan — the RWKV6 / Mamba2 compute core — as a
hand-written CUDA kernel for Hopper.

Replaces the JAX package's Pallas TPU kernel ``linear_scan_chunked``
(``src/repro/kernels/linear_scan.py``), in both of its conventions
(``strict=True`` for RWKV6, ``False`` for Mamba2), and adds a scalar-decay
mode of the plain convention for Mamba2, whose decay is one value per step
and head: ``log_w`` of shape (BH, T), computed in the segsum form with
every exponent ≤ 0, where the reference's factored form overflows f32.
The kernel (``csrc/linear_scan.cu``) runs two CTAs per batch·head, each
owning 32 dv columns of the state in shared memory, and walks the chunks in
order, loading the next chunk's tiles while the current one computes; a
ragged T is masked inside the kernel.  The plain versions are
:func:`repro_torch.kernels.ref.chunked_scan_ref` and, for the scalar
decay, :func:`~repro_torch.kernels.ref.chunked_scan_scalar_ref`, which take
whole chunks: on a CPU tensor the wrapper pads a ragged T for them.  On a
CUDA tensor the wrapper launches the kernel or raises, and counts the
launch in ``linear_scan_chunked.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import chunked_scan_ref, chunked_scan_scalar_ref

#: chunk, dk and dv limit of the kernel's shared-memory tiles
MAX_DIM = 64

_ENTRY = []


def _kernel():
    """The ctypes entry of ``csrc/linear_scan.cu``, built at first use."""
    if not _ENTRY:
        lib = build.load("linear_scan")
        fn = lib.linear_scan_chunked_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.linear_scan_ctas_per_sm
        occ.argtypes = [ctypes.c_int]
        occ.restype = ctypes.c_int
        _ENTRY.extend((fn, occ))
    return _ENTRY[0]


def ctas_per_sm(strict: bool, scalar_decay: bool = False) -> int:
    """CTAs of the kernel that fit on one SM of the current device at
    once (the occupancy its shared memory and registers allow), in the
    strict, the plain or the plain scalar-decay mode."""
    _kernel()
    n = _ENTRY[1](2 if scalar_decay else int(strict))
    if n < 0:
        raise RuntimeError(f"linear_scan occupancy query failed "
                           f"(cudaError {-n})")
    return n


def linear_scan_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_w: torch.Tensor,
                        h0: Optional[torch.Tensor] = None,
                        u: Optional[torch.Tensor] = None, chunk: int = 64,
                        strict: bool = False, ragged: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched chunked scan.

    q,k: (BH, T, dk); v: (BH, T, dv); log_w: (BH, T, dk), or (BH, T) for
    the scalar-decay mode (one decay per step and batch·head; the plain
    convention only); h0: (BH, dk, dv) or None (zeros); u: (BH, dk)
    strict-mode bonus or None.  ``T % chunk == 0`` unless ``ragged``: then
    the last chunk's missing steps count as zero inputs with decay 1
    (``h_T`` unchanged by them), masked in the kernel and padded for the
    plain version.  Returns (y (BH,T,dv) f32, h_T (BH,dk,dv) f32).
    """
    scalar = log_w.dim() == 2
    if q.dim() != 3 or k.shape != q.shape \
            or log_w.shape not in (q.shape, q.shape[:2]) \
            or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"q, k must be (BH, T, dk), log_w (BH, T, dk) or "
                         f"(BH, T) and v (BH, T, dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(log_w.shape)}, "
                         f"{tuple(v.shape)}")
    if scalar and strict:
        raise ValueError("the scalar decay (log_w of shape (BH, T)) takes "
                         "the plain convention, not strict")
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if h0 is not None and h0.shape != (bh, dk, dv):
        raise ValueError(f"h0 must be {(bh, dk, dv)}, got {tuple(h0.shape)}")
    if u is not None and u.shape != (bh, dk):
        raise ValueError(f"u must be {(bh, dk)}, got {tuple(u.shape)}")
    if not 1 <= chunk <= MAX_DIM or (t % chunk and not ragged):
        raise ValueError(f"chunk must be in [1, {MAX_DIM}] and divide "
                         f"T={t}, got {chunk}")
    if q.device.type == "cpu":
        pad = -t % chunk
        if pad:                   # q = k = v = 0, log_w = 0: no input, decay 1
            q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                       for x in (q, k, v))
            log_w = torch.nn.functional.pad(
                log_w, (0, pad) if scalar else (0, 0, 0, pad))
        if scalar:
            y, h_t = chunked_scan_scalar_ref(q, k, v, log_w, h0, chunk=chunk)
        else:
            y, h_t = chunked_scan_ref(q, k, v, log_w, h0, chunk=chunk,
                                      strict=strict, u=u)
        return y[:, :t], h_t
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
    err = build.launch_on(q.get_device(), _kernel(), q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                          ptr(h0), ptr(u), y.data_ptr(), h_t.data_ptr(), bh,
                          t, dk, dv, chunk, int(strict), int(scalar))
    if err != 0:
        raise RuntimeError(f"linear_scan_chunked kernel launch failed "
                           f"(cudaError {err})")
    linear_scan_chunked.launches += 1
    return y, h_t


#: Kernel launches since the last reset (the plain CPU path never counts).
linear_scan_chunked.launches = 0
