"""Row-wise int8 quantize / dequantize — the wire format of the compressed
communication layer — as hand-written CUDA kernels for Hopper.

Replaces the JAX package's Pallas TPU kernels ``quantize_rows`` and
``dequantize_rows`` (``src/repro/kernels/quantize.py``).  Each row of an f32
buffer travels as one f32 scale (``max(|row|, 1e-12)/127``) plus its values
rounded to int8 as ``clip(floor(x/scale + u), -127, 127)``; ``u`` holds the
caller's uniforms (stochastic rounding) or is ``None`` for a constant 0.5
(round-half-up).  Dequantize is ``q·scale``.

The kernels (``csrc/quantize_rows.cu``) run one CTA per row for quantize and
a (row, column chunk) grid for dequantize; both divisions are correctly rounded
(``__fdiv_rn``), so on the card ``q``, ``scale`` and the dequantized values
are bit-equal to the plain versions in :mod:`repro_torch.kernels.ref`.  On a
CPU tensor the wrappers run those plain versions; on a CUDA tensor they
launch the kernel or raise.  Each wrapper counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (dequantize_int8_rows_ref,
                                     quantize_int8_rows_ref)

#: Pointer operands of each C entry; every entry then takes (R, C, stream).
_POINTERS = {"quantize_rows_f32": 4, "dequantize_rows_f32": 3}
_ENTRIES = {}


def _kernel(name: str):
    """A ctypes entry of ``csrc/quantize_rows.cu``, built at first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(build.load("quantize_rows"), name)
        fn.argtypes = [ctypes.c_void_p] * _POINTERS[name] + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands must share a device")


def quantize_rows(x: torch.Tensor, u: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 (R, C), scale f32 (R, 1))`` ← ``x (R, C)``, ``u (R, C)``
    uniforms in [0, 1) or ``None`` (round-half-up).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    counted in ``quantize_rows.launches``.
    """
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"x must be (rows, C>0), got {tuple(x.shape)}")
    if u is not None and u.shape != x.shape:
        raise ValueError(f"u {tuple(u.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_rows_ref(x, u)
    _check_cuda("quantize_rows", x, *([] if u is None else [u]))
    if x.dtype != torch.float32 or (u is not None
                                    and u.dtype != torch.float32):
        raise ValueError("quantize_rows takes float32 x and u, got "
                         f"{x.dtype}/{None if u is None else u.dtype}")
    r, c = x.shape
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    if r == 0:
        return q, scale
    x = x.contiguous()
    u = None if u is None else u.contiguous()
    _launch("quantize_rows_f32", x.device, x.data_ptr(),
            None if u is None else u.data_ptr(), q.data_ptr(),
            scale.data_ptr(), r, c)
    quantize_rows.launches += 1
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q·scale`` as f32 ``(R, C)`` ← ``q int8 (R, C)``, ``scale (R, 1)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    counted in ``dequantize_rows.launches``.
    """
    if q.dim() != 2 or scale.shape != (q.shape[0], 1):
        raise ValueError(f"q must be (R, C) and scale (R, 1), got "
                         f"{tuple(q.shape)} and {tuple(scale.shape)}")
    if q.device.type == "cpu":
        return dequantize_int8_rows_ref(q, scale)
    _check_cuda("dequantize_rows", q, scale)
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("dequantize_rows takes int8 q and float32 scale, "
                         f"got {q.dtype}/{scale.dtype}")
    r, c = q.shape
    out = torch.empty((r, c), dtype=torch.float32, device=q.device)
    if r == 0 or c == 0:
        return out
    q, scale = q.contiguous(), scale.contiguous()
    _launch("dequantize_rows_f32", q.device, q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), r, c)
    dequantize_rows.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU path never counts).
quantize_rows.launches = 0
dequantize_rows.launches = 0
