"""Fused masked edge-softmax aggregation (the GAT hotspot) as a hand-written
CUDA kernel for Hopper.

Replaces the JAX package's Pallas TPU kernel ``edge_softmax``
(``src/repro/kernels/edge_softmax.py``, ``_edge_softmax_kernel``):

    out[n] = Σ_f softmax_f(scores[n, ·]) · vals[n, f, :]

over the padded neighbor slots, with masked slots scored −1e30, the
denominator clamped at 1e-30 and fully masked rows giving 0.  Left to
separate ops this writes the (N, F) weights and reads the gathered
(N, F, D) values back; fused, the weights stay in registers.

The kernel (``csrc/edge_softmax.cu``) gives each row a warp: lane j reads
the scores and mask of slots j and j + 32 once, the max and the sum reduce
by shuffles, each slot's weight is computed once, and the warp covers the
row's (slot, column) pairs with 16-byte loads of ``vals`` (2 lanes per slot
at D 8, 16 at D 64), all of them issued before the first is consumed.  The
per-lane sums combine in a fixed order, so the card repeats itself.  All
math is f32, on f32 operands.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.edge_softmax_ref`); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import edge_softmax_ref

_ENTRY = []


def _kernel():
    """The ctypes entry of ``csrc/edge_softmax.cu``, built at first use."""
    if not _ENTRY:
        fn = build.load("edge_softmax").edge_softmax_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def edge_softmax(scores: torch.Tensor, mask: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_f softmax_f(scores[n,·])·vals[n,f,:], masked; (N, D) f32.

    scores/mask: (N, F) f32; vals: (N, F, D) f32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel, counted in
    ``edge_softmax.launches``.
    """
    if scores.dim() != 2 or mask.shape != scores.shape or vals.dim() != 3 \
            or vals.shape[:2] != scores.shape:
        raise ValueError(f"edge_softmax takes scores/mask (N, F) and vals "
                         f"(N, F, D); got {tuple(scores.shape)}, "
                         f"{tuple(mask.shape)}, {tuple(vals.shape)}")
    if scores.dtype is not torch.float32 or mask.dtype is not torch.float32 \
            or vals.dtype is not torch.float32:
        raise ValueError(f"edge_softmax takes float32 scores, mask and vals, "
                         f"got {scores.dtype}/{mask.dtype}/{vals.dtype}")
    # get_device(): the CUDA index, -1 on the CPU (cheaper than .device)
    dev = vals.get_device()
    if scores.get_device() != dev or mask.get_device() != dev:
        raise ValueError("scores, mask and vals must share a device")
    if not vals.is_cuda:
        if vals.device.type != "cpu":
            raise ValueError(f"edge_softmax runs on cpu or cuda, not "
                             f"{vals.device}")
        return edge_softmax_ref(scores, mask, vals)
    if not (scores.is_contiguous() and mask.is_contiguous()
            and vals.is_contiguous()):
        scores, mask, vals = (x.contiguous() for x in (scores, mask, vals))
    n, f, d = vals.shape
    out = vals.new_empty((n, d))
    if n == 0 or d == 0:
        return out
    v_ptr = vals.data_ptr()
    err = build.launch_on(dev, _kernel(), scores.data_ptr(), mask.data_ptr(),
                          v_ptr, out.data_ptr(), n, f, d,
                          int(d % 4 == 0 and v_ptr % 16 == 0))
    if err != 0:
        raise RuntimeError(f"edge_softmax kernel launch failed "
                           f"(cudaError {err})")
    edge_softmax.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU path never counts).
edge_softmax.launches = 0
