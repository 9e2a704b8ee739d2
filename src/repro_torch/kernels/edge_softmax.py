"""Fused masked edge-softmax aggregation (the GAT hotspot) as a Triton kernel.

Replaces the JAX package's Pallas TPU kernel ``edge_softmax``
(``src/repro/kernels/edge_softmax.py``, ``_edge_softmax_kernel``):

    out[n] = Σ_f softmax_f(scores[n, ·]) · vals[n, f, :]

over the padded neighbor slots, with masked slots scored −1e30, the
denominator clamped at 1e-30 and fully masked rows giving 0.  Left to
separate ops this writes the (N, F) weights and reads the gathered
(N, F, D) values back; fused, the weights stay in registers.

Design.  One program owns a block of rows and a slab of D.  It loads the
block's (BLOCK_N, F) scores and mask once for the row max and the clamped
denominator, then walks the F neighbor slots, forming each slot's weight
and accumulating ``α·v`` into a (BLOCK_N, BLOCK_D) f32 register tile.  All
math is f32; the output takes ``vals``' dtype.  The kernel reads every
score, mask and value once and does about 2·D flops per value, so it is
bound by memory traffic.

``triton`` is imported inside the launcher: the module imports on hosts
without it, where CPU tensors take the plain version
(:func:`repro_torch.kernels.ref.edge_softmax_ref`).  A CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import edge_softmax_ref

BLOCK_N = 32
_JIT = None


def _edge_softmax_kernel(s_ptr, m_ptr, v_ptr, out_ptr, N, F, D,
                         BLOCK_N: tl.constexpr, BLOCK_F: tl.constexpr,
                         BLOCK_D: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
    row_ok = rows < N
    rows = rows.to(tl.int64)
    fs = tl.arange(0, BLOCK_F)
    sm_off = rows[:, None] * F + fs[None, :]
    sm_ok = row_ok[:, None] & (fs[None, :] < F)
    m = tl.load(m_ptr + sm_off, mask=sm_ok, other=0.0).to(tl.float32)
    s = tl.load(s_ptr + sm_off, mask=sm_ok, other=0.0).to(tl.float32)
    s = tl.where(m > 0, s, -1e30)
    mx = tl.max(s, axis=1)
    e = tl.exp(s - mx[:, None]) * m
    denom = tl.maximum(tl.sum(e, axis=1), 1e-30)

    cols = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
    v_ok = row_ok[:, None] & (cols[None, :] < D)
    acc = tl.zeros((BLOCK_N, BLOCK_D), dtype=tl.float32)
    for f in range(0, F):
        m_f = tl.load(m_ptr + rows * F + f, mask=row_ok, other=0.0)
        m_f = m_f.to(tl.float32)
        s_f = tl.load(s_ptr + rows * F + f, mask=row_ok, other=0.0)
        s_f = tl.where(m_f > 0, s_f.to(tl.float32), -1e30)
        a_f = tl.exp(s_f - mx) * m_f / denom
        v = tl.load(v_ptr + (rows[:, None] * F + f) * D + cols[None, :],
                    mask=v_ok, other=0.0).to(tl.float32)
        acc += a_f[:, None] * v
    tl.store(out_ptr + rows[:, None] * D + cols[None, :], acc, mask=v_ok)


def _jit():
    """Compile-on-first-use handle of the Triton kernel.

    ``tl`` becomes a module global only here, where the kernel's body and
    its (string) annotations are resolved at compile time.
    """
    global _JIT, tl
    if _JIT is None:
        import triton
        import triton.language as tl
        _JIT = triton.jit(_edge_softmax_kernel)
    return _JIT


def _pow2(x: int, lo: int) -> int:
    return max(lo, 1 << max(int(x) - 1, 0).bit_length())


def edge_softmax(scores: torch.Tensor, mask: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_f softmax_f(scores[n,·])·vals[n,f,:], masked; (N, D) in
    ``vals``' dtype.

    scores/mask: (N, F); vals: (N, F, D).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, counted in
    ``edge_softmax.launches``.
    """
    if scores.dim() != 2 or mask.shape != scores.shape or vals.dim() != 3 \
            or vals.shape[:2] != scores.shape:
        raise ValueError(f"edge_softmax takes scores/mask (N, F) and vals "
                         f"(N, F, D); got {tuple(scores.shape)}, "
                         f"{tuple(mask.shape)}, {tuple(vals.shape)}")
    if vals.device.type == "cpu":
        return edge_softmax_ref(scores, mask, vals).to(vals.dtype)
    if vals.device.type != "cuda":
        raise ValueError(f"edge_softmax runs on cpu or cuda, not "
                         f"{vals.device}")
    if not (scores.device == mask.device == vals.device):
        raise ValueError("scores, mask and vals must share a device")
    n, f, d = vals.shape
    scores, mask, vals = (x.contiguous() for x in (scores, mask, vals))
    out = torch.empty((n, d), dtype=vals.dtype, device=vals.device)
    if n == 0 or d == 0:
        return out
    block_d = min(64, _pow2(d, 16))
    grid = (-(-n // BLOCK_N), -(-d // block_d))
    with torch.cuda.device(vals.device):
        _jit()[grid](scores, mask, vals, out, n, f, d, BLOCK_N=BLOCK_N,
                     BLOCK_F=_pow2(f, 2), BLOCK_D=block_d, num_warps=4)
    edge_softmax.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU path never counts).
edge_softmax.launches = 0
