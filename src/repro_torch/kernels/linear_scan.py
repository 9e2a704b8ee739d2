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
ragged T is masked inside the kernel.  Asked for them (``save_states``), it
also writes the state at the start of each chunk, which the gradient's
kernel (``csrc/linear_scan_bwd.cu``, :func:`linear_scan_chunked_bwd`)
reads.  The plain versions are
:func:`repro_torch.kernels.ref.chunked_scan_ref` and, for the scalar
decay, :func:`~repro_torch.kernels.ref.chunked_scan_scalar_ref`, which take
whole chunks: on a CPU tensor the wrapper pads a ragged T for them.  On a
CUDA tensor the wrapper launches the kernel or raises, and counts the
launch in ``linear_scan_chunked.launches``; the gradient's wrapper counts
its own in ``linear_scan_chunked_bwd.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (chunked_scan_ref, chunked_scan_scalar_ref,
                                     linear_scan_vjp_ref)

#: chunk, dk and dv limit of the kernel's shared-memory tiles
MAX_DIM = 64

_ENTRY = []
_BWD = []


def _kernel():
    """The ctypes entry of ``csrc/linear_scan.cu``, built at first use."""
    if not _ENTRY:
        lib = build.load("linear_scan")
        fn = lib.linear_scan_chunked_f32
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.linear_scan_ctas_per_sm
        occ.argtypes = [ctypes.c_int]
        occ.restype = ctypes.c_int
        _ENTRY.extend((fn, occ))
    return _ENTRY[0]


def _bwd_kernel():
    """The ctypes entry of ``csrc/linear_scan_bwd.cu``, built at first
    use."""
    if not _BWD:
        fn = build.load("linear_scan_bwd").linear_scan_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD.append(fn)
    return _BWD[0]


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
                        strict: bool = False, ragged: bool = False,
                        save_states: bool = False) -> Tuple[torch.Tensor, ...]:
    """Batched chunked scan.

    q,k: (BH, T, dk); v: (BH, T, dv); log_w: (BH, T, dk), or (BH, T) for
    the scalar-decay mode (one decay per step and batch·head; the plain
    convention only); h0: (BH, dk, dv) or None (zeros); u: (BH, dk)
    strict-mode bonus or None.  ``T % chunk == 0`` unless ``ragged``: then
    the last chunk's missing steps count as zero inputs with decay 1
    (``h_T`` unchanged by them), masked in the kernel and padded for the
    plain version.  Returns (y (BH,T,dv) f32, h_T (BH,dk,dv) f32), and with
    ``save_states`` (CUDA tensors only: the plain version's gradient
    recomputes) also the chunk-start states h_in (BH, ⌈T/chunk⌉, dk, dv)
    f32 that :func:`linear_scan_chunked_bwd` reads.
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
    if is_traced(q):
        return _traced_forward(q, v, chunk, save_states)
    if q.device.type == "cpu":
        if save_states:
            raise ValueError("save_states is for the kernel: on the CPU the "
                             "gradient recomputes the plain version")
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
    h_in = torch.empty((bh, -(-t // chunk), dk, dv), dtype=torch.float32,
                       device=q.device) if save_states else None
    out = (y, h_t, h_in) if save_states else (y, h_t)
    if bh == 0:
        return out
    err = build.launch_on(q.get_device(), _kernel(), q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                          _ptr(h0), _ptr(u), y.data_ptr(), h_t.data_ptr(),
                          _ptr(h_in), bh, t, dk, dv, chunk, int(strict),
                          int(scalar))
    if err != 0:
        raise RuntimeError(f"linear_scan_chunked kernel launch failed "
                           f"(cudaError {err})")
    linear_scan_chunked.launches += 1
    return out


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def linear_scan_chunked_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, log_w: torch.Tensor,
                            h0: Optional[torch.Tensor],
                            u: Optional[torch.Tensor],
                            h_in: Optional[torch.Tensor],
                            h_t: Optional[torch.Tensor], dy: torch.Tensor,
                            dh_t: Optional[torch.Tensor], chunk: int = 64,
                            strict: bool = False
                            ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of :func:`linear_scan_chunked` (``ragged=True``) for
    output cotangents ``dy`` (BH, T, dv) and ``dh_t`` (BH, dk, dv) or None
    (h_T unused).

    Returns ``(dq, dk, dv, dlog_w, dh0, du)`` in the operands' shapes;
    ``dh0`` is None without ``h0``, ``du`` without ``u`` or when not
    ``strict`` (the plain convention reads no bonus).  On a CUDA tensor
    the kernel ``csrc/linear_scan_bwd.cu`` walks the chunks in reverse from
    the forward's saved chunk-start states ``h_in`` and its ``h_t`` (both
    from ``linear_scan_chunked(..., save_states=True)``), launching once
    (counted in ``linear_scan_chunked_bwd.launches``) or raising; on a CPU
    tensor the plain version
    :func:`~repro_torch.kernels.ref.linear_scan_vjp_ref` (torch autograd of
    the chunked reference) recomputes from the operands and ignores
    ``h_in`` and ``h_t``.
    """
    u = u if strict else None
    if is_traced(q):
        return _traced_backward(q, k, v, log_w, h0, u, chunk)
    if q.device.type == "cpu":
        return linear_scan_vjp_ref(q, k, v, log_w, h0, u, dy, dh_t,
                                   chunk=chunk, strict=strict)
    scalar = log_w.dim() == 2
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if h_in is None or h_t is None:
        raise ValueError("the kernel reads the forward's saved states: "
                         "pass h_in and h_t from linear_scan_chunked(..., "
                         "save_states=True)")
    if h_in.shape != (bh, -(-t // chunk), dk, dv):
        raise ValueError(f"h_in must be {(bh, -(-t // chunk), dk, dv)}, got "
                         f"{tuple(h_in.shape)}")
    ops = [x for x in (q, k, v, log_w, h0, u, h_in, h_t, dy, dh_t)
           if x is not None]
    if q.device.type != "cuda" or any(x.device != q.device for x in ops):
        raise ValueError(f"linear_scan_chunked_bwd runs on cpu or cuda, with "
                         f"every operand on one device; got "
                         f"{[str(x.device) for x in ops]}")
    if any(x.dtype != torch.float32 for x in ops):
        raise ValueError("linear_scan_chunked_bwd takes float32 operands, "
                         f"got {[x.dtype for x in ops]}")
    if dk > MAX_DIM or dv > MAX_DIM or not 1 <= chunk <= MAX_DIM:
        raise ValueError(f"the kernel takes chunk, dk, dv <= {MAX_DIM}, got "
                         f"{chunk}, {dk}, {dv}")
    q, k, v, log_w, h_in, h_t, dy = (x.contiguous() for x in
                                     (q, k, v, log_w, h_in, h_t, dy))
    u = None if u is None else u.contiguous()
    dh_t = None if dh_t is None else dh_t.contiguous()
    dq, dk_, dv_, dlw = (torch.empty_like(x) for x in (q, k, v, log_w))
    dh0 = None if h0 is None else torch.empty_like(h0)
    du = None if u is None else torch.empty_like(u)
    if bh == 0 or t == 0:
        for x in (dq, dk_, dv_, dlw, dh0, du):
            if x is not None:
                x.zero_()
        if dh0 is not None and dh_t is not None:
            dh0.copy_(dh_t)               # T = 0: h_T is h0
        return dq, dk_, dv_, dlw, dh0, du
    err = build.launch_on(
        q.get_device(), _bwd_kernel(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), log_w.data_ptr(), _ptr(u), h_in.data_ptr(),
        None if dh_t is None else h_t.data_ptr(), dy.data_ptr(), _ptr(dh_t),
        dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dlw.data_ptr(),
        _ptr(dh0), _ptr(du), bh, t, dk, dv, chunk, int(strict), int(scalar))
    if err != 0:
        raise RuntimeError(f"linear_scan_chunked_bwd kernel launch failed "
                           f"(cudaError {err})")
    linear_scan_chunked_bwd.launches += 1
    return dq, dk_, dv_, dlw, dh0, du


#: Kernel launches since the last reset (the plain CPU path never counts).
linear_scan_chunked.launches = 0
linear_scan_chunked_bwd.launches = 0


# --------------------------------------------------------------------------
# The dry run's stand-in (fake tensors only)
# --------------------------------------------------------------------------
def is_traced(x: torch.Tensor) -> bool:
    """Whether ``x`` is a fake tensor (the dry run's trace, which allocates
    and computes nothing)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


_TRACE_OPS = []


def _trace_ops():
    """Two shape-only ops for the dry run, standing in for the kernels on
    fake tensors: their outputs are the kernels' (the forward's chunk-start
    states included, which the gradient kernel reads), and
    ``FlopCounterMode`` counts each as the chunked form's products: per
    step 2·(chunk·(dk + dv) + 2·dk·dv) FLOPs forward, twice that for the
    gradient.  Registered on first use; called on real tensors they
    raise."""
    if _TRACE_OPS:
        return _TRACE_OPS
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::scan_trace", mutates_args=())
    def scan_trace(q: torch.Tensor, v: torch.Tensor, chunk: int,
                   save: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        raise RuntimeError("scan_trace stands in for the scan on fake "
                           "tensors only")

    @scan_trace.register_fake
    def _(q, v, chunk, save):
        bh, t, dk = q.shape
        dv = v.shape[-1]
        states = (bh, -(-t // chunk), dk, dv) if save else (0,)
        f32 = dict(dtype=torch.float32, device=q.device)
        return (q.new_empty((bh, t, dv), **f32),
                q.new_empty((bh, dk, dv), **f32),
                q.new_empty(states, **f32))

    @torch.library.custom_op("repro_torch::scan_bwd_trace", mutates_args=())
    def scan_bwd_trace(q: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
                       chunk: int) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor, torch.Tensor]:
        raise RuntimeError("scan_bwd_trace stands in for the gradient "
                           "kernel on fake tensors only")

    @scan_bwd_trace.register_fake
    def _(q, v, log_w, chunk):
        return (torch.empty_like(q, dtype=torch.float32),
                torch.empty_like(q, dtype=torch.float32),
                torch.empty_like(v, dtype=torch.float32),
                torch.empty_like(log_w, dtype=torch.float32))

    def flops(q_shape, v_shape, chunk):
        bh, t, dk = q_shape
        dv = v_shape[-1]
        return 2 * bh * t * (chunk * (dk + dv) + 2 * dk * dv)

    @register_flop_formula(torch.ops.repro_torch.scan_trace)
    def _(q_shape, v_shape, chunk, save, *args, **kwargs):
        return flops(q_shape, v_shape, chunk)

    @register_flop_formula(torch.ops.repro_torch.scan_bwd_trace)
    def _(q_shape, v_shape, log_w_shape, chunk, *args, **kwargs):
        return 2 * flops(q_shape, v_shape, chunk)

    _TRACE_OPS.extend([torch.ops.repro_torch.scan_trace,
                       torch.ops.repro_torch.scan_bwd_trace])
    return _TRACE_OPS


def _traced_forward(q, v, chunk, save_states):
    y, h_t, states = _trace_ops()[0](q, v, chunk, save_states)
    return (y, h_t, states) if save_states else (y, h_t)


def _traced_backward(q, k, v, log_w, h0, u, chunk):
    dq, dk, dv, dlw = _trace_ops()[1](q, v, log_w, chunk)
    return (dq, dk, dv, dlw,
            None if h0 is None else torch.empty_like(h0, dtype=torch.float32),
            None if u is None else torch.empty_like(u, dtype=torch.float32))
