"""Row-wise int8 quantize / dequantize — the wire format of the compressed
communication layer — as hand-written CUDA kernels for Hopper.

Replaces the JAX package's Pallas TPU kernels ``quantize_rows`` and
``dequantize_rows`` (``src/repro/kernels/quantize.py``).  Each row of an f32
buffer travels as one f32 scale (``max(|row|, 1e-12)/127``) plus its values
rounded to int8 as ``clip(floor(x/scale + u), -127, 127)``; ``u`` holds the
caller's uniforms (stochastic rounding) or is ``None`` for a constant 0.5
(round-half-up).  Dequantize is ``q·scale``.

The quantize kernel (``csrc/quantize_rows.cu``) covers a row with a group
of lanes, a CTA or a cluster of CTAs, as :func:`geometry` picks from (R,
C), with 16-byte loads held in registers from the row max to the rounding.
Dequantize serves a whole table of (q, scale) segments in one launch
(:func:`dequantize_rows_many`, laid out by :func:`segment_table`), 16 int8
values a 16-byte load; config C's averaging round of 13 parameter leaves is
one launch.  Both divisions are correctly
rounded (``__fdiv_rn``), so on the card ``q``, ``scale`` and the dequantized
values are bit-equal to the plain versions in
:mod:`repro_torch.kernels.ref`.  On a CPU tensor the wrappers run those
plain versions; on a CUDA tensor they launch the kernel or raise.  Each
wrapper counts its launches.
"""
from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (dequantize_int8_rows_ref,
                                     quantize_int8_rows_ref)

#: SMs of an H100 SXM: the card the geometry fills.
SMS = 132
#: A row of at most this many loads is narrow: one warp covers it with at
#: most two loads a lane (C <= 256 on the float4 path), so a group of lanes
#: per row and shuffles within the group are all it needs.  With more, a
#: lone warp's chain of correctly rounded divisions shows: at (8, 512) four
#: loads a lane ran slower on the card than a CTA of 128 threads with one.
NARROW_LOADS = 64
#: A row of at most this many loads fits one CTA of <= 256 threads with one
#: load each; only longer rows are split over a cluster.
CTA_LOADS = 256
#: Loads per thread held in registers from the max to the quantize step:
#: x and u are 2 x 8 float4s, 64 registers, which keeps a 512-thread CTA
#: within the 128 registers a thread may have.
MAX_SLOTS = 8
#: The portable thread-block cluster size.
MAX_CLUSTER = 8


class Geometry(NamedTuple):
    """How the quantize kernel covers an (R, C) buffer.

    Thread ``t`` of CTA ``b`` serves row ``(b // cluster) * cta_rows +
    t // (lanes * row_warps)`` as its lane ``l = (b % cluster) * lanes *
    row_warps + t % (lanes * row_warps)`` of ``L = cluster * lanes *
    row_warps``, and takes the row's loads ``l, l + L, ...`` of ``vec``
    floats; the first ``slots`` of them stay in registers.
    """
    vec: int          # floats per load: 4 (16-byte loads) or 1
    lanes: int        # lanes of a warp per row; divides 32
    row_warps: int    # warps of a CTA per row
    cta_rows: int     # rows per CTA
    cluster: int      # CTAs per row (a thread-block cluster above 1)
    slots: int        # loads per thread kept in registers: 1, 2, 4 or 8
    grid: int         # CTAs

    @property
    def threads(self) -> int:
        return self.cta_rows * self.lanes * self.row_warps


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


@functools.lru_cache(maxsize=1024)
def geometry(r: int, c: int, vec4: bool = True) -> Geometry:
    """The quantize kernel's geometry for ``r`` rows of ``c`` floats;
    ``vec4=False`` (a pointer not 16-byte aligned) forces scalar loads.

    - Narrow rows (at most ``NARROW_LOADS`` loads): ``lanes`` = the loads
      rounded up to a power of two, at most 32, and up to two loads a lane.
      CTAs of one warp while the warps number under ``SMS``, to spread
      them over the SMs; above that, up to 8 warps a CTA (fewer, larger
      CTAs cost less to schedule once every SM has work).
    - Wide rows: a CTA of up to 256 threads per row, one load each where
      the row allows (up to 512 threads and 8 loads a thread for longer
      rows).  Rows longer than ``CTA_LOADS`` loads, fewer than ``SMS`` of
      them: each row is split over a cluster of up to ``MAX_CLUSTER`` CTAs
      so the grid reaches the SMs; (8, 4096) runs on 64 CTAs of 128
      threads, one float4 of x and one of u a thread.
    """
    vec = 4 if vec4 and c % 4 == 0 else 1
    n = -(-c // vec)                                  # loads per row
    if n <= NARROW_LOADS:
        lanes = min(32, _pow2(n))
        slots = _pow2(-(-n // lanes))
        warps = -(-r * lanes // 32)
        cta_warps = min(8, max(1, -(-warps // SMS)))
        cta_rows = cta_warps * 32 // lanes
        return Geometry(vec, lanes, 1, cta_rows, 1, slots,
                        max(1, -(-r // cta_rows)))
    cluster = 1 if r >= SMS or n <= CTA_LOADS else \
        min(MAX_CLUSTER, _pow2(-(-SMS // r)))
    per_cta = -(-n // cluster)
    threads = min(256, -(-per_cta // 32) * 32)
    if -(-per_cta // threads) > MAX_SLOTS:
        threads = min(512, -(-per_cta // (32 * MAX_SLOTS)) * 32)
    slots = min(MAX_SLOTS, _pow2(-(-per_cta // threads)))
    return Geometry(vec, 32, threads // 32, 1, cluster, slots,
                    max(1, r) * cluster)


#: Dequantize: a CTA's threads and the int8 values of one 16-byte load; a
#: CTA covers one tile of ``TILE`` values of one segment (the kernel checks
#: the table's tile counts against its own constants).
DEQ_THREADS = 128
CHUNK = 16
TILE = DEQ_THREADS * CHUNK
#: Segments one launch's table holds (a kernel parameter of < 4 KB).
MAX_SEGMENTS = 32


class SegmentTable(NamedTuple):
    """How :func:`dequantize_rows_many` lays out and launches its segments.

    Segment ``i`` of shape ``(R, C)`` writes floats ``offsets[i] ..
    offsets[i] + R·C`` of one flat f32 buffer of ``size`` floats; every
    offset is a multiple of 4 (16 bytes).  Each entry of ``launches`` is
    one launch: ``(segments, start)``, the indices of up to
    ``MAX_SEGMENTS`` non-empty segments and the prefix of their tiles.  CTA
    ``b`` of that launch serves segment ``segments[s]`` where ``start[s] <=
    b < start[s + 1]``, as its tile ``b - start[s]``: its warp ``w`` takes
    the ``32 · CHUNK`` values from ``tile · TILE + w · 32 · CHUNK`` on, cut
    at R·C.
    """
    offsets: Tuple[int, ...]
    size: int
    launches: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]


@functools.lru_cache(maxsize=256)
def segment_table(shapes: Tuple[Tuple[int, int], ...]) -> SegmentTable:
    """The :class:`SegmentTable` of segments of ``(R, C)`` ``shapes``:
    outputs packed in order, each rounded up to 16 bytes; empty segments
    take no CTA and enter no launch; ``MAX_SEGMENTS`` segments a launch."""
    offsets, size = [], 0
    for r, c in shapes:
        offsets.append(size)
        size += -(-(r * c) // 4) * 4
    live = [i for i, (r, c) in enumerate(shapes) if r * c > 0]
    launches = []
    for k in range(0, len(live), MAX_SEGMENTS):
        segs = tuple(live[k:k + MAX_SEGMENTS])
        start = [0]
        for i in segs:
            r, c = shapes[i]
            start.append(start[-1] + -(-(r * c) // TILE))
        launches.append((segs, tuple(start)))
    return SegmentTable(tuple(offsets), size, tuple(launches))


class _Plan(NamedTuple):
    """What a call of :func:`dequantize_rows_many` needs of its q shapes
    alone, built once per shape set: the table, each output's shape and
    strides, and per launch its segments and the ctypes arrays of their
    dims and tile prefix."""
    table: SegmentTable
    views: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...], int], ...]
    launches: tuple


@functools.lru_cache(maxsize=256)
def _plan(qshapes: Tuple[Tuple[int, ...], ...],
          sshapes: Tuple[Tuple[int, ...], ...]) -> _Plan:
    """The :class:`_Plan` of q shapes ``qshapes`` with scales of
    ``sshapes``; raises ``ValueError`` where they do not pair up."""
    if len(qshapes) != len(sshapes):
        raise ValueError(f"{len(qshapes)} q tensors but {len(sshapes)} "
                         f"scales")
    for qs, ss in zip(qshapes, sshapes):
        if len(qs) == 0 or tuple(ss) != (qs[0], 1):
            raise ValueError(f"q must be (R, ...) and scale (R, 1), got "
                             f"{tuple(qs)} and {tuple(ss)}")
    rc = tuple((s[0], math.prod(s[1:])) for s in qshapes)
    if any(r * c >= 2 ** 31 for r, c in rc):
        raise ValueError(f"dequantize_rows takes segments of < 2^31 values, "
                         f"got {rc}")
    table = segment_table(rc)
    views = tuple((s, tuple(math.prod(s[d + 1:]) for d in range(len(s))), o)
                  for s, o in zip(qshapes, table.offsets))
    launches = []
    for segs, start in table.launches:
        dims = [d for i in segs for d in rc[i]]
        launches.append((segs, (ctypes.c_int * len(dims))(*dims),
                         (ctypes.c_int * len(start))(*start)))
    return _Plan(table, views, tuple(launches))


#: argtypes of each C entry, which then takes the stream: quantize's ints
#: are R, C and the seven fields of its Geometry; dequantize takes the
#: pointer, dims and tile-prefix arrays of a table and its segment count.
_ARGTYPES = {
    "quantize_rows_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9,
    "dequantize_rows_grouped_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int]}
_ENTRIES = {}


def _kernel(name: str):
    """A ctypes entry of ``csrc/quantize_rows.cu``, built at first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(build.load("quantize_rows"), name)
        fn.argtypes = _ARGTYPES[name] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _check_err(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def _dense(*tensors):
    """The operands as contiguous tensors, copying only those that are
    not."""
    return tuple(t if t is None or t.is_contiguous() else t.contiguous()
                 for t in tensors)


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
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"quantize_rows runs on cpu or cuda, not "
                             f"{x.device}")
        return quantize_int8_rows_ref(x, u)
    # get_device(): the CUDA index, -1 on the CPU (cheaper than .device)
    dev = x.get_device()
    if u is not None and u.get_device() != dev:
        raise ValueError("quantize_rows: x and u must share a device")
    if x.dtype is not torch.float32 or (u is not None
                                        and u.dtype is not torch.float32):
        raise ValueError("quantize_rows takes float32 x and u, got "
                         f"{x.dtype}/{None if u is None else u.dtype}")
    r, c = x.shape
    q = x.new_empty((r, c), dtype=torch.int8)
    scale = x.new_empty((r, 1))
    if r == 0:
        return q, scale
    x, u = _dense(x, u)
    x_ptr = x.data_ptr()
    u_ptr = None if u is None else u.data_ptr()
    g = geometry(r, c, x_ptr % 16 == 0 and (u_ptr or 0) % 16 == 0)
    _check_err("quantize_rows", build.launch_on(
        dev, _kernel("quantize_rows_f32"), x_ptr, u_ptr, q.data_ptr(),
        scale.data_ptr(), r, c, g.vec, g.lanes, g.row_warps, g.cta_rows,
        g.cluster, g.slots, g.grid))
    quantize_rows.launches += 1
    return q, scale


def dequantize_rows_many(qs: Sequence[torch.Tensor],
                         scales: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """``[q_i·scale_i]`` in f32 of ``q_i``'s shape ← ``q_i int8 (R_i, …)``
    (row ``r`` is ``q_i[r]`` flattened; ``(R_i, C_i)`` in the 2-D case) and
    ``scale_i f32 (R_i, 1)``, all on one device.

    CPU tensors take the plain version per segment.  On CUDA tensors the
    results are contiguous views of one flat f32 buffer, written by one
    kernel launch per ``MAX_SEGMENTS`` non-empty segments, each counted in
    ``dequantize_rows.launches``.  A segment holds fewer than 2^31 values.
    """
    # shapes are checked once per shape set, with the plan they key
    plan = _plan(tuple([q.shape for q in qs]),
                 tuple([scale.shape for scale in scales]))
    if not qs:
        return []
    # get_device(): the CUDA index, -1 on the CPU (cheaper than .device)
    dev = qs[0].get_device()
    for q, scale in zip(qs, scales):
        if q.get_device() != dev or scale.get_device() != dev:
            raise ValueError("dequantize_rows: every q and scale must share "
                             "a device")
        if dev >= 0 and (q.dtype is not torch.int8
                         or scale.dtype is not torch.float32):
            raise ValueError(f"dequantize_rows takes int8 q and float32 "
                             f"scale, got {q.dtype}/{scale.dtype}")
    if dev < 0:
        if qs[0].device.type != "cpu":
            raise ValueError(f"dequantize_rows runs on cpu or cuda, not "
                             f"{qs[0].device}")
        return [dequantize_int8_rows_ref(
                    q.reshape(q.shape[0], math.prod(q.shape[1:])),
                    scale).view(q.shape)
                for q, scale in zip(qs, scales)]
    flat = scales[0].new_empty(plan.table.size)
    outs = [torch.as_strided(flat, shape, strides, offset)
            for shape, strides, offset in plan.views]
    out_ptr = flat.data_ptr()
    kernel = _kernel("dequantize_rows_grouped_f32")
    copies = []            # of non-contiguous operands, kept to the launch
    for segs, dims, start in plan.launches:
        ptrs = array.array("Q")
        for i in segs:
            q, scale = qs[i], scales[i]
            if not q.is_contiguous():
                q = q.contiguous()
                copies.append(q)
            if not scale.is_contiguous():
                scale = scale.contiguous()
                copies.append(scale)
            ptrs.extend((q.data_ptr(), scale.data_ptr(),
                         out_ptr + 4 * plan.table.offsets[i]))
        _check_err("dequantize_rows", build.launch_on(
            dev, kernel, ptrs.buffer_info()[0], dims, start, len(segs)))
        dequantize_rows.launches += 1
    return outs


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q·scale`` as f32 ``(R, C)`` ← ``q int8 (R, C)``, ``scale (R, 1)``:
    the one-segment case of :func:`dequantize_rows_many`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    counted in ``dequantize_rows.launches``.
    """
    if q.dim() != 2:
        raise ValueError(f"q must be (R, C), got {tuple(q.shape)}")
    return dequantize_rows_many((q,), (scale,))[0]


#: Kernel launches since the last reset (the plain CPU path never counts).
quantize_rows.launches = 0
dequantize_rows.launches = 0
