"""CSR SpMM — the full-neighbor aggregation of the server correction, as a
hand-written CUDA kernel for Hopper.

Replaces the JAX package's Pallas TPU kernel ``spmm_bcsr``
(``src/repro/kernels/spmm.py``, ``_spmm_kernel``).  It computes the same
``Â @ H`` in f32; the operands are CSR instead of the TPU's 8×128 tiles,
which are 0.3% full on a 16,384-node SBM graph:

  indptr:  (N+1,)  int32 — row pointers.
  indices: (nnz,)  int32 — the column of each nonzero, sorted per row.
  values:  (nnz,)  f32   — its value.
  h:       (N, D)  f32.

The kernel (``csrc/spmm_csr.cu``) gives each row a group of lanes that
gathers the rows of H its nonzeros name, with 16-byte loads, in the row's
order; rows above ``SEGMENT`` nonzeros are split into work items
(:func:`row_split`) so a hub does not hold one group for thousands of
gathers.  Each nonzero reads a row of H, so what bounds the kernel is
where those gathers come from: at the LLCG benchmark's 232,965 rows H is
238 MB (D = 256) or 561 MB (D = 602), beyond the H100's 50 MB of L2, and
gathered across all of D at once most of it comes from HBM.
:func:`slab_plan` therefore splits D into column slabs of one 128-byte
line (32 floats), and the launch passes over all rows slab after slab
(packing H slab-major first where a row is no whole number of lines), so a
pass gathers whole lines from 29.8 MB of H at that size, which L2 holds.
Where H fits half of L2 and its rows are whole float4s, one pass gathers
straight from it: there the slabs save no HBM traffic, and the index
stream read once a slab costs time at narrow D and on skewed rows.  The
plan follows from N and D alone; the sums do not depend on it.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.spmm_csr_ref`); on a CUDA tensor it
launches the kernel or raises.

The JAX package's tile format stays reachable from the tests:
:func:`build_bcsr` (a numpy copy of the reference's builder) and
:func:`bcsr_to_csr`, which turns its output into the same CSR.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import build
from repro_torch.kernels.ref import pack_slabs_ref, spmm_csr_ref

#: Nonzeros per work item of a split row (``kSeg`` of the CUDA source).
SEGMENT = 128

#: The H100's L2 cache.
L2_BYTES = 50 * 2**20
#: Where all of H fits this, one pass gathers straight from H: half of the
#: L2, as it is two partitions and a line read from both may sit in both.
#: Measured on the H100 (PERF.md): below it the lane split is within 4% of
#: one-line slabs at D 32-256 and 8-26% faster at D 16, with hubs and
#: where slabs need the pack; above it slabs are 3% slower at 65,536 rows
#: (H 34 and 67 MB), 14-28% faster from 100,000 rows (51-154 MB) and 1.7x
#: at the LLCG benchmark's 232,965.
SINGLE_PASS_BYTES = L2_BYTES // 2
#: Bytes of an L2 line.
LINE = 128
#: Floats of a column slab where H does not fit: one line of every row,
#: whole-line gathers (narrower slabs, which fit half of the L2 at larger
#: N, were measured slower at every N tried; PERF.md).
SLAB_WIDTH = LINE // 4


def _edge_values(graph: CSRGraph, src: np.ndarray, dst: np.ndarray,
                 normalization: str) -> np.ndarray:
    """The value of each edge under ``normalization``: 'mean' → Â = D⁻¹A
    (Eq. 1's mean aggregation); 'sym' → D^{-1/2} A D^{-1/2}; 'none' → raw
    adjacency.  The JAX package's formulas, in f32."""
    deg = np.maximum(graph.degrees(), 1).astype(np.float32)
    if normalization == "mean":
        return 1.0 / deg[src]
    if normalization == "sym":
        return 1.0 / np.sqrt(deg[src] * deg[dst])
    if normalization == "none":
        return np.ones_like(src, dtype=np.float32)
    raise ValueError(normalization)


# --------------------------------------------------------------------------
# Host-side operands
# --------------------------------------------------------------------------
def build_csr(graph: CSRGraph, normalization: str = "mean"
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(indptr int32, indices int32, values f32)`` of Â."""
    src, dst = graph.to_edges()
    values = _edge_values(graph, src, dst, normalization).astype(np.float32)
    return (graph.indptr.astype(np.int32), graph.indices.astype(np.int32),
            values)


def bcsr_to_csr(tile_cols: np.ndarray, tile_vals: np.ndarray,
                num_nodes: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The CSR ``(indptr, indices, values)`` of a BCSR tile inventory — the
    JAX package's ``build_bcsr`` output — over ``num_nodes`` rows.

    A tile's nonzero entries are the matrix's nonzeros (padding tiles are
    all zero, and no edge has the value 0), so the conversion is exact.
    """
    tile_cols = np.asarray(tile_cols)
    tile_vals = np.asarray(tile_vals)
    _, _, bm, bn = tile_vals.shape
    rb, t, m, n = np.nonzero(tile_vals)
    rows = rb.astype(np.int64) * bm + m
    cols = tile_cols[rb, t].astype(np.int64) * bn + n
    vals = tile_vals[rb, t, m, n].astype(np.float32)
    if rows.size and (rows.max() >= num_nodes or cols.max() >= num_nodes):
        raise ValueError(f"a tile holds a nonzero past num_nodes={num_nodes}")
    order = np.lexsort((cols, rows))
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=num_nodes), out=indptr[1:])
    return (indptr.astype(np.int32), cols[order].astype(np.int32),
            vals[order])


def row_split(indptr: np.ndarray) -> Optional[np.ndarray]:
    """The kernel's work items, ``(2, n_items)`` int32 of (row, first
    nonzero): one item per row, and ``ceil(deg / SEGMENT)`` items per row
    above ``SEGMENT`` nonzeros.  ``None`` when no row is that long (the
    kernel then takes one group per row)."""
    indptr = np.asarray(indptr, np.int64)
    deg = np.diff(indptr)
    if not deg.size or deg.max() <= SEGMENT:
        return None
    parts = np.maximum(1, -(-deg // SEGMENT))
    rows = np.repeat(np.arange(deg.size), parts)
    within = np.arange(rows.size) - np.repeat(np.cumsum(parts) - parts, parts)
    return np.stack([rows, indptr[rows] + within * SEGMENT]).astype(np.int32)


# --------------------------------------------------------------------------
# Column slabs
# --------------------------------------------------------------------------
class SlabPlan(NamedTuple):
    """How one launch covers the D columns of H: ``lanes`` lanes share a
    row, each loading a float4, so a pass covers ``width`` = 4 · lanes
    columns of every row; ``slabs`` passes cover D, one after another; with
    ``packed`` they gather from the slab-major copy of H
    (:func:`pack_slabs`)."""
    lanes: int
    slabs: int
    packed: bool

    @property
    def width(self) -> int:
        return 4 * self.lanes


def slab_plan(n: int, d: int, h_ptr: int = 0) -> SlabPlan:
    """The column split of a launch over an (n, d) H at address ``h_ptr``,
    decided from the shape alone.

    Where all of H fits :data:`SINGLE_PASS_BYTES` and its rows are whole
    float4s (D % 4 == 0, H 16-byte aligned), the passes gather straight
    from H with as many lanes as D needs up to 32: one pass up to 128
    columns.  Otherwise a pass covers a slab of :data:`SLAB_WIDTH` floats,
    one line of every row, slab after slab; straight from H where its rows
    are whole lines (D % 32 == 0, H line-aligned), else from the slab-major
    copy."""
    if 4 * n * d <= SINGLE_PASS_BYTES and d % 4 == 0 and h_ptr % 16 == 0:
        lanes = 1
        while 4 * lanes < d and lanes < 32:
            lanes *= 2
        return SlabPlan(lanes, -(-d // (4 * lanes)), False)
    direct = d % SLAB_WIDTH == 0 and h_ptr % LINE == 0
    return SlabPlan(SLAB_WIDTH // 4, -(-d // SLAB_WIDTH), not direct)


def build_bcsr(graph: CSRGraph, block_m: int = 8, block_n: int = 128,
               normalization: str = "mean") -> Tuple[np.ndarray, np.ndarray, int]:
    """Build the JAX package's (tile_cols, tile_vals, n_padded) from a CSR
    graph — the TPU kernel's format, for parity tests of the converter."""
    n = graph.num_nodes
    # lcm padding so both row and col blocks divide
    lcm = int(np.lcm(block_m, block_n))
    n_pad = int(np.ceil(n / lcm)) * lcm
    assert n_pad % block_m == 0 and n_pad % block_n == 0 and n_pad >= n
    src, dst = graph.to_edges()
    vals = _edge_values(graph, src, dst, normalization)

    rb = src // block_m
    cb = dst // block_n
    n_rb = n_pad // block_m
    # group edges by (row_block, col_block)
    key = rb.astype(np.int64) * (n_pad // block_n) + cb
    order = np.argsort(key, kind="stable")
    src, dst, vals, rb, cb, key = (a[order] for a in (src, dst, vals, rb, cb, key))
    uniq, starts = np.unique(key, return_index=True)
    starts = list(starts) + [len(key)]

    tiles_per_row: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n_rb)]
    for u_idx, u in enumerate(uniq):
        lo, hi = starts[u_idx], starts[u_idx + 1]
        r, c = int(u) // (n_pad // block_n), int(u) % (n_pad // block_n)
        tile = np.zeros((block_m, block_n), np.float32)
        tile[src[lo:hi] % block_m, dst[lo:hi] % block_n] = vals[lo:hi]
        # note: duplicate (i,j) edges were deduped in CSRGraph.from_edges
        tiles_per_row[r].append((c, tile))

    max_tiles = max((len(t) for t in tiles_per_row), default=1) or 1
    tile_cols = np.zeros((n_rb, max_tiles), np.int32)
    tile_vals = np.zeros((n_rb, max_tiles, block_m, block_n), np.float32)
    for r, tiles in enumerate(tiles_per_row):
        for k, (c, tile) in enumerate(tiles):
            tile_cols[r, k] = c
            tile_vals[r, k] = tile
    return tile_cols, tile_vals, n_pad


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------
_ENTRY = []


def _kernel():
    """The ctypes entries of ``csrc/spmm_csr.cu`` (the SpMM and the pack),
    built at first use."""
    if not _ENTRY:
        lib = build.load("spmm_csr")
        fn = lib.spmm_csr_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + \
            [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        pack = lib.spmm_csr_pack_f32
        pack.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        pack.restype = ctypes.c_int
        _ENTRY.extend((fn, pack))
    return _ENTRY


def spmm_csr(indptr: torch.Tensor, indices: torch.Tensor,
             values: torch.Tensor, h: torch.Tensor,
             items: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Â @ H over CSR operands; returns ``(N, D)`` f32.

    ``items`` is :func:`row_split` of ``indptr`` on the same device (or
    ``None``: one group of lanes per row, whatever its length); the plain
    version ignores it.  CPU tensors take the plain version; CUDA tensors
    launch the kernel under :func:`slab_plan`, counted in
    ``spmm_csr.launches`` and its passes in ``spmm_csr.slab_passes``.
    """
    if indptr.dim() != 1 or indptr.shape[0] < 1:
        raise ValueError(f"indptr must be (N+1,), got {tuple(indptr.shape)}")
    n = indptr.shape[0] - 1
    if indices.dim() != 1 or values.shape != indices.shape:
        raise ValueError(f"indices and values must be (nnz,), got "
                         f"{tuple(indices.shape)}, {tuple(values.shape)}")
    if h.dim() != 2 or h.shape[0] != n:
        raise ValueError(f"h must be ({n}, D) for an indptr of {n + 1} "
                         f"entries, got {tuple(h.shape)}")
    if indptr.dtype is not torch.int32 or indices.dtype is not torch.int32 \
            or values.dtype is not torch.float32:
        raise ValueError("spmm_csr takes int32 indptr/indices and float32 "
                         f"values, got {indptr.dtype}/{indices.dtype}/"
                         f"{values.dtype}")
    if items is not None and (items.dim() != 2 or items.shape[0] != 2
                              or items.dtype is not torch.int32):
        raise ValueError(f"items must be (2, n_items) int32, got "
                         f"{tuple(items.shape)} {items.dtype}")
    # get_device(): the CUDA index, -1 on the CPU (cheaper than .device)
    dev = h.get_device()
    if indptr.get_device() != dev or indices.get_device() != dev \
            or values.get_device() != dev or (
                items is not None and items.get_device() != dev):
        raise ValueError("the CSR operands and h must share a device")
    if not h.is_cuda:
        if h.device.type != "cpu":
            raise ValueError(f"spmm_csr runs on cpu or cuda, not {h.device}")
        return spmm_csr_ref(indptr, indices, values, h)
    if h.dtype is not torch.float32:
        raise ValueError(f"spmm_csr takes float32 h, got {h.dtype}")
    if not (indptr.is_contiguous() and indices.is_contiguous()
            and values.is_contiguous() and h.is_contiguous()):
        indptr, indices, values, h = (x.contiguous()
                                      for x in (indptr, indices, values, h))
    if n == 0 or h.shape[1] == 0:
        return torch.empty_like(h)
    if items is not None:
        items = items.contiguous()
    return _launch(slab_plan(n, h.shape[1], h.data_ptr()), indptr, indices,
                   values, h, items)


def pack_slabs(h: torch.Tensor, slabs: int) -> torch.Tensor:
    """The slab-major copy of a contiguous f32 H that a packed plan gathers
    from: ``(slabs, N, SLAB_WIDTH)``, zeros past D.  A CUDA tensor takes
    the pack kernel, a CPU tensor
    :func:`repro_torch.kernels.ref.pack_slabs_ref`."""
    if not h.is_cuda:
        return pack_slabs_ref(h, SLAB_WIDTH, slabs)
    if h.dim() != 2 or h.dtype is not torch.float32 or not h.is_contiguous():
        raise ValueError(f"pack_slabs takes a contiguous (N, D) float32 h, "
                         f"got {tuple(h.shape)} {h.dtype}")
    n, d = h.shape
    packed = h.new_empty((slabs, n, SLAB_WIDTH))
    err = build.launch_on(h.get_device(), _kernel()[1], h.data_ptr(),
                          packed.data_ptr(), n, d, slabs)
    if err != 0:
        raise RuntimeError(f"spmm_csr pack launch failed (cudaError {err})")
    return packed


def _launch(plan: SlabPlan, indptr: torch.Tensor, indices: torch.Tensor,
            values: torch.Tensor, h: torch.Tensor,
            items: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the kernel under ``plan`` on checked, contiguous CUDA
    operands (the pack first where ``plan.packed``); counted."""
    fn, _ = _kernel()
    dev = h.get_device()
    n, d = h.shape
    out = torch.empty_like(h)
    src, h_row, h_slab = h, d, plan.width
    if plan.packed:
        src = pack_slabs(h, plan.slabs)
        h_row, h_slab = plan.width, n * plan.width
    partial = arrivals = None
    n_items = n if items is None else items.shape[1]
    if n_items > n:                   # split rows: their scratch
        partial = h.new_empty((2 * (n_items - n), plan.slabs * plan.width))
        arrivals = indptr.new_zeros((n_items - n) * plan.slabs)
    ptr = lambda x: None if x is None else x.data_ptr()
    err = build.launch_on(dev, fn, indptr.data_ptr(), indices.data_ptr(),
                          values.data_ptr(), ptr(items), src.data_ptr(),
                          out.data_ptr(), ptr(partial), ptr(arrivals),
                          n_items, d, h_row, h_slab, plan.lanes, plan.slabs)
    if err != 0:
        raise RuntimeError(f"spmm_csr kernel launch failed (cudaError {err})")
    spmm_csr.launches += 1
    spmm_csr.slab_passes += plan.slabs
    return out


#: Kernel launches since the last reset (the plain CPU path never counts).
spmm_csr.launches = 0
#: Column-slab passes of those launches (each reads the index stream once).
spmm_csr.slab_passes = 0
