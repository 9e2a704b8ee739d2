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
gathers.  On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.spmm_csr_ref`); on a CUDA tensor it
launches the kernel or raises.

The JAX package's tile format stays reachable from the tests:
:func:`build_bcsr` (a numpy copy of the reference's builder) and
:func:`bcsr_to_csr`, which turns its output into the same CSR.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import build
from repro_torch.kernels.ref import spmm_csr_ref

#: Nonzeros per work item of a split row (``kSeg`` of the CUDA source).
SEGMENT = 128


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
    """The ctypes entries of ``csrc/spmm_csr.cu``, built at first use."""
    if not _ENTRY:
        lib = build.load("spmm_csr")
        fn = lib.spmm_csr_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        slabs = lib.spmm_csr_slabs
        slabs.argtypes = [ctypes.c_int, ctypes.c_int]
        slabs.restype = ctypes.c_int
        _ENTRY.extend((fn, slabs))
    return _ENTRY


def spmm_csr(indptr: torch.Tensor, indices: torch.Tensor,
             values: torch.Tensor, h: torch.Tensor,
             items: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Â @ H over CSR operands; returns ``(N, D)`` f32.

    ``items`` is :func:`row_split` of ``indptr`` on the same device (or
    ``None``: one group of lanes per row, whatever its length); the plain
    version ignores it.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, counted in ``spmm_csr.launches``.
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
    out = torch.empty_like(h)
    d = h.shape[1]
    if n == 0 or d == 0:
        return out
    fn, slabs = _kernel()
    h_ptr = h.data_ptr()
    vec4 = int(d % 4 == 0 and h_ptr % 16 == 0)
    partial = arrivals = None
    n_items = n
    if items is not None:
        items = items.contiguous()
        n_items = items.shape[1]
        if n_items > n:               # a split row: its scratch
            partial = h.new_empty((n_items, d))
            arrivals = indptr.new_zeros(n * slabs(d, vec4))
    ptr = lambda x: None if x is None else x.data_ptr()
    err = build.launch_on(dev, fn, indptr.data_ptr(), indices.data_ptr(),
                          values.data_ptr(), ptr(items), h_ptr,
                          out.data_ptr(), ptr(partial), ptr(arrivals),
                          n_items, d, vec4)
    if err != 0:
        raise RuntimeError(f"spmm_csr kernel launch failed (cudaError {err})")
    spmm_csr.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU path never counts).
spmm_csr.launches = 0
