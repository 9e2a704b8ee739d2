"""Block-sparse (BCSR) SpMM — the full-neighbor aggregation of the server
correction, as a hand-written CUDA kernel for Hopper.

Replaces the JAX package's Pallas TPU kernel ``spmm_bcsr``
(``src/repro/kernels/spmm.py``, ``_spmm_kernel``).  The operand contract is
unchanged, so the JAX package's :func:`build_bcsr` output feeds this kernel
directly:

  tile_cols: (n_row_blocks, max_tiles)            int32  — column-block ids,
             padded with 0 (padding tiles have all-zero values).
  tile_vals: (n_row_blocks, max_tiles, 8, 128)    f32    — tile contents.
  h:         (n_rows, D)                          f32    — rows past
             ``n_rows`` (up to the last column block) count as zero.

The kernel (``csrc/spmm_bcsr.cu``) runs one CTA per (row block, 32-column
slab of D) and loops over the row block's tiles inside the CTA, staging each
tile and its gathered 128×32 slab of H in shared memory and accumulating f32
FMAs in registers.  It is bound by memory traffic: each tile value is read
once and used for 32 FMAs.  On a CPU tensor the wrapper runs the plain
version (:func:`repro_torch.kernels.ref.spmm_bcsr_ref`); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import build
from repro_torch.kernels.ref import spmm_bcsr_ref

#: Tile shape the CUDA kernel is written for.
BLOCK_M, BLOCK_N = 8, 128


# --------------------------------------------------------------------------
# Host-side BCSR construction (numpy copy of the JAX package's build_bcsr)
# --------------------------------------------------------------------------
def build_bcsr(graph: CSRGraph, block_m: int = 8, block_n: int = 128,
               normalization: str = "mean") -> Tuple[np.ndarray, np.ndarray, int]:
    """Build (tile_cols, tile_vals, n_padded) from a CSR graph.

    ``normalization``: 'mean' → Â = D⁻¹A (Eq. 1's mean aggregation);
    'sym' → D^{-1/2} A D^{-1/2}; 'none' → raw adjacency.
    """
    n = graph.num_nodes
    # lcm padding so both row and col blocks divide
    lcm = int(np.lcm(block_m, block_n))
    n_pad = int(np.ceil(n / lcm)) * lcm
    assert n_pad % block_m == 0 and n_pad % block_n == 0 and n_pad >= n
    src, dst = graph.to_edges()
    deg = np.maximum(graph.degrees(), 1).astype(np.float32)
    if normalization == "mean":
        vals = 1.0 / deg[src]
    elif normalization == "sym":
        vals = 1.0 / np.sqrt(deg[src] * deg[dst])
    elif normalization == "none":
        vals = np.ones_like(src, dtype=np.float32)
    else:
        raise ValueError(normalization)

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
_KERNEL = None


def _kernel():
    """The ctypes entry of ``csrc/spmm_bcsr.cu``, built at first use."""
    global _KERNEL
    if _KERNEL is None:
        fn = build.load("spmm_bcsr").spmm_bcsr_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


def spmm_bcsr(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """Â @ H over the BCSR layout; returns ``(n_row_blocks·8, D)`` f32.

    ``h`` may hold fewer rows than the column blocks cover (the rest read as
    zero).  CPU tensors take the plain version; CUDA tensors launch the
    kernel, counted in ``spmm_bcsr.launches``.
    """
    n_rb, max_t, bm, bn = tile_vals.shape
    if tile_cols.shape != (n_rb, max_t):
        raise ValueError(f"tile_cols {tuple(tile_cols.shape)} does not match "
                         f"tile_vals {tuple(tile_vals.shape)}")
    if h.dim() != 2:
        raise ValueError(f"h must be (rows, D), got {tuple(h.shape)}")
    if h.device.type == "cpu":
        n_cb = max(-(-h.shape[0] // bn), int(tile_cols.max()) + 1)
        hp = torch.nn.functional.pad(h.float(),
                                     (0, 0, 0, n_cb * bn - h.shape[0]))
        return spmm_bcsr_ref(tile_cols, tile_vals, hp)
    if h.device.type != "cuda":
        raise ValueError(f"spmm_bcsr runs on cpu or cuda, not {h.device}")
    if (bm, bn) != (BLOCK_M, BLOCK_N):
        raise ValueError(f"the CUDA kernel takes {BLOCK_M}x{BLOCK_N} tiles, "
                         f"got {bm}x{bn}")
    if (tile_cols.dtype, tile_vals.dtype, h.dtype) != (
            torch.int32, torch.float32, torch.float32):
        raise ValueError("spmm_bcsr takes int32 tile_cols and float32 "
                         f"tile_vals/h, got {tile_cols.dtype}/"
                         f"{tile_vals.dtype}/{h.dtype}")
    if not (tile_cols.device == tile_vals.device == h.device):
        raise ValueError("tile_cols, tile_vals and h must share a device")
    tile_cols = tile_cols.contiguous()
    tile_vals = tile_vals.contiguous()
    h = h.contiguous()
    n_h, d = h.shape
    out = torch.empty((n_rb * bm, d), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            tile_cols.data_ptr(), tile_vals.data_ptr(), h.data_ptr(),
            out.data_ptr(), n_rb, max_t, n_h, d, stream)
    if err != 0:
        raise RuntimeError(f"spmm_bcsr kernel launch failed (cudaError {err})")
    spmm_bcsr.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU path never counts).
spmm_bcsr.launches = 0
