"""CSR graph container and fixed-shape padded neighbor tables.

Two representations coexist:

1. **CSR** (``indptr``/``indices``) — canonical host-side form, used by the
   partitioners, the samplers and the operands of the SpMM kernel
   (:mod:`repro_torch.kernels.spmm`).
2. **Padded neighbor table** ``(N, max_deg)`` + mask — fixed-shape form used
   by the GNN layers (Eq. 1/3/4 of the paper: mean aggregation over
   ``N(v)`` or the sampled ``Ñ(v)``).

The table form makes the paper's mean-aggregation GCN a dense gather +
masked mean; the SpMM kernel path is the alternative for full-graph
aggregation during server correction.  This module is a numpy-only copy of
the JAX package's ``graph/csr.py``; both must give identical arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """An undirected graph in CSR form.

    Attributes:
      indptr:  (N+1,) int32 — row pointers.
      indices: (E,)  int32 — column indices (neighbors), sorted per row.
      num_nodes: N.
    """

    indptr: np.ndarray
    indices: np.ndarray
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def max_degree(self) -> int:
        d = self.degrees()
        return int(d.max()) if d.size else 0

    def validate(self) -> None:
        assert self.indptr.shape == (self.num_nodes + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.num_edges
        assert np.all(np.diff(self.indptr) >= 0)
        if self.num_edges:
            assert self.indices.min() >= 0 and self.indices.max() < self.num_nodes

    @staticmethod
    def from_edges(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                   symmetrize: bool = True, dedup: bool = True) -> "CSRGraph":
        """Build CSR from an edge list; optionally symmetrize and dedup."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        # drop self loops; GCN adds them explicitly where needed
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if dedup and src.size:
            key = src * num_nodes + dst
            key = np.unique(key)
            src, dst = key // num_nodes, key % num_nodes
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        g = CSRGraph(indptr=indptr.astype(np.int64),
                     indices=dst.astype(np.int32),
                     num_nodes=num_nodes)
        g.validate()
        return g

    def to_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        src = np.repeat(np.arange(self.num_nodes), self.degrees())
        return src.astype(np.int32), self.indices.astype(np.int32)


def neighbor_spans(graph: CSRGraph, nodes: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR spans for ``nodes``: ``(starts, degrees)`` as int64 arrays.

    The building block of every vectorized sampling path: a row's neighbors
    are ``indices[starts[i] : starts[i] + degrees[i]]``, so batched gathers
    become ``starts[:, None] + column_offsets`` with no Python loop.
    """
    nodes = np.asarray(nodes, dtype=np.int64)
    starts = graph.indptr[nodes].astype(np.int64)
    deg = (graph.indptr[nodes + 1].astype(np.int64) - starts)
    return starts, deg


def gather_spans(graph: CSRGraph, starts: np.ndarray,
                 deg: np.ndarray) -> np.ndarray:
    """Concatenate the CSR spans ``indices[starts[i]:starts[i]+deg[i]]``.

    The variable-width companion of :func:`gather_neighbor_rows`: one flat
    gather instead of a per-row Python loop, used by the BFS-style frontier
    expansions (e.g. the L-hop inference halos in the halo module).
    """
    total = int(deg.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    within = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
    offs = np.repeat(starts, deg) + within
    return graph.indices[offs].astype(np.int64)


def gather_neighbor_rows(graph: CSRGraph, nodes: np.ndarray, width: int,
                         pad_value: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized padded neighbor rows: ``(len(nodes), width)`` table + mask.

    One fancy-indexed gather over ``indices`` replaces the per-node Python
    loop; rows with more than ``width`` neighbors are truncated, shorter rows
    are padded (mask 0).  Semantically identical to filling row ``i`` with
    ``graph.neighbors(nodes[i])[:width]``.
    """
    nodes = np.asarray(nodes, dtype=np.int64)
    width = max(int(width), 1)
    n = nodes.size
    if n == 0 or graph.num_edges == 0:
        return (np.full((n, width), pad_value, np.int32),
                np.zeros((n, width), np.float32))
    starts, deg = neighbor_spans(graph, nodes)
    cols = np.arange(width, dtype=np.int64)
    valid = cols[None, :] < np.minimum(deg, width)[:, None]
    # clamp out-of-span columns to the row's last real slot (masked out
    # below); the outer clip keeps zero-degree rows at the array end in range
    gat = starts[:, None] + np.minimum(cols[None, :],
                                       np.maximum(deg - 1, 0)[:, None])
    gat = np.minimum(gat, graph.num_edges - 1)
    table = np.where(valid, graph.indices[gat], pad_value).astype(np.int32)
    return table, valid.astype(np.float32)


def build_neighbor_table(graph: CSRGraph, max_deg: Optional[int] = None,
                         pad_value: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Padded ``(N, max_deg)`` neighbor table + float mask.

    Rows with more than ``max_deg`` neighbors are truncated (callers that need
    exact full-neighbor aggregation pass ``max_deg=None`` to use the true max
    degree). The mask is 1.0 for real neighbors, 0.0 for padding, so the
    paper's mean aggregation is ``(H[table] * mask).sum(1) / mask.sum(1)``.
    """
    deg = graph.degrees()
    md = int(deg.max()) if max_deg is None and deg.size else int(max_deg or 0)
    md = max(md, 1)
    return gather_neighbor_rows(graph, np.arange(graph.num_nodes), md,
                                pad_value=pad_value)


def symmetric_normalizers(graph: CSRGraph) -> np.ndarray:
    """``1/sqrt(deg+1)`` per node — GCN symmetric Laplacian coefficients."""
    deg = graph.degrees().astype(np.float32)
    return 1.0 / np.sqrt(deg + 1.0)


def subgraph_csr(graph: CSRGraph, nodes: np.ndarray) -> Tuple[CSRGraph, np.ndarray]:
    """Induced subgraph over ``nodes``; returns (subgraph, old→new map)."""
    nodes = np.asarray(nodes)
    old2new = -np.ones(graph.num_nodes, dtype=np.int64)
    old2new[nodes] = np.arange(nodes.size)
    src, dst = graph.to_edges()
    keep = (old2new[src] >= 0) & (old2new[dst] >= 0)
    sub = CSRGraph.from_edges(nodes.size, old2new[src[keep]], old2new[dst[keep]],
                              symmetrize=False, dedup=False)
    return sub, old2new
