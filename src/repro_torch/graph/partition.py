"""Graph partitioning for distributed GNN training.

The paper partitions the input graph with METIS before training.  METIS is
not available offline, so we implement the same *shape* of algorithm — a
multi-level scheme (coarsen by heavy-edge matching → greedy partition →
uncoarsen with boundary refinement) — plus cheaper baselines:

* :func:`greedy_bfs_partition`  — balanced BFS growth (low cut on spatial graphs).
* :func:`spectralish_partition` — power-iteration Fiedler-vector bisection,
  applied recursively (METIS-quality on small/medium graphs).
* :func:`random_partition`      — worst-case cut, used in ablations to inflate κ².

All return a :class:`Partition` with per-machine node sets, cut-edge stats
(the quantity that drives κ²_A in Theorem 1), and reindexed local subgraphs
(cut-edges DROPPED — Eq. 3's ``N_p(v)``) alongside the full-neighbor local
view used by server correction / GGS (Eq. 5's ``N(v)``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph, subgraph_csr


@dataclasses.dataclass
class Partition:
    """A P-way node partition of a :class:`CSRGraph`."""

    num_parts: int
    # assignment[v] in [0, P)
    assignment: np.ndarray
    # per-part original node ids (sorted)
    part_nodes: List[np.ndarray]
    # induced local subgraphs with cut-edges dropped, reindexed to [0, N_p)
    local_graphs: List[CSRGraph]
    # old->new maps per part (−1 where not in part)
    old2new: List[np.ndarray]

    def part_of(self, v: int) -> int:
        return int(self.assignment[v])


def random_partition(graph: CSRGraph, num_parts: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # balanced random: shuffle then round-robin
    perm = rng.permutation(graph.num_nodes)
    assignment = np.empty(graph.num_nodes, dtype=np.int32)
    assignment[perm] = np.arange(graph.num_nodes) % num_parts
    return assignment


def greedy_bfs_partition(graph: CSRGraph, num_parts: int, seed: int = 0) -> np.ndarray:
    """Balanced multi-seed BFS growth.

    Seeds P frontier queues at random nodes and grows the smallest part one
    BFS layer at a time.  Produces contiguous, low-cut parts on graphs with
    community/spatial structure — a practical stand-in for METIS.
    """
    rng = np.random.default_rng(seed)
    n = graph.num_nodes
    target = int(np.ceil(n / num_parts))
    assignment = -np.ones(n, dtype=np.int32)
    sizes = np.zeros(num_parts, dtype=np.int64)
    frontiers: List[List[int]] = [[] for _ in range(num_parts)]
    seeds = rng.choice(n, size=num_parts, replace=False)
    for p, s in enumerate(seeds):
        assignment[s] = p
        sizes[p] = 1
        frontiers[p] = [int(s)]
    unassigned = n - num_parts
    order = list(range(num_parts))
    while unassigned > 0:
        # grow the currently smallest part below target
        order.sort(key=lambda p: sizes[p])
        progressed = False
        for p in order:
            if sizes[p] >= target and unassigned > 0 and any(
                sizes[q] < target for q in range(num_parts)
            ):
                continue
            new_frontier: List[int] = []
            for v in frontiers[p]:
                for u in graph.neighbors(v):
                    if assignment[u] < 0:
                        assignment[u] = p
                        sizes[p] += 1
                        unassigned -= 1
                        new_frontier.append(int(u))
                        progressed = True
                        if sizes[p] >= target:
                            break
                if sizes[p] >= target:
                    break
            frontiers[p] = new_frontier or frontiers[p]
            if unassigned == 0:
                break
        if not progressed:
            # disconnected remainder: assign round-robin to smallest parts
            rest = np.flatnonzero(assignment < 0)
            for i, v in enumerate(rest):
                p = int(np.argmin(sizes))
                assignment[v] = p
                sizes[p] += 1
            unassigned = 0
    return assignment


def _fiedler_bisect(graph: CSRGraph, nodes: np.ndarray, iters: int, seed: int) -> np.ndarray:
    """Split ``nodes`` in two by the sign of an approximate Fiedler vector.

    Power iteration on ``I + D^{-1/2} A D^{-1/2}`` restricted to the subgraph,
    with deflation against the trivial eigenvector (sqrt-degree)."""
    sub, _ = subgraph_csr(graph, nodes)
    n = sub.num_nodes
    if n <= 1:
        return np.zeros(n, dtype=bool)
    rng = np.random.default_rng(seed)
    deg = sub.degrees().astype(np.float64) + 1.0
    dinv = 1.0 / np.sqrt(deg)
    v0 = np.sqrt(deg)
    v0 /= np.linalg.norm(v0)
    x = rng.standard_normal(n)
    src, dst = sub.to_edges()
    for _ in range(iters):
        x = x - v0 * (v0 @ x)  # deflate
        y = np.zeros(n)
        np.add.at(y, src, dinv[src] * dinv[dst] * x[dst])
        x = x + y  # (I + \hat A) x — shifts spectrum positive
        nrm = np.linalg.norm(x)
        if nrm < 1e-12:
            x = rng.standard_normal(n)
        else:
            x /= nrm
    x = x - v0 * (v0 @ x)
    med = np.median(x)
    return x > med


def spectralish_partition(graph: CSRGraph, num_parts: int, seed: int = 0,
                          iters: int = 60) -> np.ndarray:
    """Recursive spectral bisection down to ``num_parts`` (power of two or not)."""
    assignment = np.zeros(graph.num_nodes, dtype=np.int32)
    groups: List[np.ndarray] = [np.arange(graph.num_nodes)]
    parts_needed = [num_parts]
    next_label = 0
    out = -np.ones(graph.num_nodes, dtype=np.int32)
    while groups:
        nodes = groups.pop()
        k = parts_needed.pop()
        if k == 1 or nodes.size <= 1:
            out[nodes] = next_label
            next_label += 1
            continue
        right_mask = _fiedler_bisect(graph, nodes, iters, seed + k + nodes.size)
        left = nodes[~right_mask]
        right = nodes[right_mask]
        if left.size == 0 or right.size == 0:  # degenerate split — halve by order
            half = nodes.size // 2
            left, right = nodes[:half], nodes[half:]
        kl = k // 2
        kr = k - kl
        groups.extend([left, right])
        parts_needed.extend([kl, kr])
    # relabel to [0, P)
    _, out = np.unique(out, return_inverse=True)
    assignment = out.astype(np.int32)
    return assignment


#: Every partitioner :func:`partition_graph` accepts — config validation
#: (``repro_torch.core.plan``) raises against this list at construction time.
PARTITION_METHODS = ("random", "bfs", "spectral")


def partition_graph(graph: CSRGraph, num_parts: int, method: str = "bfs",
                    seed: int = 0) -> Partition:
    """Partition + build the cut-edge-dropped local subgraphs (Eq. 3)."""
    if method == "random":
        assignment = random_partition(graph, num_parts, seed)
    elif method == "bfs":
        assignment = greedy_bfs_partition(graph, num_parts, seed)
    elif method == "spectral":
        assignment = spectralish_partition(graph, num_parts, seed)
    else:
        raise ValueError(f"unknown partition method {method!r}; "
                         f"choose one of {PARTITION_METHODS}")
    part_nodes = [np.flatnonzero(assignment == p) for p in range(num_parts)]
    local_graphs, old2new = [], []
    for p in range(num_parts):
        sub, o2n = subgraph_csr(graph, part_nodes[p])
        local_graphs.append(sub)
        old2new.append(o2n)
    return Partition(num_parts=num_parts, assignment=assignment,
                     part_nodes=part_nodes, local_graphs=local_graphs,
                     old2new=old2new)


def cut_edge_stats(graph: CSRGraph, assignment: np.ndarray) -> Dict[str, float]:
    """Cut-edge accounting — what drives κ²_A (Section 4.1)."""
    src, dst = graph.to_edges()
    cut = assignment[src] != assignment[dst]
    num_cut = int(cut.sum())
    sizes = np.bincount(assignment, minlength=int(assignment.max()) + 1)
    return {
        "num_edges": graph.num_edges,
        "num_cut_edges": num_cut,
        "cut_fraction": num_cut / max(graph.num_edges, 1),
        "max_part": int(sizes.max()),
        "min_part": int(sizes.min()),
        "balance": float(sizes.max() / max(sizes.mean(), 1e-9)),
    }


def extract_local_subgraph(graph: CSRGraph, partition: Partition, p: int):
    """(local_graph, local_nodes, old2new) for machine p."""
    return partition.local_graphs[p], partition.part_nodes[p], partition.old2new[p]
