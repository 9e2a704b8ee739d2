"""Neighbor sampling (Hamilton et al., 2017) — Eq. 4 of the paper, host half.

Local machines compute stochastic gradients on mini-batches with *sampled*
neighbors Ñ_p(v) ⊂ N_p(v); the server correction uses *full* neighbors.
The samplers here are numpy over the CSR arrays and produce fixed-shape
``(B, fanout)`` tables that the port copies to the device once per round.

Two execution paths produce the same *distribution* of tables:

* **vectorized** (default, ``rng_compat=False``) — one span gather + one
  uniform random-keys draw per round (:func:`sample_neighbors_batched`).
  Rows with degree > fanout are subsampled without replacement by ranking
  i.i.d. uniform keys and keeping the ``fanout`` smallest.
* **rng_compat** (``rng_compat=True``) — the original per-node
  ``rng.choice`` loop, reproducing the legacy RNG stream draw for draw.

Both consume ``np.random.Generator`` streams exactly as the JAX package's
host sampler does, so the same seeds give the same tables bit for bit.
The device-resident sampler is not part of this module yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph, gather_neighbor_rows, neighbor_spans

# Bound on the number of uniform keys materialized per vectorized draw
# (steps × oversampled-rows × max-degree); larger rounds chunk the step axis.
_MAX_KEY_ELEMS = 1 << 24


def _sample_neighbors_loop(graph: CSRGraph, nodes: np.ndarray, fanout: int,
                           rng: np.random.Generator
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Legacy per-node loop — the rng_compat reference stream."""
    n = len(nodes)
    table = np.zeros((n, fanout), dtype=np.int32)
    mask = np.zeros((n, fanout), dtype=np.float32)
    for i, v in enumerate(nodes):
        nbrs = graph.neighbors(int(v))
        if nbrs.size == 0:
            continue
        if nbrs.size <= fanout:
            table[i, : nbrs.size] = nbrs
            mask[i, : nbrs.size] = 1.0
        else:
            sel = rng.choice(nbrs, size=fanout, replace=False)
            table[i] = sel
            mask[i] = 1.0
    return table, mask


@dataclasses.dataclass(frozen=True)
class _SamplingPlan:
    """Round-invariant precomputation for one ``(nodes, fanout)`` pair.

    Splitting keep/over rows, gathering the step-invariant keep-row tables
    and building the degree mask depend only on the graph topology, so for
    the hot all-nodes case they are cached on the graph instance and every
    per-round call reduces to one key draw + one argpartition + one gather.
    """

    num_rows: int
    keep_idx: np.ndarray       # rows with degree ≤ fanout (sampled = full)
    keep_table: np.ndarray     # (n_keep, fanout) step-invariant neighbors
    keep_mask: np.ndarray      # (n_keep, fanout)
    over_idx: np.ndarray       # rows with degree > fanout (subsampled)
    over_starts: np.ndarray    # (n_over,) CSR span starts
    over_dmax: int             # max degree among over rows
    over_invalid: np.ndarray   # (n_over, over_dmax) key slots past the span


def _build_sampling_plan(graph: CSRGraph, nodes: np.ndarray,
                         fanout: int) -> _SamplingPlan:
    nodes = np.asarray(nodes, dtype=np.int64)
    starts, deg = neighbor_spans(graph, nodes)
    keep = deg <= fanout
    k_idx = np.where(keep)[0]
    keep_table, keep_mask = gather_neighbor_rows(graph, nodes[k_idx], fanout)
    o_idx = np.where(~keep)[0]
    if o_idx.size:
        o_deg = deg[o_idx]
        dmax = int(o_deg.max())
        invalid = np.arange(dmax)[None, :] >= o_deg[:, None]
    else:
        dmax, invalid = 0, np.zeros((0, 0), bool)
    return _SamplingPlan(num_rows=nodes.size, keep_idx=k_idx,
                         keep_table=keep_table, keep_mask=keep_mask,
                         over_idx=o_idx, over_starts=starts[o_idx],
                         over_dmax=dmax, over_invalid=invalid)


def _all_nodes_plan(graph: CSRGraph, fanout: int) -> _SamplingPlan:
    """Cached :class:`_SamplingPlan` over all of ``graph``'s nodes."""
    cache = graph.__dict__.get("_sampling_plans")
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_sampling_plans", cache)  # frozen dataclass
    plan = cache.get(fanout)
    if plan is None:
        plan = _build_sampling_plan(graph, np.arange(graph.num_nodes), fanout)
        cache[fanout] = plan
    return plan


def sample_neighbors_batched(graph: CSRGraph, nodes: Optional[np.ndarray],
                             fanout: int, rng: np.random.Generator,
                             num_steps: int = 1
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized sampling of ``num_steps`` independent neighbor tables.

    Returns ``(table, mask)`` of shape ``(num_steps, len(nodes), fanout)``.
    Rows with degree ≤ fanout keep their full (step-invariant) neighborhood;
    rows with degree > fanout are subsampled per step without replacement by
    ranking uniform random keys (smallest ``fanout`` of ``degree`` keys — a
    uniform subset).  ``nodes=None`` means all nodes, with the
    round-invariant precomputation cached on the graph.  The step axis is
    chunked so the key matrix never exceeds ``_MAX_KEY_ELEMS`` elements.
    """
    S = int(num_steps)
    fanout = max(int(fanout), 1)
    if nodes is None:
        plan = _all_nodes_plan(graph, fanout)
    else:
        plan = _build_sampling_plan(graph, nodes, fanout)
    n = plan.num_rows
    table = np.zeros((S, n, fanout), np.int32)
    mask = np.zeros((S, n, fanout), np.float32)
    if n == 0 or S == 0 or graph.num_edges == 0:
        return table, mask
    if plan.keep_idx.size:
        table[:, plan.keep_idx] = plan.keep_table[None]
        mask[:, plan.keep_idx] = plan.keep_mask[None]
    if plan.over_idx.size:
        o_idx, dmax = plan.over_idx, plan.over_dmax
        per_chunk = max(1, _MAX_KEY_ELEMS // max(o_idx.size * dmax, 1))
        for s0 in range(0, S, per_chunk):
            s1 = min(S, s0 + per_chunk)
            keys = rng.random((s1 - s0, o_idx.size, dmax))
            keys[:, plan.over_invalid] = np.inf
            sel = np.argpartition(keys, fanout - 1, axis=-1)[..., :fanout]
            table[s0:s1, o_idx] = graph.indices[
                plan.over_starts[None, :, None] + sel]
        mask[:, o_idx] = 1.0
    return table, mask


def sample_neighbors(graph: CSRGraph, nodes: np.ndarray, fanout: int,
                     rng: np.random.Generator, rng_compat: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniformly sample up to ``fanout`` neighbors per node.

    Returns ``(table, mask)`` of shape ``(len(nodes), fanout)``.  Nodes with
    degree ≤ fanout keep all neighbors (mask marks the real ones), matching
    full-neighbor aggregation in the limit fanout → max_deg (σ²_bias → 0).
    ``rng_compat=True`` replays the original per-node ``rng.choice`` stream
    (see module docstring); the default is the vectorized path.
    """
    if rng_compat:
        return _sample_neighbors_loop(graph, nodes, fanout, rng)
    table, mask = sample_neighbors_batched(graph, nodes, fanout, rng,
                                           num_steps=1)
    return table[0], mask[0]


def sample_minibatch(train_nodes: np.ndarray, batch_size: int,
                     rng: np.random.Generator) -> np.ndarray:
    """i.i.d. mini-batch ξ of size B (Eq. 2/4)."""
    replace = batch_size > train_nodes.size
    return rng.choice(train_nodes, size=batch_size, replace=replace)


def sample_minibatch_batched(train_nodes: np.ndarray, batch_size: int,
                             num_steps: int, rng: np.random.Generator
                             ) -> np.ndarray:
    """``num_steps`` stacked mini-batches ``(num_steps, batch_size)``.

    Without replacement within a step when the pool allows it (random-keys
    ranking, one draw for the whole stack), with replacement otherwise —
    the same per-step semantics as :func:`sample_minibatch`.
    """
    tn = np.asarray(train_nodes)
    if batch_size > tn.size:
        return tn[rng.integers(0, tn.size, size=(num_steps, batch_size))]
    keys = rng.random((num_steps, tn.size))
    if batch_size == tn.size:
        idx = np.argsort(keys, axis=1)
    else:
        idx = np.argpartition(keys, batch_size - 1, axis=1)[:, :batch_size]
    return tn[idx]


def sample_round_batched(graph: CSRGraph, num_steps: int, fanout: int,
                         rng: np.random.Generator,
                         n_pad: Optional[int] = None,
                         fanout_pad: Optional[int] = None,
                         rng_compat: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """All of one round's neighbor tables for one graph, stacked on a K axis.

    Returns ``(tables, masks)`` of shape ``(num_steps, n_pad, fanout_pad)``
    — the per-machine slab of the engine's ``(P, K, …)`` round inputs
    (:mod:`repro_torch.core.engine`).  The default path is one vectorized draw for
    the whole round; with ``rng_compat=True`` draws are made step-by-step
    from ``rng`` in the same order as ``num_steps`` sequential
    :func:`sample_neighbors` calls, so pre-refactor RNG streams are
    reproduced exactly.
    """
    n = graph.num_nodes
    n_pad = n if n_pad is None else n_pad
    fanout_pad = fanout if fanout_pad is None else fanout_pad
    tables = np.zeros((num_steps, n_pad, fanout_pad), np.int32)
    masks = np.zeros((num_steps, n_pad, fanout_pad), np.float32)
    nodes = np.arange(n)
    w = min(fanout, fanout_pad)
    if rng_compat:
        for k in range(num_steps):
            t, m = _sample_neighbors_loop(graph, nodes, fanout, rng)
            tables[k, :n, :w] = t[:, :w]
            masks[k, :n, :w] = m[:, :w]
    else:
        t, m = sample_neighbors_batched(graph, None, fanout, rng,
                                        num_steps=num_steps)
        tables[:, :n, :w] = t[..., :w]
        masks[:, :n, :w] = m[..., :w]
    return tables, masks


def sample_serving_tables(graphs, fanout: int, rng: np.random.Generator,
                          n_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """One serving wave's neighbor tables for P per-machine (extended) graphs.

    The inference-time entry point used by the GNN serving backend
    (the serving backend, still to be ported): returns ``(tables, masks)`` stacked
    ``(P, n_pad, fanout)`` — one fixed-shape table per machine over ALL of
    its extended-graph rows, drawn through the vectorized
    :func:`sample_neighbors_batched` path (the cached all-nodes sampling
    plan makes repeated waves cheap).  ``fanout ≥ max degree`` degenerates
    to the full-neighbor table, which is what makes fanout the serving
    accuracy/latency knob: full width reproduces the single-machine forward
    exactly, narrower widths trade σ²_bias for smaller tables.
    """
    P = len(graphs)
    fanout = max(int(fanout), 1)
    tables = np.zeros((P, n_pad, fanout), np.int32)
    masks = np.zeros((P, n_pad, fanout), np.float32)
    for p, g in enumerate(graphs):
        if g.num_nodes > n_pad:
            raise ValueError(f"graph {p} has {g.num_nodes} rows > n_pad "
                             f"{n_pad}")
        t, m = sample_neighbors_batched(g, None, fanout, rng, num_steps=1)
        tables[p, : g.num_nodes] = t[0]
        masks[p, : g.num_nodes] = m[0]
    return tables, masks


@dataclasses.dataclass
class NeighborSampler:
    """Stateful sampler bound to one (sub)graph.

    ``fanout_ratio`` optionally expresses fanout as a fraction of max degree —
    the knob swept in the paper's Figure 6 ("effect of sampling on local
    machine").  ``fanout=None`` + ``ratio=None`` means full neighbors.
    ``rng_compat`` selects the legacy per-node draw stream (module docstring).
    """

    graph: CSRGraph
    fanout: Optional[int] = 10
    fanout_ratio: Optional[float] = None
    seed: int = 0
    rng_compat: bool = False

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.fanout_ratio is not None:
            md = max(self.graph.max_degree(), 1)
            self.fanout = max(1, int(round(self.fanout_ratio * md)))
        if self.fanout is None:
            self.fanout = max(self.graph.max_degree(), 1)

    def minibatch(self, train_nodes: np.ndarray, batch_size: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(batch_nodes, neighbor_table, mask) — one step's ξ with Ñ(v)."""
        batch = sample_minibatch(train_nodes, batch_size, self._rng)
        table, mask = sample_neighbors(self.graph, batch, self.fanout,
                                       self._rng, rng_compat=self.rng_compat)
        return batch.astype(np.int32), table, mask

    def full_neighbor_batch(self, train_nodes: np.ndarray, batch_size: int
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Correction-step batch: uniform ξ with FULL neighbors (Eq. 2)."""
        batch = sample_minibatch(train_nodes, batch_size, self._rng)
        md = max(self.graph.max_degree(), 1)
        table, mask = gather_neighbor_rows(self.graph, batch, md)
        return batch.astype(np.int32), table, mask
