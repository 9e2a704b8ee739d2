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

**Device-resident sampling.**  A third path draws the whole round on the
device: :func:`build_device_csr` stacks padded CSR shards into a
:class:`DeviceCSR` once, and :func:`sample_round_device` /
:func:`sample_serving_tables_device` produce the host paths' fixed-shape
tables from the JAX package's documented ``jax.random`` stream, replayed
bit for bit by :mod:`repro_torch.utils.threefry`:

    round key  = fold_in(base_key, r)                  (caller supplies)
    machine    = fold_in(round_key, p)
    step       = fold_in(machine_key, s)
    neighbors  = bits(fold_in(step_key, 0), (n_pad, dmax))
    batch WOR  = bits(fold_in(step_key, 1), (t_pad,))
    batch WR   = randint(fold_in(step_key, 2), (B,))

so both packages draw identical tables, masks and batches on any device.
Every step folds its own key, so a draw at a K-bucketed padded length
reproduces the unbucketed stream on the real prefix, and a shard holding
one machine (the ``shard_map`` backend's) draws that machine's part of the
stacked draw exactly, given the stack's global ``n_pad``, ``t_pad`` and
``dmax``.  Subsets are uniform without replacement by ranking random keys
with an index tie-break: the reference's two key definitions (pairwise
rank for ``dmax ≤ 128``, stable ``top_k`` above) become one ``int64`` sort
key per slot with the slot index in its low bits, so ``torch.topk`` gives
the reference's order whatever sort the device runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, gather_neighbor_rows, neighbor_spans
from repro_torch.utils import threefry

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


# --------------------------------------------------------------------------
# Device-resident sampling (module docstring, "Device-resident sampling")
# --------------------------------------------------------------------------
#: Widths up to this use the reference's pairwise-rank key definition;
#: wider rows its ``top_k`` one.
_RANK_SELECT_MAX_WIDTH = 128


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """Padded CSR shards + train pools, resident on the device.

    Built once per ``(round kind, fanout)`` by :func:`build_device_csr` and
    reused every round.  Arrays are stacked on a leading shard axis;
    ``machines`` names the global machine index of each shard (the key
    fold), ``range(P)`` for a full stack, ``(p,)`` for the one machine a
    ``shard_map`` rank holds.
    """

    indices: torch.Tensor       # (S, e_pad) int64 — CSR indices, 0-padded
    starts: torch.Tensor        # (S, n_pad) int64 — per-row span starts
    degrees: torch.Tensor       # (S, n_pad) int64 — 0 on padded rows
    train_nodes: torch.Tensor   # (S, t_pad) int64 — per-machine train pools
    train_counts: torch.Tensor  # (S,) int64
    fanouts: torch.Tensor       # (S,) int64 — per-machine effective fanout
    dmax: int                   # max degree over ALL machines (key width)
    machines: Tuple[int, ...]   # global machine index of each shard

    @property
    def num_machines(self) -> int:
        return int(self.starts.shape[0])

    @property
    def n_pad(self) -> int:
        return int(self.starts.shape[1])


def build_device_csr(graphs: Sequence[CSRGraph], n_pad: Optional[int] = None,
                     train_nodes: Optional[Sequence[np.ndarray]] = None,
                     fanouts: Optional[Sequence[int]] = None,
                     t_pad_min: int = 1, device="cuda",
                     machines: Optional[Sequence[int]] = None,
                     dmax: Optional[int] = None) -> DeviceCSR:
    """Stack CSR shards into one :class:`DeviceCSR` on ``device``.

    ``train_nodes`` may be omitted for table-only use (serving);
    ``fanouts`` defaults to full width.  ``t_pad_min`` floors the
    train-pool padding so fixed-size batches can always be gathered.  A
    ``shard_map`` rank passes only its own graph with ``machines=(p,)`` and
    the full stack's ``n_pad``, ``t_pad_min`` (the stack's ``t_pad``) and
    ``dmax``: the bits are drawn at those shapes.
    """
    P = len(graphs)
    if P == 0:
        raise ValueError("build_device_csr needs at least one graph")
    n_pad = max(g.num_nodes for g in graphs) if n_pad is None else int(n_pad)
    e_pad = max(max(g.num_edges for g in graphs), 1)
    pools = ([np.zeros(0, np.int64)] * P if train_nodes is None
             else [np.asarray(t) for t in train_nodes])
    t_pad = max(max(p.size for p in pools), int(t_pad_min), 1)
    if dmax is None:
        dmax = max(max(g.max_degree() for g in graphs), 1)
    fo = [dmax] * P if fanouts is None else [int(f) for f in fanouts]
    machines = tuple(range(P)) if machines is None else tuple(machines)
    if len(machines) != P:
        raise ValueError(f"{len(machines)} machine indices for {P} graphs")

    indices = np.zeros((P, e_pad), np.int64)
    starts = np.zeros((P, n_pad), np.int64)
    degrees = np.zeros((P, n_pad), np.int64)
    tn = np.zeros((P, t_pad), np.int64)
    tc = np.zeros((P,), np.int64)
    for p, g in enumerate(graphs):
        if g.num_nodes > n_pad:
            raise ValueError(f"graph {p} has {g.num_nodes} rows > n_pad "
                             f"{n_pad}")
        if g.max_degree() > dmax:
            raise ValueError(f"graph {p} has degree {g.max_degree()} > "
                             f"dmax {dmax}")
        indices[p, : g.num_edges] = g.indices
        starts[p, : g.num_nodes] = g.indptr[:-1]
        degrees[p, : g.num_nodes] = np.diff(g.indptr)
        tn[p, : pools[p].size] = pools[p]
        tc[p] = pools[p].size
    put = lambda a: torch.from_numpy(a).to(device)
    return DeviceCSR(indices=put(indices), starts=put(starts),
                     degrees=put(degrees), train_nodes=put(tn),
                     train_counts=put(tc),
                     fanouts=put(np.asarray(fo, np.int64)), dmax=int(dmax),
                     machines=machines)


def _rank_select(bits: torch.Tensor, valid: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Indices of the ``width`` smallest keys per row, without replacement,
    in the reference's order (``int64`` ``(…, width)``, zero-padded past
    ``dmax``).

    ``bits (…, dmax)`` are uint32 keys; ``valid`` marks real slots.  For
    ``dmax ≤ 128`` the reference keys valid slots ``((bits >> (1+ib)) <<
    ib) | idx`` and invalid ones ``(1 << 31) | idx``, which are distinct, so
    its pairwise rank is their ascending order.  Above, it keys valid slots
    ``bits >> 1`` and invalid ones ``0xffffffff`` and takes a stable
    ``top_k``: ascending key, lowest index first — the order of the
    ``int64`` key ``key << ib | idx``.  Either way ``topk`` of distinct keys
    is the reference's selection on any device.
    """
    dmax = bits.shape[-1]
    w = min(width, dmax)
    ib = max(int(dmax - 1).bit_length(), 1)
    idx = torch.arange(dmax, dtype=torch.int64, device=bits.device)
    if dmax <= _RANK_SELECT_MAX_WIDTH:
        keys = torch.where(valid, ((bits >> (1 + ib)) << ib) | idx,
                           (1 << 31) | idx)
    else:
        keys = (torch.where(valid, bits >> 1, 0xFFFFFFFF) << ib) | idx
    sel = torch.topk(keys, w, dim=-1, largest=False, sorted=True).indices
    if w < width:
        sel = torch.nn.functional.pad(sel, (0, width - w))
    return sel


def _neighbor_tables(bits: torch.Tensor, dcsr: DeviceCSR, width: int,
                     fanouts: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``(S, G, n_pad, width)`` tables + masks from ``(S, G, n_pad, dmax)``
    bits, G draws per shard (the steps)."""
    col = torch.arange(dcsr.dmax, device=bits.device)
    deg = dcsr.degrees[:, None, :, None]                    # (S, 1, n, 1)
    sel = _rank_select(bits, col < deg, width)              # (S, G, n, w)
    eff = torch.minimum(dcsr.degrees, fanouts[:, None])     # (S, n)
    valid = (torch.arange(width, device=bits.device)
             < eff[:, None, :, None])
    e_pad = dcsr.indices.shape[1]
    gat = (dcsr.starts[:, None, :, None] + sel).clamp(0, e_pad - 1)
    S = dcsr.num_machines
    vals = torch.gather(dcsr.indices, 1, gat.reshape(S, -1)).reshape(
        gat.shape)
    table = torch.where(valid, vals, 0).to(torch.int32)
    return table, valid.expand(table.shape).to(torch.float32).contiguous()


def sample_round_device(dcsr: DeviceCSR, key: threefry.Key, num_steps: int,
                        width: int, batch_size: int):
    """One round's sampled inputs, drawn on the device.

    Returns ``(tables, masks, batches, bmasks)`` shaped like the host
    path's stacks — ``(S, K, n_pad, width)`` / ``(S, K, B)`` — from the
    documented stream (module docstring); ``key`` is the per-round key
    (the caller folds the round index).  Per-machine fanouts narrower than
    ``width`` mask per row via ``dcsr.fanouts``.  Equal to the JAX
    package's ``sample_round_device`` bit for bit.
    """
    dev = dcsr.starts.device
    S, K, B = dcsr.num_machines, int(num_steps), int(batch_size)
    steps = [threefry.fold_in(threefry.fold_in(key, p), s)
             for p in dcsr.machines for s in range(K)]
    bits = threefry.random_bits_many(
        [threefry.fold_in(k, 0) for k in steps], (dcsr.n_pad, dcsr.dmax),
        dev).reshape(S, K, dcsr.n_pad, dcsr.dmax)
    tables, masks = _neighbor_tables(bits, dcsr, width, dcsr.fanouts)
    del bits

    t_pad = dcsr.train_nodes.shape[1]
    count = dcsr.train_counts[:, None, None]                 # (S, 1, 1)
    bbits = threefry.random_bits_many(
        [threefry.fold_in(k, 1) for k in steps], (t_pad,), dev
    ).reshape(S, K, t_pad)
    wor = _rank_select(bbits, torch.arange(t_pad, device=dev) < count, B)
    rep = threefry.randint_many(
        [threefry.fold_in(k, 2) for k in steps], (B,), 0,
        count.clamp_min(1).repeat_interleave(K, 0).reshape(S * K, 1),
        dev).reshape(S, K, B)
    sel = torch.where(count >= B, wor[..., :B], rep)
    batches = torch.gather(dcsr.train_nodes, 1, sel.reshape(S, -1)
                           ).reshape(S, K, B).to(torch.int32)
    bmasks = torch.ones((S, K, B), dtype=torch.float32, device=dev)
    return tables, masks, batches, bmasks


def sample_serving_tables_device(dcsr: DeviceCSR, key: threefry.Key,
                                 width: int):
    """Device-side :func:`sample_serving_tables`: one wave's ``(P, n_pad,
    width)`` tables + masks over P extended graphs, each machine keyed
    ``fold_in(fold_in(key, p), 0)`` — the JAX package's draw, bit for
    bit."""
    steps = [threefry.fold_in(threefry.fold_in(key, p), 0)
             for p in dcsr.machines]
    bits = threefry.random_bits_many(
        [threefry.fold_in(k, 0) for k in steps], (dcsr.n_pad, dcsr.dmax),
        dcsr.starts.device)[:, None]
    fanouts = torch.full_like(dcsr.fanouts, int(width))
    tables, masks = _neighbor_tables(bits, dcsr, width, fanouts)
    return tables[:, 0], masks[:, 0]
