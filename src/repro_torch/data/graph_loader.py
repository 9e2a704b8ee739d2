"""Per-machine graph minibatch loaders.

Binds a :class:`~repro_torch.graph.sampling.NeighborSampler` to each machine's
local subgraph and exposes the two batch kinds the algorithms need:

* ``local_batch()``   — mini-batch over local train nodes with *sampled local*
  neighbors (Eq. 4; cut-edges invisible).
* :func:`sample_round` — one round's worth of every machine's tables and
  batches stacked to ``(P, K, …)``, the input format of the vectorized
  round engine (:mod:`repro_torch.core.engine`).

The server's full-neighbor correction view (Eq. 2) is sampled by the
strategies' context from the full graph directly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.partition import Partition
from repro_torch.graph.sampling import (
    NeighborSampler, sample_minibatch, sample_minibatch_batched,
    sample_round_batched,
)
from repro_torch.graph.datasets import SyntheticDataset


@dataclasses.dataclass
class GraphShardLoader:
    """Loader for one machine p: local features/labels + sampler."""

    machine: int
    features: np.ndarray        # (N_p, d) — local rows only
    labels: np.ndarray          # (N_p,)
    train_nodes: np.ndarray     # local indices
    sampler: NeighborSampler

    def local_batch(self, batch_size: int) -> dict:
        nodes, table, mask = self.sampler.minibatch(self.train_nodes, batch_size)
        return {"nodes": nodes, "table": table, "mask": mask,
                "labels": self.labels[nodes]}

    @property
    def num_nodes(self) -> int:
        return int(self.features.shape[0])


def make_shard_loaders(data: SyntheticDataset, partition: Partition,
                       fanout: Optional[int] = 10,
                       fanout_ratio: Optional[float] = None,
                       seed: int = 0, rng_compat: bool = False
                       ) -> Tuple[List[GraphShardLoader], NeighborSampler]:
    """Build P local loaders + the full-graph (server) sampler."""
    loaders = []
    for p in range(partition.num_parts):
        nodes = partition.part_nodes[p]
        o2n = partition.old2new[p]
        local_train = o2n[np.intersect1d(data.train_nodes, nodes)]
        local_train = local_train[local_train >= 0].astype(np.int64)
        if local_train.size == 0:  # ensure every machine has work
            local_train = np.arange(min(4, nodes.size), dtype=np.int64)
        loaders.append(GraphShardLoader(
            machine=p,
            features=data.features[nodes],
            labels=data.labels[nodes],
            train_nodes=local_train,
            sampler=NeighborSampler(partition.local_graphs[p], fanout=fanout,
                                    fanout_ratio=fanout_ratio, seed=seed + p,
                                    rng_compat=rng_compat),
        ))
    server_sampler = NeighborSampler(data.graph, fanout=None, seed=seed + 10_000,
                                     rng_compat=rng_compat)
    return loaders, server_sampler


def sample_round(loaders: List[GraphShardLoader], num_steps: int,
                 batch_size: int, n_max: int, fanout_pad: int,
                 batch_rng: np.random.Generator, rng_compat: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched host sampling for one engine round: ``(P, K, …)`` stacks.

    Returns ``(tables, masks, batches, bmasks)`` with shapes
    ``(P, K, n_max, fanout_pad)`` / ``(P, K, batch_size)`` — the local-phase
    inputs of :class:`repro_torch.core.engine.RoundProgram`.  Neighbor tables come
    from each machine's own sampler RNG and mini-batches from the shared
    ``batch_rng``, drawn machine-major / step-minor.  The default path draws
    each machine's whole round vectorized; ``rng_compat=True`` replays the
    pre-vectorization stream (step-by-step per-node draws, see
    :mod:`repro_torch.graph.sampling`), so legacy trajectories match exactly.
    """
    P = len(loaders)
    tables = np.zeros((P, num_steps, n_max, fanout_pad), np.int32)
    masks = np.zeros((P, num_steps, n_max, fanout_pad), np.float32)
    batches = np.zeros((P, num_steps, batch_size), np.int32)
    bmasks = np.ones((P, num_steps, batch_size), np.float32)
    for p, ld in enumerate(loaders):
        t, m = sample_round_batched(ld.sampler.graph, num_steps,
                                    ld.sampler.fanout, ld.sampler._rng,
                                    n_pad=n_max, fanout_pad=fanout_pad,
                                    rng_compat=rng_compat)
        tables[p], masks[p] = t, m
        if rng_compat:
            for k in range(num_steps):
                batches[p, k] = sample_minibatch(ld.train_nodes, batch_size,
                                                 batch_rng)
        else:
            batches[p] = sample_minibatch_batched(ld.train_nodes, batch_size,
                                                  num_steps, batch_rng)
    return tables, masks, batches, bmasks
