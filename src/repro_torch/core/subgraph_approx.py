"""Subgraph-approximation baseline (Angerd et al. 2020) — App. A.5, the
JAX package's ``core/subgraph_approx.py``.

Each machine stores, in addition to its own partition, a small sampled
subgraph of the REST of the global graph (10% extra storage, "the maximum
overhead recommended").  Local training then sees an approximation of the
global structure: some cut-edges are restored against the cached remote
nodes, shrinking κ²_A at the cost of storage — but the residual error is
only *reduced*, not eliminated (Fig. 11: subgraph approximation sits
between PSGD-PA and LLCG).

The cached features move ONCE (setup), so the per-round bytes equal
PSGD-PA's (params only); the one-time storage overhead is reported
separately.  Views, tables and batches are built on the host from the
reference's RNG streams; the steps run on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.strategies import DistConfig, History, _Context
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.datasets import SyntheticDataset
from repro_torch.graph.partition import Partition
from repro_torch.graph.sampling import sample_neighbors
from repro_torch.models.gnn.model import GNNModel
from repro_torch.utils.pytree import tree_average


def build_approx_views(data: SyntheticDataset, partition: Partition,
                       overhead: float = 0.10, seed: int = 0):
    """Per machine: (node list incl. cached remotes, extended local graph,
    local node count).

    The cached remote set is degree-biased (high-degree nodes approximate
    the global structure best — Angerd et al.'s sampler); edges are
    restored between (local ∪ cached) nodes only.
    """
    rng = np.random.default_rng(seed)
    deg = data.graph.degrees().astype(np.float64)
    src, dst = data.graph.to_edges()
    views = []
    for p in range(partition.num_parts):
        local = partition.part_nodes[p]
        n_extra = max(1, int(overhead * local.size))
        remote_nodes = np.flatnonzero(partition.assignment != p)
        w = deg[remote_nodes] + 1e-6
        w /= w.sum()
        cached = rng.choice(remote_nodes, size=min(n_extra, remote_nodes.size),
                            replace=False, p=w)
        nodes = np.concatenate([local, np.sort(cached)])
        old2new = -np.ones(data.graph.num_nodes, dtype=np.int64)
        old2new[nodes] = np.arange(nodes.size)
        keep = (old2new[src] >= 0) & (old2new[dst] >= 0)
        g = CSRGraph.from_edges(nodes.size, old2new[src[keep]],
                                old2new[dst[keep]], symmetrize=False,
                                dedup=False)
        views.append((nodes, g, int(local.size)))
    return views


def run_subgraph_approx(data: SyntheticDataset, model: GNNModel,
                        cfg: DistConfig, overhead: float = 0.10,
                        device="cuda") -> History:
    """PSGD-PA over the approximation-extended local graphs."""
    ctx = _Context(data, model, cfg, device)
    dev = ctx._dev
    P = cfg.num_machines
    views = build_approx_views(data, ctx.partition, overhead, cfg.seed)
    n_ext_max = max(nodes.size for nodes, _, _ in views)
    d = data.feature_dim

    feats = np.zeros((P, n_ext_max, d), np.float32)
    labels = np.zeros((P, n_ext_max), np.int32)
    storage_extra = 0
    for p, (nodes, g, n_local) in enumerate(views):
        feats[p, : nodes.size] = data.features[nodes]
        labels[p, : nodes.size] = data.labels[nodes]
        storage_extra += (nodes.size - n_local) * d * 4
    feats_d, labels_d = dev(feats), dev(labels)

    hist = History(strategy="subgraph_approx",
                   meta={"param_bytes": ctx.param_bytes,
                         "storage_overhead_bytes": storage_extra,
                         "overhead": overhead,
                         "cfg": dataclasses.asdict(cfg)})
    global_params = model.init(cfg.seed, device=ctx.device)
    bytes_cum, steps_cum = 0.0, 0
    for r in range(1, cfg.rounds + 1):
        local_params: List = []
        for p in range(P):
            nodes, g, n_local = views[p]
            params_p = global_params
            opt_p = ctx.opt.init(params_p)
            for _ in range(cfg.local_k):
                tab, msk = sample_neighbors(g, np.arange(g.num_nodes),
                                            ctx.fanout, ctx.rng)
                table = np.zeros((n_ext_max, ctx.fanout), np.int32)
                mask = np.zeros((n_ext_max, ctx.fanout), np.float32)
                table[: g.num_nodes, : tab.shape[1]] = tab
                mask[: g.num_nodes, : msk.shape[1]] = msk
                batch, bmask = ctx.local_batch(p)   # local train nodes only
                params_p, opt_p, _ = ctx.step.local_step(
                    params_p, opt_p, feats_d[p], dev(table), dev(mask),
                    dev(batch), labels_d[p], dev(bmask))
                steps_cum += 1
            local_params.append(params_p)
        bytes_cum += 2 * P * ctx.param_bytes
        global_params = tree_average(local_params)
        loss, score = ctx.evaluate(global_params, data.val_nodes)
        hist.rounds.append(r)
        hist.steps_cum.append(steps_cum)
        hist.val_score.append(score)
        hist.train_loss.append(loss)
        hist.bytes_cum.append(bytes_cum)
    hist.meta["final_params"] = global_params
    return hist
