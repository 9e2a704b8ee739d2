"""Synthetic graph datasets with *planted, structure-dependent* labels.

The paper's experiments use Reddit/Flickr/OGB; those are not available
offline, so we generate graphs where the quantity that matters to LLCG —
the local-global gradient discrepancy κ² — is controllable:

* :func:`sbm_graph` — stochastic block model.  Labels = blocks.  The feature
  signal-to-noise ratio ``feature_snr`` decides how much classification must
  rely on neighborhood aggregation: low SNR ⇒ the model *needs* the graph ⇒
  ignoring cut-edges hurts (the Reddit regime of Figure 4); high SNR ⇒ MLP
  suffices (the Yelp regime of Figure 10, where PSGD-PA ≈ GGS).
* :func:`rmat_graph` — power-law graph (recursive matrix), stresses degree
  bucketing in the SpMM kernel and the samplers.
* :func:`grid_graph` — 2-D torus, near-zero cut under BFS partitioning
  (the OGB-Products "small κ" regime of Figure 10(c)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class SyntheticDataset:
    graph: CSRGraph
    features: np.ndarray        # (N, d) float32
    labels: np.ndarray          # (N,) int32
    train_nodes: np.ndarray
    val_nodes: np.ndarray
    test_nodes: np.ndarray
    num_classes: int
    name: str = "synthetic"

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])


def _split(n: int, rng: np.random.Generator, train: float = 0.6, val: float = 0.2):
    perm = rng.permutation(n)
    n_tr, n_va = int(train * n), int(val * n)
    return perm[:n_tr], perm[n_tr : n_tr + n_va], perm[n_tr + n_va :]


def sbm_graph(num_nodes: int = 1024, num_classes: int = 8, feature_dim: int = 32,
              avg_degree: float = 12.0, homophily: float = 0.9,
              feature_snr: float = 0.5, seed: int = 0,
              name: str = "sbm") -> SyntheticDataset:
    """Stochastic block model with Gaussian class-mean features.

    ``homophily`` is the fraction of a node's edges that stay inside its
    block.  ``feature_snr`` scales the class-mean separation relative to the
    noise; at snr≈0.5 a linear model on raw features is weak and the GNN must
    aggregate neighbors — that is where cut-edges (and hence LLCG's
    correction) matter.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    # --- edges: sample per-node degree, pick within/cross class endpoints
    deg = np.maximum(1, rng.poisson(avg_degree, size=num_nodes))
    src_list, dst_list = [], []
    nodes_by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for v in range(num_nodes):
        c = labels[v]
        k = deg[v]
        same = rng.random(k) < homophily
        n_same = int(same.sum())
        if nodes_by_class[c].size > 1 and n_same:
            tgt = rng.choice(nodes_by_class[c], size=n_same)
            src_list.append(np.full(n_same, v)); dst_list.append(tgt)
        n_cross = k - n_same
        if n_cross:
            tgt = rng.integers(0, num_nodes, size=n_cross)
            src_list.append(np.full(n_cross, v)); dst_list.append(tgt)
    src = np.concatenate(src_list); dst = np.concatenate(dst_list)
    graph = CSRGraph.from_edges(num_nodes, src, dst)
    # --- features: class means + noise
    means = rng.standard_normal((num_classes, feature_dim)) * feature_snr
    feats = means[labels] + rng.standard_normal((num_nodes, feature_dim))
    feats = feats.astype(np.float32)
    tr, va, te = _split(num_nodes, rng)
    return SyntheticDataset(graph=graph, features=feats, labels=labels,
                            train_nodes=tr, val_nodes=va, test_nodes=te,
                            num_classes=num_classes, name=name)


def rmat_graph(num_nodes: int = 1024, num_edges: int = 8192, num_classes: int = 8,
               feature_dim: int = 32, a: float = 0.57, b: float = 0.19,
               c: float = 0.19, seed: int = 0, feature_snr: float = 0.7,
               name: str = "rmat") -> SyntheticDataset:
    """R-MAT power-law graph (Chakrabarti et al.).  Labels from degree+noise."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(num_nodes)))
    n = 1 << scale
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for lvl in range(scale):
        r = rng.random(num_edges)
        # quadrant probabilities a,b,c,d
        right = r >= a + b          # c+d quadrants → src bit 1
        down = ((r >= a) & (r < a + b)) | (r >= a + b + c)  # b or d → dst bit 1
        src |= right.astype(np.int64) << lvl
        dst |= down.astype(np.int64) << lvl
    src %= num_nodes
    dst %= num_nodes
    graph = CSRGraph.from_edges(num_nodes, src, dst)
    deg = graph.degrees()
    q = np.quantile(deg, np.linspace(0, 1, num_classes + 1)[1:-1])
    labels = np.digitize(deg, q).astype(np.int32)
    means = rng.standard_normal((num_classes, feature_dim)) * feature_snr
    feats = (means[labels] + rng.standard_normal((num_nodes, feature_dim))).astype(np.float32)
    tr, va, te = _split(num_nodes, rng)
    return SyntheticDataset(graph=graph, features=feats, labels=labels,
                            train_nodes=tr, val_nodes=va, test_nodes=te,
                            num_classes=num_classes, name=name)


def grid_graph(side: int = 32, num_classes: int = 4, feature_dim: int = 16,
               seed: int = 0, name: str = "grid") -> SyntheticDataset:
    """2-D torus; labels = spatial quadrant blocks (smooth over the graph)."""
    rng = np.random.default_rng(seed)
    n = side * side
    vs = np.arange(n)
    x, y = vs % side, vs // side
    right = (x + 1) % side + y * side
    up = x + ((y + 1) % side) * side
    src = np.concatenate([vs, vs])
    dst = np.concatenate([right, up])
    graph = CSRGraph.from_edges(n, src, dst)
    k = int(np.sqrt(num_classes))
    k = max(k, 1)
    labels = ((x * k) // side + k * ((y * k) // side)).astype(np.int32)
    labels %= num_classes
    means = rng.standard_normal((num_classes, feature_dim))
    feats = (means[labels] + 0.8 * rng.standard_normal((n, feature_dim))).astype(np.float32)
    tr, va, te = _split(n, rng)
    return SyntheticDataset(graph=graph, features=feats, labels=labels,
                            train_nodes=tr, val_nodes=va, test_nodes=te,
                            num_classes=num_classes, name=name)


_FACTORIES = {"sbm": sbm_graph, "rmat": rmat_graph, "grid": grid_graph}


def make_dataset(kind: str, **kwargs) -> SyntheticDataset:
    if kind not in _FACTORIES:
        raise ValueError(f"unknown dataset kind {kind!r}; choose {sorted(_FACTORIES)}")
    return _FACTORIES[kind](**kwargs)
