"""The vectorised SBM: its shape, and its law against the port's
``sbm_graph`` at a small size."""
import numpy as np
import pytest
import torch

from llcg_bench.sbm import csr_from_edges, sbm

ARGS = dict(num_nodes=3000, num_classes=5, feature_dim=8, avg_degree=6.0,
            homophily=0.9, feature_snr=0.5)


def _stats(indptr, indices, labels, feats, n_classes):
    src = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    within = float(np.mean(labels[src] == labels[indices]))
    means = np.stack([feats[labels == c].mean(0) for c in range(n_classes)])
    return indices.size / (indptr.size - 1), within, float(np.std(means))


def test_counts_and_csr_form():
    g = sbm(seed=3, **ARGS)
    assert g.num_nodes == 3000 and g.features.shape == (3000, 8)
    assert g.features.dtype == np.float32 and g.labels.dtype == np.int32
    src = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    assert not np.any(src == g.indices)                    # no self loop
    key = src * g.num_nodes + g.indices
    assert np.all(np.diff(key) > 0)                 # sorted, no duplicate
    back = np.sort(g.indices.astype(np.int64) * g.num_nodes + src)
    assert np.array_equal(back, key)                       # undirected
    # about N x avg_degree undirected edges (a few duplicates dropped)
    assert 0.9 * 3000 * 6 <= g.num_edges / 2 <= 3000 * 6.1
    parts = np.concatenate([g.train_nodes, g.val_nodes, g.test_nodes])
    assert np.array_equal(np.sort(parts), np.arange(3000))
    assert g.train_nodes.size == 1800 and g.val_nodes.size == 600


def test_same_seed_same_graph():
    a, b = sbm(seed=11, **ARGS), sbm(seed=11, **ARGS)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.features, b.features)


def test_law_matches_the_ports_generator():
    from repro_torch.graph.datasets import sbm_graph
    mine = [_stats(g.indptr, g.indices, g.labels, g.features, 5)
            for g in (sbm(seed=s, **ARGS) for s in (1, 2))]
    port = []
    for s in (1, 2):
        d = sbm_graph(seed=s, **ARGS)
        port.append(_stats(d.graph.indptr, d.graph.indices, d.labels,
                           d.features, 5))
    for (dm, wm, sm), (dp, wp, sp) in zip(mine, port):
        assert dm == pytest.approx(dp, rel=0.03)       # mean degree
        assert wm == pytest.approx(wp, abs=0.02)       # within-class share
        assert sm == pytest.approx(sp, rel=0.35)       # class-mean spread


def test_csr_from_edges_symmetrises_and_dedups():
    ip, ix = csr_from_edges(4, torch.tensor([0, 1, 1, 2]),
                            torch.tensor([1, 0, 1, 3]))
    assert ip.tolist() == [0, 1, 2, 3, 4]
    assert ix.tolist() == [1, 0, 3, 2]
