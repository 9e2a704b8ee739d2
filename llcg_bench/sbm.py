"""A stochastic-block-model generator that draws on the device.

The semantics of the port's ``sbm_graph`` (labels uniform over the
classes; each node draws a Poisson(``avg_degree``) number of out-edges, at
least one; each edge stays inside the node's class with probability
``homophily``, its target then uniform over that class, else uniform over
all nodes; the edges made undirected without self loops or duplicates;
features the class mean, scaled by ``feature_snr``, plus unit noise; a
60/20/20 train/validation/test split), drawn with whole-tensor calls from
a ``torch.Generator`` on ``device`` and handed back as host arrays.  The
streams differ from the port's, so the graphs are alike in law, not equal;
one seed gives one graph on a given device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    """An undirected graph in CSR form with node data (host arrays)."""

    indptr: np.ndarray          # (N+1,) int64
    indices: np.ndarray         # (E,) int32, sorted within each row
    features: np.ndarray        # (N, d) float32
    labels: np.ndarray          # (N,) int32
    train_nodes: np.ndarray     # int64, in the order of the draw
    val_nodes: np.ndarray
    test_nodes: np.ndarray
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])


def csr_from_edges(n: int, src: torch.Tensor, dst: torch.Tensor
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Undirected CSR of the edge list: both directions, no self loops, no
    duplicates, neighbors sorted within each row."""
    src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])          # sorted
    rows = torch.div(key, n, rounding_mode="floor")
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return indptr, (key - rows * n).to(torch.int32)


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(
        int(seed) & 0xFFFF_FFFF_FFFF_FFFF)


def sbm(num_nodes: int, num_classes: int, feature_dim: int,
        avg_degree: float, homophily: float, feature_snr: float,
        seed: int, device="cpu", feature_seed: int = None) -> Graph:
    """The graph's labels, edges and split from ``seed``; its features from
    ``feature_seed`` (``seed`` when not given)."""
    dev = torch.device(device)
    gen = _generator(seed, dev)
    n, c = int(num_nodes), int(num_classes)
    i64 = dict(dtype=torch.int64, device=dev)
    labels = torch.randint(0, c, (n,), generator=gen, **i64)
    deg = torch.poisson(torch.full((n,), float(avg_degree), device=dev),
                        generator=gen).long().clamp_min(1)
    src = torch.repeat_interleave(torch.arange(n, **i64), deg)
    same = torch.rand(src.shape, generator=gen, device=dev) < homophily
    # same-class targets: uniform over the members of the source's class
    order = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=c)
    starts = torch.cumsum(counts, 0) - counts
    cls = labels[src[same]]
    u = torch.rand(cls.shape, generator=gen, device=dev)
    pick = starts[cls] + torch.minimum((u * counts[cls]).long(),
                                       counts[cls] - 1)
    dst = torch.randint(0, n, src.shape, generator=gen, **i64)
    dst[same] = order[pick]
    indptr, indices = csr_from_edges(n, src, dst)
    del src, dst, same
    perm = torch.randperm(n, generator=gen, device=dev)
    fgen = gen if feature_seed is None else _generator(feature_seed, dev)
    means = torch.randn((c, feature_dim), generator=fgen, device=dev) \
        * feature_snr
    feats = torch.randn((n, feature_dim), generator=fgen, device=dev)
    feats += means[labels]
    n_tr, n_va = int(0.6 * n), int(0.2 * n)
    host = lambda x: x.cpu().numpy()
    perm = host(perm)
    return Graph(indptr=host(indptr), indices=host(indices),
                 features=host(feats), labels=host(labels.to(torch.int32)),
                 train_nodes=perm[:n_tr], val_nodes=perm[n_tr:n_tr + n_va],
                 test_nodes=perm[n_tr + n_va:], num_classes=c)
