"""Empirical estimators for the quantities in Theorems 1 & 2 (the JAX
package's ``core/theory.py``).

Section 4.1 defines the local-global gradient discrepancy κ² = κ²_A + κ²_X:

  κ²_A = max_p ‖∇L_p^local(θ) − ∇L_p^full(θ)‖²   (cut-edges ignored)
  κ²_X = max_p ‖∇L_p^full(θ)  − ∇L(θ)‖²          (feature heterogeneity)

and Assumption 1 bounds the neighbor-sampling bias/variance σ²_bias, σ²_var.
:func:`estimate_discrepancies` computes all four at a given θ from
full-batch gradients under the three neighbor views of Figure 3 (local:
machine p's subgraph, cut-edges dropped; full: machine p's nodes with full
neighbors and global X; global: all nodes).

The gradients run on the device of ``params``; the neighbor tables are
built on the host, each once, and moved there.  The sampling trials draw
from one numpy generator in the reference's order, so the sampled tables
are the reference's, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.graph.csr import build_neighbor_table
from repro_torch.graph.datasets import SyntheticDataset
from repro_torch.graph.partition import Partition
from repro_torch.graph.sampling import sample_neighbors
from repro_torch.models.gnn.model import GNNModel
from repro_torch.utils.pytree import (tree_average, tree_dot, tree_leaves,
                                      tree_sub, tree_unflatten)


@dataclasses.dataclass
class DiscrepancyEstimate:
    kappa_a_sq: float      # κ²_A — cut-edge term
    kappa_x_sq: float      # κ²_X — heterogeneity term
    sigma_bias_sq: float   # neighbor-sampling bias (Assumption 1)
    sigma_var_sq: float    # mini-batch variance (Assumption 1)

    @property
    def kappa_sq(self) -> float:
        return self.kappa_a_sq + self.kappa_x_sq


def _full_batch_grad(model: GNNModel, params, feats, table, mask, labels,
                     nodes) -> Dict:
    """∇ of the mean cross-entropy over ``nodes``, taken on detached
    copies of the parameter leaves."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    logits = model.apply(tree_unflatten(params, leaves), feats, table, mask)
    idx = nodes.long()
    logp = torch.log_softmax(logits[idx], dim=-1)
    loss = -logp.gather(-1, labels[idx].long()[:, None]).mean()
    return tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))


def _sq_norm(tree) -> float:
    return tree_dot(tree, tree)


def estimate_discrepancies(data: SyntheticDataset, partition: Partition,
                           model: GNNModel, params,
                           fanout: Optional[int] = 10,
                           num_sampling_trials: int = 8,
                           seed: int = 0) -> DiscrepancyEstimate:
    rng = np.random.default_rng(seed)
    device = tree_leaves(params)[0].device
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    P = partition.num_parts
    feats_g = dev(data.features)
    labels_g = dev(data.labels)
    gtab, gmask = (dev(a) for a in build_neighbor_table(data.graph))

    # global gradient ∇L(θ) over training nodes
    train = np.sort(data.train_nodes)
    grad_global = _full_batch_grad(model, params, feats_g, gtab, gmask,
                                   labels_g, dev(train))

    kappa_a, kappa_x, bias_terms, var_terms = [], [], [], []
    for p in range(P):
        nodes_p = partition.part_nodes[p]
        o2n = partition.old2new[p]
        g_local = partition.local_graphs[p]
        train_p_global = np.intersect1d(train, nodes_p)
        if train_p_global.size == 0:
            continue

        # --- full view (Eq. 5): machine p nodes, global graph + features
        grad_full = _full_batch_grad(model, params, feats_g, gtab, gmask,
                                     labels_g, dev(train_p_global))
        kappa_x.append(_sq_norm(tree_sub(grad_full, grad_global)))

        # --- local view (Eq. 3): local graph, local features, full local nbrs
        ltab, lmask = (dev(a) for a in build_neighbor_table(g_local))
        feats_p = dev(data.features[nodes_p])
        labels_p = dev(data.labels[nodes_p])
        train_p_local = dev(o2n[train_p_global].astype(np.int32))
        grad_local = _full_batch_grad(model, params, feats_p, ltab, lmask,
                                      labels_p, train_p_local)
        kappa_a.append(_sq_norm(tree_sub(grad_local, grad_full)))

        # --- sampling bias/variance at the local view (Assumption 1)
        fo = fanout if fanout is not None else max(g_local.max_degree(), 1)
        sampled_grads = []
        for _ in range(num_sampling_trials):
            stab, smask = sample_neighbors(
                g_local, np.arange(g_local.num_nodes), fo, rng)
            sampled_grads.append(_full_batch_grad(
                model, params, feats_p, dev(stab), dev(smask), labels_p,
                train_p_local))
        mean_sampled = tree_average(sampled_grads)
        bias_terms.append(_sq_norm(tree_sub(mean_sampled, grad_local)))
        var_terms.append(float(np.mean(
            [_sq_norm(tree_sub(g, mean_sampled)) for g in sampled_grads])))

    return DiscrepancyEstimate(
        kappa_a_sq=float(max(kappa_a)) if kappa_a else 0.0,
        kappa_x_sq=float(max(kappa_x)) if kappa_x else 0.0,
        sigma_bias_sq=float(max(bias_terms)) if bias_terms else 0.0,
        sigma_var_sq=float(max(var_terms)) if var_terms else 0.0,
    )


def theorem1_residual(est: DiscrepancyEstimate) -> float:
    """The irreducible O(κ² + σ²_bias) floor of Theorem 1."""
    return est.kappa_sq + est.sigma_bias_sq


def theorem2_correction_steps(est: DiscrepancyEstimate, g_local: float,
                              g_global: float, k_rho_r: float,
                              lipschitz_term: float = 0.5) -> float:
    """Eq. 54/59: S ≥ (κ²+2σ²_bias − (1−ηL)G_local) · Kρ^r / (G_global(1−γL))."""
    num = est.kappa_sq + 2 * est.sigma_bias_sq - (1 - lipschitz_term) * g_local
    return max(0.0, num * k_rho_r / max(g_global * (1 - lipschitz_term), 1e-12))
