"""GNN model assembly from the paper's architecture strings.

Table 2's "Base Arch." column encodes models as operator strings:
``BSBSBL`` = BatchNorm→SAGE→BatchNorm→SAGE→BatchNorm→Linear, ``GBGBG`` etc.
:func:`build_model` accepts those strings plus the two whole-model variants
``GAT`` and ``APPNP``, and returns a :class:`GNNModel` with ``init`` /
``apply``, the port of the JAX package's ``models/gnn/model.py``.

Parameters are a nested ``dict`` of tensors (``{"sage0": {"w_self": …}}``)
drawn from numpy exactly as the JAX package draws them, so ``init(seed)``
is bit-equal to the reference's.  :meth:`GNNModel.apply` runs one graph;
:meth:`GNNModel.apply_stacked` runs B graphs with B parameter sets stacked
on a leading axis (the machine axis of a local round).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.gnn import layers as L
from repro_torch.utils.pytree import tree_map


def _glorot(rng, shape):
    fan_in, fan_out = shape[0], shape[-1]
    scale = np.sqrt(2.0 / (fan_in + fan_out))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class GNNModel:
    arch: str
    feature_dim: int
    hidden_dim: int
    num_classes: int
    appnp_steps: int = 10
    appnp_beta: float = 0.1
    fused_gat: bool = False   # route GAT aggregation through the kernel
    # default aggregation layout for full-graph consumers (the serving
    # backends read it when not overridden): one of agg.LAYOUTS
    agg_layout: str = "padded"

    def __post_init__(self):
        from repro_torch.models.gnn.agg import LAYOUTS
        if self.agg_layout not in LAYOUTS:
            raise ValueError(f"unknown agg_layout {self.agg_layout!r}; "
                             f"choose one of {LAYOUTS}")

    # ------------------------------------------------------------------ init
    def init_numpy(self, seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
        """The parameters as numpy arrays, drawn in the reference's order."""
        rng = np.random.default_rng(seed)
        params: Dict[str, Dict] = {}
        if self.arch == "GAT":
            d_in, d_h = self.feature_dim, self.hidden_dim
            params["gat0"] = {"w": _glorot(rng, (d_in, d_h)),
                              "a_src": _glorot(rng, (d_h,)),
                              "a_dst": _glorot(rng, (d_h,)),
                              "b": np.zeros(d_h, np.float32)}
            params["gat1"] = {"w": _glorot(rng, (d_h, self.num_classes)),
                              "a_src": _glorot(rng, (self.num_classes,)),
                              "a_dst": _glorot(rng, (self.num_classes,)),
                              "b": np.zeros(self.num_classes, np.float32)}
            return params
        if self.arch == "APPNP":
            d_in, d_h = self.feature_dim, self.hidden_dim
            params["lin0"] = {"w": _glorot(rng, (d_in, d_h)),
                              "b": np.zeros(d_h, np.float32)}
            params["lin1"] = {"w": _glorot(rng, (d_h, self.num_classes)),
                              "b": np.zeros(self.num_classes, np.float32)}
            return params
        for i, (op, (d_in, d_out)) in enumerate(zip(self.arch, self._dims())):
            name = f"{op.lower()}{i}"
            if op == "G":
                params[name] = {"w": _glorot(rng, (d_in, d_out)),
                                "b": np.zeros(d_out, np.float32)}
            elif op == "S":
                params[name] = {"w_self": _glorot(rng, (d_in, d_out)),
                                "w_nbr": _glorot(rng, (d_in, d_out)),
                                "b": np.zeros(d_out, np.float32)}
            elif op == "L":
                params[name] = {"w": _glorot(rng, (d_in, d_out)),
                                "b": np.zeros(d_out, np.float32)}
            elif op == "B":
                params[name] = {"gamma": np.ones(d_in, np.float32),
                                "beta": np.zeros(d_in, np.float32)}
            else:
                raise ValueError(f"unknown op {op!r} in arch {self.arch!r}")
        return params

    def init(self, seed: int = 0, device="cuda") -> Dict:
        """Parameters as tensors on ``device``, bit-equal to the reference's
        ``init(seed)``."""
        return tree_map(lambda a: torch.from_numpy(a).to(device),
                        self.init_numpy(seed))

    def num_message_hops(self) -> int:
        """Graph-aggregation depth L: the receptive field an exact
        partitioned forward must cover (the serving backend sizes its
        inference halo from it).  Linear and BatchNorm ops add nothing."""
        if self.arch == "GAT":
            return 2
        if self.arch == "APPNP":
            return self.appnp_steps
        return sum(1 for op in self.arch if op in ("G", "S"))

    def _dims(self) -> List[Tuple[int, int]]:
        """(d_in, d_out) per op; BatchNorm keeps width."""
        dims = []
        d = self.feature_dim
        changing = [i for i, op in enumerate(self.arch) if op != "B"]
        last = changing[-1] if changing else len(self.arch) - 1
        for i, op in enumerate(self.arch):
            if op == "B":
                dims.append((d, d))
            else:
                d_out = self.num_classes if i == last else self.hidden_dim
                dims.append((d, d_out))
                d = d_out
        return dims

    # ----------------------------------------------------------------- apply
    def apply(self, params: Dict, feats: torch.Tensor, table: torch.Tensor,
              mask: torch.Tensor, agg=None) -> torch.Tensor:
        """Logits (N, C) for every node of one graph.  ``agg`` optionally
        threads prebuilt :class:`repro_torch.models.gnn.agg.AggOperands`
        into every aggregate op; ``None`` is the padded-table path."""
        stacked = tree_map(lambda p: p[None], params)
        return self.apply_stacked(stacked, feats[None], table[None],
                                  mask[None], agg=agg)[0]

    def apply_stacked(self, params: Dict, feats: torch.Tensor,
                      table: torch.Tensor, mask: torch.Tensor,
                      agg=None) -> torch.Tensor:
        """Logits (B, N, C) for B graphs, each with its own parameter set
        (every leaf of ``params`` has a leading B axis)."""
        if self.arch == "GAT":
            h = L.gat_layer(params["gat0"], feats, table, mask,
                            fused=self.fused_gat, agg=agg)
            return L.gat_layer(params["gat1"], h, table, mask,
                               activation=None, fused=self.fused_gat, agg=agg)
        if self.arch == "APPNP":
            h = F.relu(L.linear_layer(params["lin0"], feats))
            h = L.linear_layer(params["lin1"], h)
            return L.appnp_propagate(h, table, mask, self.appnp_steps,
                                     self.appnp_beta, agg=agg)
        h = feats
        changing = [i for i, op in enumerate(self.arch) if op != "B"]
        last = changing[-1] if changing else len(self.arch) - 1
        for i, op in enumerate(self.arch):
            name = f"{op.lower()}{i}"
            act = None if i == last else F.relu
            if op == "G":
                h = L.gcn_layer(params[name], h, table, mask, activation=act,
                                agg=agg)
            elif op == "S":
                h = L.sage_layer(params[name], h, table, mask, activation=act,
                                 agg=agg)
            elif op == "L":
                h = L.linear_layer(params[name], h, activation=act)
            elif op == "B":
                h = L.batch_norm(params[name], h)
        return h


def build_model(arch: str, feature_dim: int, num_classes: int,
                hidden_dim: int = 64, **kw) -> GNNModel:
    return GNNModel(arch=arch, feature_dim=feature_dim, hidden_dim=hidden_dim,
                    num_classes=num_classes, **kw)


def cross_entropy_on_batch(logits: torch.Tensor, labels: torch.Tensor,
                           batch_nodes: torch.Tensor) -> torch.Tensor:
    """(1/B) Σ_{i∈ξ} φ(h_i^{(L)}, y_i) — Eq. 2/4's mini-batch loss."""
    idx = batch_nodes.long()
    logp = torch.log_softmax(logits[idx], dim=-1)
    return -logp.gather(-1, labels[idx].long()[:, None])[:, 0].mean()


def f1_micro(logits: torch.Tensor, labels: torch.Tensor,
             nodes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Micro-F1 for single-label multiclass == accuracy (paper's metric)."""
    if nodes is not None:
        idx = nodes.long()
        logits, labels = logits[idx], labels[idx]
    return (logits.argmax(-1) == labels).float().mean()
