"""The paper's own experimental configurations (Table 2), as synthetic
analogs.

The real datasets (Flickr/Reddit/OGB-*/Yelp) are not available offline, so
each entry pairs the paper's *base architecture string* and training
hyper-parameters with a synthetic SBM generator scaled to reproduce the
dataset's qualitative regime (graph-dependence via feature SNR, degree via
avg_degree, κ via homophily).  ``make_paper_setting(name)`` returns
(dataset, model, DistConfig) ready for any plan in repro_torch.core.plan.

| key          | base arch (Table 2) | regime                                |
|--------------|----------------------|---------------------------------------|
| flickr       | BSBSBL               | moderate graph dependence              |
| ogb-proteins | SSS                  | dense, multilabelish → high degree     |
| ogb-arxiv    | GBGBG                | citation-like, strong homophily        |
| reddit       | SBSBS                | graph-critical (big PSGD-PA gap)       |
| yelp         | BSBSBL               | feature-sufficient (no PSGD-PA gap)    |
| ogb-products | GGG                  | tiny train fraction, small κ           |
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.plan import DistConfig
from repro_torch.graph.datasets import SyntheticDataset, sbm_graph
from repro_torch.models.gnn.model import GNNModel, build_model


@dataclasses.dataclass(frozen=True)
class PaperSetting:
    key: str
    base_arch: str
    num_nodes: int
    num_classes: int
    feature_dim: int
    avg_degree: float
    homophily: float
    feature_snr: float
    rounds: int
    local_k: int
    correction_steps: int


SETTINGS = {
    "flickr": PaperSetting("flickr", "BSBSBL", 600, 7, 32, 10, 0.85, 0.5,
                           10, 4, 1),
    "ogb-proteins": PaperSetting("ogb-proteins", "SSS", 600, 8, 8, 30, 0.8,
                                 0.4, 10, 4, 2),
    "ogb-arxiv": PaperSetting("ogb-arxiv", "GBGBG", 700, 10, 24, 12, 0.9,
                              0.3, 10, 4, 1),
    "reddit": PaperSetting("reddit", "SBSBS", 800, 8, 32, 25, 0.95, 0.1,
                           10, 4, 2),
    "yelp": PaperSetting("yelp", "BSBSBL", 600, 6, 32, 14, 0.85, 2.5,
                         8, 4, 0),
    "ogb-products": PaperSetting("ogb-products", "GGG", 800, 8, 16, 20,
                                 0.9, 0.6, 8, 4, 1),
}


def make_paper_setting(key: str, num_machines: int = 8, seed: int = 0
                       ) -> Tuple[SyntheticDataset, GNNModel, DistConfig]:
    s = SETTINGS[key]
    data = sbm_graph(num_nodes=s.num_nodes, num_classes=s.num_classes,
                     feature_dim=s.feature_dim, avg_degree=s.avg_degree,
                     homophily=s.homophily, feature_snr=s.feature_snr,
                     seed=seed, name=key)
    model = build_model(s.base_arch, data.feature_dim, data.num_classes,
                        hidden_dim=64)
    cfg = DistConfig(num_machines=num_machines, rounds=s.rounds,
                     local_k=s.local_k, correction_steps=s.correction_steps,
                     batch_size=32, server_batch_size=64, fanout=10,
                     lr=1e-2, partition_method="random", seed=seed)
    return data, model, cfg
