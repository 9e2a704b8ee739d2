"""Small versions of the cells, for the CPU tests: the same files with
their sizes cut, so a run of the harness takes seconds."""
from __future__ import annotations

import copy

from llcg_bench import harness


def gnn_cell(limits=None) -> harness.Cell:
    cell = harness.find_cell("reddit-sage.llcg")
    conf = copy.deepcopy(cell.config)
    conf["graph"].update(num_nodes=1500, feature_dim=24, num_classes=5,
                         avg_degree=6)
    conf["model"]["hidden_dim"] = 16
    return harness.Cell("tiny-gnn", conf, dict(cell.traffic),
                        cell.limits if limits is None else limits, [], [])
