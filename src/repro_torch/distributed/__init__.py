"""Distributed runtime of the port: the GNN engine device-per-machine and
the LM training steps.

* :mod:`repro_torch.distributed.gnn_sharded` — :class:`ShardedGNNConfig`
  and :class:`ShardedGNNTrainer`, the plan API's ``shard_map`` backend on
  one process per machine (:mod:`repro_torch.launch.mesh`).
* :mod:`repro_torch.distributed.steps` — the LLCG round step, the
  synchronous step and the serving steps of the LM trainer
  (:mod:`repro_torch.launch.train`).

The JAX package's ``sharding.py`` (GSPMD partition rules) comes with the
production meshes and the dry run (ROADMAP Queue 1 item 14): on one card
nothing would read its specs.
"""
from repro_torch.distributed.gnn_sharded import (SHARDED_MODES,
                                                 ShardedGNNConfig,
                                                 ShardedGNNTrainer)

__all__ = ["SHARDED_MODES", "ShardedGNNConfig", "ShardedGNNTrainer"]
