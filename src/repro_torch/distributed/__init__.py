"""Distributed runtime of the port: the GNN engine device-per-machine.

* :mod:`repro_torch.distributed.gnn_sharded` — :class:`ShardedGNNConfig`
  and :class:`ShardedGNNTrainer`, the plan API's ``shard_map`` backend on
  one process per machine (:mod:`repro_torch.launch.mesh`).

The LM half of the JAX package's ``distributed/`` (``steps.py``,
``sharding.py``) comes with the transformer training step (ROADMAP Queue 1
item 13.4).
"""
from repro_torch.distributed.gnn_sharded import (SHARDED_MODES,
                                                 ShardedGNNConfig,
                                                 ShardedGNNTrainer)

__all__ = ["SHARDED_MODES", "ShardedGNNConfig", "ShardedGNNTrainer"]
