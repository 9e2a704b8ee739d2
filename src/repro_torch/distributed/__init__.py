"""Distributed runtime of the port: the GNN engine device-per-machine, the
LM training steps and their sharded per-rank programs.

* :mod:`repro_torch.distributed.gnn_sharded` — :class:`ShardedGNNConfig`
  and :class:`ShardedGNNTrainer`, the plan API's ``shard_map`` backend on
  one process per machine (:mod:`repro_torch.launch.mesh`).
* :mod:`repro_torch.distributed.steps` — the LLCG round step, the
  synchronous step and the serving steps of the LM trainer
  (:mod:`repro_torch.launch.train`); given a ``DeviceMesh``, each step
  function returns the rank's sharded program.
* :mod:`repro_torch.distributed.sharding` — the JAX package's partition
  rules (``param_pspecs``, ``batch_pspec``) as plain spec tuples, and a
  rank's block under them; :mod:`repro_torch.distributed.hints` — the
  hints the sharded model reads.
* :mod:`repro_torch.distributed.tensor_parallel` — a rank's view of the
  LM's split (``ModelShard``: tensor parallel over ``model``, collectives
  explicit and counted), which the model's own entry points take, as the
  steps and the dry run (:mod:`repro_torch.launch.dryrun`) drive them.
"""
from repro_torch.distributed.gnn_sharded import (SHARDED_MODES,
                                                 ShardedGNNConfig,
                                                 ShardedGNNTrainer)

__all__ = ["SHARDED_MODES", "ShardedGNNConfig", "ShardedGNNTrainer"]
