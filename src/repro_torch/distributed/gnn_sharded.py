"""Sharded GNN LLCG/GGS: the paper's workload with one process per machine.

The port of the JAX package's ``distributed/gnn_sharded.py``: the plan
API's ``shard_map`` backend bound to one *process per machine*.
:class:`ShardedGNNConfig` lowers to the SAME
:class:`repro_torch.core.plan.TrainPlan` the simulation runs (``llcg`` →
``local_steps + averaging + correction``, ``ggs`` → ``halo_exchange``) and
:class:`ShardedGNNTrainer` is :func:`repro_torch.core.plan.build_trainer`
with ``backend="shard_map"`` on a :class:`~repro_torch.launch.mesh.
MachineMesh`:

* each rank holds its own machine's padded features, labels and sampled
  tables (drawn on the device with ``sampler_placement="device"``),
* ``mode="llcg"``: the K local steps run rank-local with no communication
  — the cut edges are already dropped from the local tables, exactly the
  paper's local phase — and the parameter average is the only
  inter-machine collective; the lead rank runs the S server-correction
  steps on the full graph and broadcasts the corrected parameters,
* ``mode="ggs"``: every step all-gathers the cut-node features described
  by a :class:`~repro_torch.graph.halo.HaloProgram` before the per-step
  gradient all-reduce, so GGS's per-step halo traffic is real collective
  bytes.

Any composition the plan API expresses runs device-per-machine too: pass a
ready-made plan via ``ShardedGNNTrainer(..., plan=...)``.  Without a
``mesh`` the trainer starts its own group of ``num_machines`` ranks
(:func:`~repro_torch.launch.mesh.launch_machines`), this process being
the lead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.engine import History
from repro_torch.core.plan import (
    CommSpec, CompileSpec, LocalSpec, SamplerSpec, ScheduleSpec, ServerSpec,
    TrainPlan, averaging, build_trainer, correction, halo_exchange,
    local_steps,
)
from repro_torch.graph.datasets import SyntheticDataset
from repro_torch.graph.partition import PARTITION_METHODS
from repro_torch.launch.mesh import MachineMesh, launch_machines
from repro_torch.models.gnn.model import GNNModel

SHARDED_MODES = ("llcg", "ggs")


@dataclasses.dataclass
class ShardedGNNConfig:
    num_machines: int = 4          # ranks of the machine group
    rounds: int = 8
    local_k: int = 4
    correction_steps: int = 1
    batch_size: int = 16
    server_batch_size: int = 32
    fanout: int = 8
    lr: float = 1e-2
    server_lr: float = 1e-2
    partition_method: str = "bfs"
    mode: str = "llcg"             # "llcg" (Alg. 2) | "ggs" (halo exchange)
    sampler_placement: str = "host"  # "device" = on-device round draws
                                     # overlapped with the previous round
    checkpoint_dir: Optional[str] = None  # per-round params export
    seed: int = 0

    def __post_init__(self):
        if self.mode not in SHARDED_MODES:
            raise ValueError(f"unknown mode {self.mode!r}; "
                             f"choose one of {SHARDED_MODES}")
        if self.partition_method not in PARTITION_METHODS:
            raise ValueError(
                f"unknown partition_method {self.partition_method!r}; "
                f"choose one of {PARTITION_METHODS}")
        self.to_plan()  # spec construction validates the remaining fields

    def to_plan(self) -> TrainPlan:
        """Lower this config to the canned plan its ``mode`` names."""
        phases = ((halo_exchange(),) if self.mode == "ggs"
                  else (local_steps(), averaging(), correction()))
        return TrainPlan(
            phases=phases,
            local=LocalSpec(local_k=self.local_k, batch_size=self.batch_size,
                            lr=self.lr, optimizer="adam"),
            server=ServerSpec(correction_steps=self.correction_steps,
                              server_batch_size=self.server_batch_size,
                              server_lr=self.server_lr),
            comm=CommSpec(num_machines=self.num_machines,
                          partition_method=self.partition_method),
            sampler=SamplerSpec(fanout=self.fanout,
                                placement=self.sampler_placement),
            schedule=ScheduleSpec(rounds=self.rounds),
            compile=CompileSpec(),
            name=self.mode, seed=self.seed,
            checkpoint_dir=self.checkpoint_dir)


def _run_machine(mesh: MachineMesh, data, model, plan) -> History:
    return build_trainer(data, model, plan, backend="shard_map",
                         mesh=mesh).run()


class ShardedGNNTrainer:
    """LLCG/GGS with one process per machine — the plan's shard_map
    backend.

    With ``mesh`` (this process's :class:`MachineMesh`) every rank
    constructs the trainer and calls :meth:`run`; without one, :meth:`run`
    starts ``num_machines`` ranks on ``device`` itself and returns the lead
    rank's result.
    """

    def __init__(self, data: SyntheticDataset, model: GNNModel,
                 cfg: ShardedGNNConfig, mesh: Optional[MachineMesh] = None,
                 plan: Optional[TrainPlan] = None, device="cuda"):
        self.data, self.model, self.cfg = data, model, cfg
        self.mesh, self.device = mesh, device
        self.plan = plan if plan is not None else cfg.to_plan()
        if self.plan.comm.num_machines != cfg.num_machines:
            raise ValueError(
                f"plan.comm.num_machines={self.plan.comm.num_machines} does "
                f"not match the machine group ({cfg.num_machines})")
        if mesh is not None and mesh.size != cfg.num_machines:
            raise ValueError(f"the mesh has {mesh.size} ranks, the config "
                             f"{cfg.num_machines} machines")
        self.history: Optional[History] = None

    def run(self) -> Dict:
        """Run the plan; returns the legacy metrics dict (full History in
        :attr:`history`)."""
        if self.mesh is not None:
            hist = _run_machine(self.mesh, self.data, self.model, self.plan)
        else:
            hist = launch_machines(_run_machine, self.cfg.num_machines,
                                   self.data, self.model, self.plan,
                                   device=self.device)
        self.history = hist
        out = {"local_loss": hist.meta["local_loss"],
               "corr_loss": hist.meta["corr_loss"],
               "val_score": hist.val_score,
               "final_params": hist.meta["final_params"]}
        if "exchange_bytes_per_step" in hist.meta:
            out["exchange_bytes_per_step"] = hist.meta[
                "exchange_bytes_per_step"]
        return out
