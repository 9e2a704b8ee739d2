"""Preemption-safe entry points for plan-API (GNN) runs — the port of
``resume`` and ``run_or_resume`` from the JAX package's ``launch/train.py``.

The LM pre-training driver of that module (``train`` / ``TrainConfig``)
comes with the transformer training step (ROADMAP Queue 1 item 13.4).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.engine import History
from repro_torch.core.plan import TrainPlan, build_trainer


def resume(data, model, plan: TrainPlan, ckpt_dir: Optional[str] = None,
           step: Optional[int] = None, backend: str = "vmap",
           device="cuda", mesh=None) -> History:
    """Resume a checkpointed :class:`~repro_torch.core.plan.TrainPlan` run
    on ``device``.

    Restores the latest VALID checkpoint (or ``step``) under ``ckpt_dir``
    (default: ``plan.checkpoint.dir``) — params, optimizer states, comm
    residual, RNG and uniform streams, schedule cursor, History — and
    continues training mid-schedule.  Refuses checkpoints whose plan or
    dataset digest does not match.  Returns the completed ``History``.
    """
    if ckpt_dir is None:
        if plan.checkpoint is None:
            raise ValueError("resume needs a checkpoint directory: pass "
                             "ckpt_dir= or set plan.checkpoint")
        ckpt_dir = plan.checkpoint.dir
    trainer = build_trainer(data, model, plan, backend=backend,
                            device=device, mesh=mesh)
    return trainer.run(resume_from=ckpt_dir, resume_step=step)


def run_or_resume(data, model, plan: TrainPlan, backend: str = "vmap",
                  device="cuda", mesh=None) -> History:
    """Resume if a valid checkpoint exists, else run from the start.

    The idempotent form a preemptible job wants: the SAME command line
    works for the first launch and every relaunch after a kill
    (:mod:`repro_torch.checkpoint.chaos` drives it under SIGKILL).
    Requires ``plan.checkpoint``.  Under ``backend="shard_map"`` every rank
    calls it with its ``mesh``; each restores its own machine's slice of
    the lead rank's checkpoint.
    """
    if plan.checkpoint is None:
        raise ValueError("run_or_resume requires plan.checkpoint "
                         "(a CheckpointSpec)")
    have = CheckpointManager(plan.checkpoint.dir, keep=0,
                             async_=False).latest_step()
    trainer = build_trainer(data, model, plan, backend=backend,
                            device=device, mesh=mesh)
    if have is None:
        return trainer.run()
    return trainer.run(resume_from=plan.checkpoint.dir)
