"""End-to-end LM trainer — LLCG over any registered architecture — and
preemption-safe entry points for plan-API (GNN) runs: the port of the JAX
package's ``launch/train.py``.

``train`` implements Algorithm 2 end to end: per round r it runs K·ρ^r
local steps on every LLCG machine (K bucketed to powers of two, as the JAX
package does: the round runs ``k_pow2`` steps), averages, corrects with S
global steps, checkpoints, and logs the byte accounting the paper reports.
On the host mesh the machines are its ``data`` axis (the cards of the
trainer's device type, one CPU), every copy on ``device``, in this one
process.  On a production mesh (``--mesh production`` or
``production-multipod``, a ``DeviceMesh`` over a process group of 256 or 512
ranks that the launcher has started) every rank runs this function and the
sharded round step (:mod:`repro_torch.distributed.steps`): it holds its
blocks of its group's copy, tensor-parallel over ``model``.

Run:  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import History
from repro_torch.core.plan import TrainPlan, build_trainer
from repro_torch.core.schedules import local_epoch_schedule
from repro_torch.data.tokens import TokenDataset, synthetic_corpus
from repro_torch.distributed.steps import (LLCGStepConfig,
                                           build_llcg_round_step)
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import (HostMesh, machine_device,
                                     make_host_mesh, make_production_mesh)
from repro_torch.models.transformer.model import LM
from repro_torch.optim import adamw
from repro_torch.utils.logging import Timer, get_logger
from repro_torch.utils.pytree import tree_map

log = get_logger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    arch: str = "gemma3-1b"
    smoke: bool = True               # reduced config (CPU-friendly)
    rounds: int = 8
    base_k: int = 2                  # K
    rho: float = 1.3                 # ρ
    correction_steps: int = 1        # S
    batch_per_group: int = 4
    seq_len: int = 128
    lr: float = 3e-4
    server_lr: float = 1e-4
    heterogeneity: float = 0.6
    seed: int = 0
    ckpt_dir: Optional[str] = None
    mesh: str = "host"               # host | production | production-multipod
    model_parallel: int = 1
    remat: bool = False              # recompute each block in the backward


def make_mesh(cfg: TrainConfig, device="cuda"):
    """The mesh ``cfg.mesh`` names, as the JAX package's: ``host`` — the
    devices of ``device``'s type split ``data`` × ``model`` by
    ``cfg.model_parallel`` (:func:`~repro_torch.launch.mesh.
    make_host_mesh`, which raises where they do not split); ``production``
    / ``production-multipod`` — the (16, 16) / (2, 16, 16) ``DeviceMesh``
    over the default process group (:func:`~repro_torch.launch.mesh.
    make_production_mesh`, which raises, naming the world size it needs,
    where the group is missing or too small)."""
    if cfg.mesh in ("production", "production-multipod"):
        return make_production_mesh(
            multi_pod=cfg.mesh == "production-multipod",
            device_type=torch.device(device).type)
    if cfg.mesh != "host":
        raise ValueError(f"unknown mesh {cfg.mesh!r}; choose host, "
                         f"production or production-multipod")
    return make_host_mesh(model_parallel=cfg.model_parallel, device=device)


def train(cfg: TrainConfig, device="cuda"):
    """Run ``cfg.rounds`` LLCG rounds on ``device`` (the GPU unless the
    caller passes another).  Returns ``(params_G, metrics)`` as the JAX
    package does: the G copies stacked (G, …) and the last round's
    ``local_loss`` / ``corr_loss``; ``metrics["history"]`` adds one dict a
    round (``round``, ``k``, ``local_loss``, ``corr_loss``, ``seconds``,
    ``comm_mb``, the numbers of the log line).

    On a production mesh every rank of the process group calls it: the
    rank draws only its blocks of the weights (:meth:`LM.init`'s
    ``block``), every rank draws the same corpus and batches from
    ``cfg.seed`` and keeps its blocks of them, and the round is the
    sharded step; ``params_G`` is then the rank's block (its group's copy,
    (1, …)), rank 0 logs, and the ranks of group 0 that hold data shard 0
    checkpoint their blocks of the model under ``ckpt_dir/model<m>``
    (``m`` their ``model`` coordinate).  On the host mesh, ``model`` only
    divides the cards into groups, as the JAX package's host mesh does:
    the copies run unsharded."""
    mesh = make_mesh(cfg, device)
    mcfg = get_smoke_config(cfg.arch) if cfg.smoke else get_config(cfg.arch)
    model = LM(mcfg)
    shapes = model.param_specs()
    if isinstance(mesh, HostMesh):
        G, g_held, device = mesh.shape["data"], mesh.shape["data"], \
            mesh.device
        rank, block, ckpt_dir, step_mesh = 0, None, cfg.ckpt_dir, None
        place = lambda batch, spec: batch
        axes = dict(mesh.shape)
    else:
        axes = sharding.axis_sizes(mesh)
        coord = dict(zip(axes, mesh.get_coordinate()))
        G, g_held = axes[sharding.group_axis_for(mesh)], 1
        rank, step_mesh = dist.get_rank(), mesh
        device = machine_device(device, rank)
        pspec = sharding.param_pspecs(shapes, mcfg, mesh)
        block = lambda path, x: sharding.local_shard(
            x, _at(pspec, path)[_depth(path):], mesh, coord).clone()
        place = lambda batch, spec: sharding.local_shard(batch, spec, mesh,
                                                         coord)
        ckpt_dir = None
        if cfg.ckpt_dir and all(c == 0 for a, c in coord.items()
                                if a != "model"):
            ckpt_dir = os.path.join(cfg.ckpt_dir, f"model{coord['model']}")
    if rank == 0:
        log.info("arch=%s G=%d mesh=%s layers=%d d=%d", mcfg.name, G,
                 axes, mcfg.num_layers, mcfg.d_model)

    corpus = synthetic_corpus(mcfg.vocab_size, num_shards=G,
                              tokens_per_shard=max(cfg.seq_len * 64, 20_000),
                              heterogeneity=cfg.heterogeneity, seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)

    params = model.init(cfg.seed, device, block=block)
    local_opt, server_opt = adamw(cfg.lr), adamw(cfg.server_lr)
    server_state = server_opt.init(params)
    params_G = tree_map(lambda x: x.unsqueeze(0).expand(g_held, *x.shape)
                        .clone(), params)
    del params
    opt_G = local_opt.init(params_G)
    lspec = sharding.batch_pspec(mesh, stacked_group=True, extra_leading=1)
    cspec = sharding.batch_pspec(mesh, extra_leading=1)

    schedule = local_epoch_schedule(cfg.base_k, cfg.rho, cfg.rounds)
    step_cache = {}
    bytes_cum = 0.0
    history = []
    metrics = {}
    for r, k_r in enumerate(schedule, start=1):
        k_pow2 = 1 << (k_r - 1).bit_length()   # bucket K, as the JAX package
        if k_pow2 not in step_cache:
            step_cache[k_pow2] = build_llcg_round_step(
                model, local_opt, server_opt,
                LLCGStepConfig(num_groups=G, local_steps=k_pow2,
                               correction_steps=cfg.correction_steps,
                               remat=cfg.remat),
                mesh=step_mesh)
        round_step = step_cache[k_pow2]

        local = {k: place(v, lspec) for k, v in
                 _local_batches(corpus, G, k_pow2, cfg, rng).items()}
        corr = {k: place(v, cspec) for k, v in
                _corr_batches(corpus, cfg, rng).items()}
        local, corr = _on(local, device), _on(corr, device)
        wire_before = round_step.wire_bytes
        with Timer("lm.round") as t:
            params_G, opt_G, server_state, metrics = round_step(
                params_G, opt_G, server_state, local, corr)
            local_loss = float(metrics["local_loss"])
            corr_loss = float(metrics["corr_loss"])
        bytes_cum += (round_step.wire_bytes - wire_before) / 1e6  # MB
        if rank == 0:
            log.info("round %2d K=%3d local_loss=%.4f corr_loss=%.4f "
                     "%.2fs comm=%.1fMB", r, k_pow2, local_loss, corr_loss,
                     t.elapsed, bytes_cum)
        history.append({"round": r, "k": k_pow2, "local_loss": local_loss,
                        "corr_loss": corr_loss, "seconds": t.elapsed,
                        "comm_mb": bytes_cum})
        if ckpt_dir:
            avg = tree_map(lambda x: x[0], params_G)
            save_checkpoint(ckpt_dir, r, avg,
                            extra={"round": r, "comm_mb": bytes_cum})
    return params_G, dict(metrics, history=history)


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _depth(path: str) -> int:
    """The stacking dims before a leaf's own (``units`` 2, ``rem`` 1)."""
    return {"units": 2, "rem": 1}.get(path.split("/", 1)[0], 0)


def _on(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


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


def _local_batches(corpus: TokenDataset, g: int, k: int, cfg: TrainConfig,
                   rng) -> dict:
    """``{"tokens", "labels"}`` (g, k, batch_per_group, seq_len) int32 CPU
    tensors, each machine's windows drawn from its own shard, with the JAX
    package's draws from ``rng``."""
    toks = np.zeros((g, k, cfg.batch_per_group, cfg.seq_len), np.int32)
    labs = np.zeros_like(toks)
    for s in range(g):
        stream = corpus.tokens[s % corpus.num_shards]
        for i in range(k):
            starts = rng.integers(0, stream.size - cfg.seq_len - 1,
                                  cfg.batch_per_group)
            toks[s, i] = np.stack([stream[a:a + cfg.seq_len] for a in starts])
            labs[s, i] = np.stack([stream[a + 1:a + cfg.seq_len + 1]
                                   for a in starts])
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}


def _corr_batches(corpus: TokenDataset, cfg: TrainConfig, rng) -> dict:
    """``{"tokens", "labels"}`` (S, 2·batch_per_group, seq_len) int32 CPU
    tensors, each row from a shard drawn at random (the server's globally
    mixed batch)."""
    s_steps = cfg.correction_steps
    bsz = cfg.batch_per_group * 2
    toks = np.zeros((s_steps, bsz, cfg.seq_len), np.int32)
    labs = np.zeros_like(toks)
    for i in range(s_steps):
        for b in range(bsz):
            stream = corpus.tokens[rng.integers(corpus.num_shards)]
            a = rng.integers(0, stream.size - cfg.seq_len - 1)
            toks[i, b] = stream[a:a + cfg.seq_len]
            labs[i, b] = stream[a + 1:a + cfg.seq_len + 1]
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}


def parse_args(argv=None) -> "tuple[TrainConfig, str]":
    """Every :class:`TrainConfig` field as ``--field-name`` (booleans take
    1/true/yes), plus ``--device``."""
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainConfig):
        kind = type(f.default) if f.default is not None else str
        flag = f"--{f.name.replace('_', '-')}"
        if kind is bool:
            ap.add_argument(flag, default=f.default,
                            type=lambda s: s.lower() in ("1", "true", "yes"))
        else:
            ap.add_argument(flag, type=kind, default=f.default)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = TrainConfig(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    return cfg, args.device


def main(argv=None):
    cfg, device = parse_args(argv)
    return train(cfg, device=device)


if __name__ == "__main__":
    main()
