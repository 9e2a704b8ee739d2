"""The paper's strategies as one-line canned TrainPlans (the JAX package's
``core/strategies.py``).

Algorithm 1 (PSGD-PA), Algorithm 2 (LLCG), the GGS baseline and the
single-machine reference are compositions of the same round-phase
primitives; the ``run_*`` functions here are thin shims that lower the
corresponding canned plan of :mod:`repro_torch.core.plan` through
:func:`~repro_torch.core.plan.build_trainer` on ``device`` (the GPU unless
the caller passes another) and record the flat config in
``hist.meta["cfg"]``.

``_Context`` / ``GGSContext`` are views over the
:class:`~repro_torch.core.plan.RoundSampler` for code that drives the
machines step by step (:mod:`repro_torch.core.subgraph_approx`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.engine import History
from repro_torch.core.plan import (
    DistConfig, RoundSampler, TrainPlan, averaging, build_trainer,
    ggs_plan, llcg_plan, local_steps, psgd_pa_plan, single_machine_plan,
)
from repro_torch.graph.datasets import SyntheticDataset
from repro_torch.models.gnn.model import GNNModel

__all__ = [
    "DistConfig", "History", "run_psgd_pa", "run_llcg", "run_ggs",
    "run_single_machine",
]


# --------------------------------------------------------------------------
# Views over the RoundSampler
# --------------------------------------------------------------------------
class _Context(RoundSampler):
    """A RoundSampler built from a flat :class:`DistConfig`: partition,
    shard loaders, padded per-machine views, the one-machine step
    (``step``), ``local_batch`` and the full-graph eval tables, with the
    JAX package's RNG draw order."""

    def __init__(self, data: SyntheticDataset, model: GNNModel,
                 cfg: DistConfig, device="cuda"):
        self.cfg = cfg
        super().__init__(data, model,
                         TrainPlan(phases=(local_steps(), averaging()),
                                   seed=cfg.seed, **cfg.specs()),
                         device)


class GGSContext:
    """Extended-graph views over a RoundSampler, under the JAX package's
    attribute names (``plan`` is the :class:`~repro_torch.graph.halo.
    HaloPlan`, ``program`` the :class:`~repro_torch.graph.halo.
    HaloProgram`)."""

    def __init__(self, data: SyntheticDataset, model: GNNModel,
                 cfg: DistConfig, device="cuda"):
        self.data, self.cfg = data, cfg
        self.ctx = _Context(data, model, cfg, device)
        self.ctx.ensure_halo()
        self.plan = self.ctx.halo_plan
        self.program = self.ctx.halo_program
        for attr in ("n_ext_max", "fanout_ext", "ext_feats", "local_feats",
                     "ext_labels", "halo_bytes_per_step",
                     "exchange_bytes_per_step", "halo_inputs"):
            setattr(self, attr, getattr(self.ctx, attr))

    def sample_round_arrays(self, k: int):
        """One GGS round's extended-graph tables + local batches (numpy)."""
        return self.ctx.sample_ext_round(k)


# --------------------------------------------------------------------------
# Canned strategies — each is ONE plan lowered through build_trainer
# --------------------------------------------------------------------------
def _run(data, model, plan: TrainPlan, cfg: DistConfig, device) -> History:
    hist = build_trainer(data, model, plan, device=device).run()
    hist.meta["cfg"] = dataclasses.asdict(cfg)
    return hist


def run_psgd_pa(data: SyntheticDataset, model: GNNModel, cfg: DistConfig,
                device="cuda") -> History:
    """Algorithm 1 — the communication lower bound with the residual error
    (fixed schedule: ``rho`` is forced to 1)."""
    cfg = dataclasses.replace(cfg, rho=1.0)
    return _run(data, model, psgd_pa_plan(cfg), cfg, device)


def run_llcg(data: SyntheticDataset, model: GNNModel, cfg: DistConfig,
             device="cuda") -> History:
    """Algorithm 2 — Learn Locally, Correct Globally."""
    return _run(data, model, llcg_plan(cfg), cfg, device)


def run_ggs(data: SyntheticDataset, model: GNNModel, cfg: DistConfig,
            device="cuda") -> History:
    """Cut-edges respected: the cut-node features are exchanged every step
    (the engine's ``halo`` mode, or the host-materialized halo with
    ``cfg.ggs_host_halo``) and gradients averaged every step."""
    return _run(data, model, ggs_plan(cfg), cfg, device)


def run_single_machine(data: SyntheticDataset, model: GNNModel,
                       cfg: DistConfig, device="cuda") -> History:
    """Centralized training on the full graph with neighbor sampling
    (Eq. 2): one machine, optimizer state kept across rounds."""
    return _run(data, model, single_machine_plan(cfg), cfg, device)
