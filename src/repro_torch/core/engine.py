"""The LLCG round engine: K local steps on P machines, one parameter
average, S server corrections — the port of the JAX package's
``core/engine.py`` (``backend="vmap"``, ``mode="local"``).

The JAX engine compiles a round into one ``jit`` over a ``lax.scan`` of K
steps with the machines on a ``vmap`` axis.  PyTorch runs eagerly, so the
port executes the same round body directly: the machine axis is a leading
stack axis (:func:`repro_torch.core.machine.make_local_round`), the K and S
steps are Python loops, and averaging is a mean over the stack.  Byte and
step accounting and :class:`History` are shared by every plan.

Round modes ``"sync"`` / ``"halo"`` (GGS) and the compressed averaging
codecs are not ported yet.

**K-bucketing.**  :func:`run_schedule` can pad each round's K to a bucket
length, the tail running as masked no-op steps (``step_valid``).  The
eager port does not recompile per shape, but it keeps the policy so a
bucketed run reproduces the reference's trajectory and accounting, and
:attr:`RoundProgram.num_retraces` counts the distinct round-input shapes —
the programs a compiled engine would build.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.machine import (make_local_round, make_loss_fn,
                                      value_and_grad)
from repro_torch.core.schedules import KBucketing
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.utils.pytree import tree_map


# --------------------------------------------------------------------------
# History — the quantities plotted in the paper (Fig. 4, Table 1)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class History:
    strategy: str
    rounds: List[int] = dataclasses.field(default_factory=list)
    steps_cum: List[int] = dataclasses.field(default_factory=list)
    val_score: List[float] = dataclasses.field(default_factory=list)
    train_loss: List[float] = dataclasses.field(default_factory=list)
    bytes_cum: List[float] = dataclasses.field(default_factory=list)
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def final_score(self) -> float:
        return self.val_score[-1] if self.val_score else float("nan")

    def avg_mb_per_round(self) -> float:
        if not self.bytes_cum:
            return 0.0
        return self.bytes_cum[-1] / max(len(self.rounds), 1) / 1e6


# --------------------------------------------------------------------------
# Engine config / per-round inputs / carried state
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The ported round mode is the JAX engine's ``mode="local"`` on its
    ``vmap`` backend with uncompressed averaging; its other modes, backends
    and codecs are refused by the plan layer (:mod:`repro_torch.core.plan`)
    with the ROADMAP item that brings them."""

    num_machines: int
    with_correction: bool = False  # Alg. 2 lines 13-18
    reset_local_opt: bool = True   # fresh local optimizer each round (line 3)


@dataclasses.dataclass
class RoundInputs:
    """One round's host-sampled data on the device, stacked ``(P, K, …)``.

    ``corr_tables`` is either the static full-neighbor table ``(N, F)`` or,
    for the sampling-at-correction ablation, per-step tables ``(S, N, F)``.
    ``step_valid`` is the K-bucketing validity flag (host floats, 1.0 real /
    0.0 padded step); ``None`` means every step is real.
    """

    tables: Any                    # (P, K, n_max, F) int32
    masks: Any                     # (P, K, n_max, F) f32
    batches: Any                   # (P, K, B) int32
    bmasks: Any                    # (P, K, B) f32
    step_valid: Optional[List[float]] = None
    corr_feats: Any = None         # (N, d) full-graph features
    corr_labels: Any = None        # (N,)
    corr_tables: Any = None        # (N, F) or (S, N, F)
    corr_masks: Any = None
    corr_batches: Any = None       # (S, B_S) int32
    corr_bmasks: Any = None        # (S, B_S) f32
    corr_agg: Any = None           # AggOperands for the correction forward


@dataclasses.dataclass
class EngineState:
    params: Any
    # with reset_local_opt the per-round state is rebuilt inside the round
    # and this is None; otherwise the machines' stacked optimizer state
    local_opt_state: Any
    server_opt_state: Any = None


def _signature(*arrays) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype)) if hasattr(a, "shape")
                 else type(a).__name__ for a in arrays)


# --------------------------------------------------------------------------
# RoundProgram
# --------------------------------------------------------------------------
class RoundProgram:
    """The LLCG round: local phase + averaging (+ corrections)."""

    def __init__(self, model, local_opt: Optimizer,
                 server_opt: Optional[Optimizer], cfg: EngineConfig):
        if cfg.with_correction and server_opt is None:
            raise ValueError("with_correction requires a server optimizer")
        self.model, self.cfg = model, cfg
        self.local_opt, self.server_opt = local_opt, server_opt
        self._local_round = make_local_round(model, local_opt,
                                             reset_opt=cfg.reset_local_opt)
        self._loss_fn = make_loss_fn(model)
        self._round_sigs: set = set()
        self._corr_sigs: set = set()

    @property
    def num_retraces(self) -> int:
        return len(self._round_sigs)

    @property
    def num_corr_retraces(self) -> int:
        return len(self._corr_sigs)

    def init_state(self, params) -> EngineState:
        cfg = self.cfg
        o = None
        if not cfg.reset_local_opt:
            with torch.no_grad():
                stacked = tree_map(
                    lambda x: x[None].repeat(cfg.num_machines,
                                             *([1] * x.dim())), params)
            o = self.local_opt.init(stacked)
        server = (self.server_opt.init(params) if cfg.with_correction
                  else None)
        return EngineState(params=params, local_opt_state=o,
                           server_opt_state=server)

    def _correction(self, params, server_state, inputs: RoundInputs):
        """S server steps on uniform global batches (Alg. 2 lines 13-18)."""
        per_step = inputs.corr_tables.dim() == 3   # sampling-at-correction
        feats = inputs.corr_feats[None]
        labels = inputs.corr_labels[None]
        losses = []
        for s in range(inputs.corr_batches.shape[0]):
            table = inputs.corr_tables[s] if per_step else inputs.corr_tables
            mask = inputs.corr_masks[s] if per_step else inputs.corr_masks
            stacked = tree_map(lambda x: x[None], params)
            loss, grads = value_and_grad(
                self._loss_fn, stacked, feats, table[None], mask[None],
                inputs.corr_batches[s][None], labels,
                inputs.corr_bmasks[s][None], agg=inputs.corr_agg)
            grads = tree_map(lambda g: g[0], grads)
            upd, server_state = self.server_opt.update(grads, server_state,
                                                       params)
            params = apply_updates(params, upd)
            losses.append(loss[0])
        return params, server_state, torch.stack(losses).mean()

    def run_round(self, state: EngineState, feats, labels,
                  inputs: RoundInputs) -> tuple:
        """Execute one full round; returns ``(state, metrics)``."""
        svalid = inputs.step_valid
        if svalid is None:
            svalid = [1.0] * int(inputs.tables.shape[1])
        self._round_sigs.add(_signature(feats, labels, inputs.tables,
                                        inputs.masks, inputs.batches,
                                        inputs.bmasks))
        p_new, o_new, losses = self._local_round(
            state.params, state.local_opt_state, feats, labels,
            inputs.tables, inputs.masks, inputs.batches, inputs.bmasks,
            svalid)
        with torch.no_grad():
            # Alg. 1/2 line 12 — THE inter-machine collective
            params = tree_map(lambda x: x.mean(dim=0), p_new)
            # mean over REAL steps only (masked padding adds 0 to both sums)
            loss = losses.sum() / max(sum(svalid) * losses.shape[1], 1.0)
        # metrics stay device scalars; run_schedule floats them
        metrics = {"local_loss": loss}
        server_state = state.server_opt_state
        # S=0 corrections: skip entirely (a mean over no steps is NaN)
        if (self.cfg.with_correction and inputs.corr_batches is not None
                and inputs.corr_batches.shape[0] > 0):
            self._corr_sigs.add(_signature(
                inputs.corr_feats, inputs.corr_labels, inputs.corr_tables,
                inputs.corr_masks, inputs.corr_batches, inputs.corr_bmasks,
                inputs.corr_agg))
            params, server_state, closs = self._correction(
                params, server_state, inputs)
            metrics["corr_loss"] = closs
        o_carry = None if self.cfg.reset_local_opt else o_new
        return EngineState(params=params, local_opt_state=o_carry,
                           server_opt_state=server_state), metrics


# --------------------------------------------------------------------------
# Schedule loop — byte/step accounting shared by every plan
# --------------------------------------------------------------------------
def pad_inputs_to_bucket(inputs: RoundInputs, k_pad: int) -> RoundInputs:
    """Pad a round's K axis to ``k_pad``, flagging the tail as masked.

    Tables/masks/batches/bmasks are zero-padded along the step axis (zero
    bmasks make the padded losses inert) and ``step_valid`` marks the real
    prefix, so the padded steps execute as optimizer no-ops.
    """
    k = int(inputs.tables.shape[1])
    if inputs.step_valid is not None:
        if k != k_pad:
            raise ValueError(
                f"inputs carry step_valid at K={k} but the bucket length is "
                f"{k_pad}; pre-padded inputs must be sampled at the bucketed "
                "length")
        return inputs
    if k_pad < k:
        raise ValueError(f"bucket length {k_pad} < scheduled K {k}")
    svalid = [1.0] * k + [0.0] * (k_pad - k)
    if k_pad == k:
        return dataclasses.replace(inputs, step_valid=svalid)

    def padk(x):
        return torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 2) + [0, k_pad - k])

    return dataclasses.replace(
        inputs, tables=padk(inputs.tables), masks=padk(inputs.masks),
        batches=padk(inputs.batches), bmasks=padk(inputs.bmasks),
        step_valid=svalid)


def run_schedule(program, init_params, feats, labels,
                 sample_fn: Callable[[int, int], RoundInputs],
                 schedule: List[int],
                 evaluate: Callable[[Any], tuple],
                 name: str,
                 bytes_per_round: Callable[[int, int], float],
                 steps_per_round: Callable[[int, int], int],
                 meta: Optional[Dict] = None,
                 bucketing: Optional[KBucketing] = None) -> History:
    """Run ``schedule[r]`` local steps per round r through the engine.

    ``sample_fn(round, k)`` performs the host-side batched sampling for one
    round; ``evaluate(params) -> (loss, score)`` is the server's full-graph
    validation; ``bytes_per_round(r, k)`` / ``steps_per_round(r, k)``
    encode each plan's communication/step cost so History accounting is
    uniform.  ``program`` is duck-typed (``init_state`` / ``run_round`` /
    ``num_retraces``).  Per-round metrics land in ``meta``: ``local_loss``,
    ``corr_loss`` + ``corr_rounds``, ``masked_steps`` and ``num_retraces``.
    With a ``bucketing`` policy each round's inputs are padded to the
    bucketed K and the tail runs as masked no-op steps; sampling, RNG
    streams and accounting use the REAL K.
    """
    state = program.init_state(init_params)
    hist = History(strategy=name, meta=dict(meta or {}))
    hist.meta.update(local_loss=[], corr_loss=[], corr_rounds=[])
    bytes_cum, steps_cum = 0.0, 0
    for r, k in enumerate(schedule, start=1):
        inputs = sample_fn(r, k)
        if bucketing is not None:
            inputs = pad_inputs_to_bucket(inputs, bucketing.pad_length(k))
        state, metrics = program.run_round(state, feats, labels, inputs)
        hist.meta["local_loss"].append(float(metrics["local_loss"]))
        if "corr_loss" in metrics:
            hist.meta["corr_loss"].append(float(metrics["corr_loss"]))
            hist.meta["corr_rounds"].append(r)
        bytes_cum += bytes_per_round(r, k)
        steps_cum += steps_per_round(r, k)
        loss, score = evaluate(state.params)
        hist.rounds.append(r)
        hist.steps_cum.append(steps_cum)
        hist.val_score.append(score)
        hist.train_loss.append(loss)
        hist.bytes_cum.append(bytes_cum)
    hist.meta["final_params"] = state.params
    hist.meta["num_retraces"] = program.num_retraces
    hist.meta["num_corr_retraces"] = getattr(program, "num_corr_retraces", 0)
    if bucketing is not None:
        hist.meta["bucket_lengths"] = bucketing.bucket_lengths(schedule)
        hist.meta["masked_steps"] = bucketing.masked_steps(schedule)
    else:
        hist.meta["masked_steps"] = 0
    hist.meta["distinct_k"] = len(set(schedule))
    return hist
