"""The LLCG round engine: K local steps on P machines, one parameter
average, S server corrections — the port of the JAX package's
``core/engine.py`` (``backend="vmap"``).

The JAX engine compiles a round into one ``jit`` over a ``lax.scan`` of K
steps with the machines on a ``vmap`` axis.  PyTorch runs eagerly, so the
port executes the same round bodies directly: the machine axis is a leading
stack axis (:func:`repro_torch.core.machine.make_local_round`), the K and S
steps are Python loops, and averaging is a mean over the stack.  Byte and
step accounting and :class:`History` are shared by every plan.

Three round modes cover every strategy in the paper:

* ``mode="local"`` — Alg. 1/2: K independent local steps per machine, then
  parameter averaging (+ optional S corrections).  With a ``compression``
  codec each machine's parameter delta is quantized and dequantized
  (:mod:`repro_torch.comm.compress`) before the mean, and ``int8_ef``
  carries the per-machine error-feedback residual.
* ``mode="sync"``  — every step averages the machines' gradients at one
  shared set of parameters before a single update, on host-materialized
  extended features (GGS with ``host_halo``).
* ``mode="halo"``  — GGS with its cut-node exchange executed: every step
  splices the machines' halo rows out of the gathered send buffers
  (:func:`repro_torch.core.machine.halo_fill`, index tables from
  :class:`repro_torch.graph.halo.HaloProgram`), then does the sync-mode
  gradient averaging.  With ``halo_compression`` the send buffer is
  quantized once per round (features are static within a round).

In ``sync`` and ``halo`` modes the optimizer state is one unstacked state
that persists across rounds.

**K-bucketing.**  :func:`run_schedule` can pad each round's K to a bucket
length, the tail running as masked no-op steps (``step_valid``).  The
eager port does not recompile per shape, but it keeps the policy so a
bucketed run reproduces the reference's trajectory and accounting, and
:attr:`RoundProgram.num_retraces` counts the distinct round-input shapes —
the programs a compiled engine would build.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import TraceCounter, trace_signature
from repro_torch.comm.compress import (UniformStream, check_compression,
                                       compress_features, compress_tree,
                                       decompress_features, decompress_tree)
from repro_torch.core.machine import (halo_fill, make_local_round,
                                      make_loss_fn, value_and_grad)
from repro_torch.core.schedules import KBucketing
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          masked_update)
from repro_torch.utils.pytree import tree_leaves, tree_map


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

    def to_json(self) -> Dict:
        """JSON-able snapshot for checkpoint manifests.

        ``meta`` entries that do not serialize are dropped (the resuming
        trainer rebuilds them); the per-round series are kept verbatim —
        JSON round-trips Python floats exactly, which keeps ``bytes_cum``
        accumulation bit-identical across a resume.  The lists are the
        History's own: take a copy (``json.dumps``) before the next round
        appends to them.
        """
        meta = {}
        for k, v in self.meta.items():
            try:
                json.dumps(v)
            except (TypeError, ValueError):
                continue
            meta[k] = v
        return {"strategy": self.strategy, "rounds": list(self.rounds),
                "steps_cum": list(self.steps_cum),
                "val_score": list(self.val_score),
                "train_loss": list(self.train_loss),
                "bytes_cum": list(self.bytes_cum), "meta": meta}

    @classmethod
    def from_json(cls, d: Dict) -> "History":
        return cls(strategy=d["strategy"], rounds=list(d["rounds"]),
                   steps_cum=list(d["steps_cum"]),
                   val_score=list(d["val_score"]),
                   train_loss=list(d["train_loss"]),
                   bytes_cum=list(d["bytes_cum"]), meta=dict(d["meta"]))


# --------------------------------------------------------------------------
# Engine config / per-round inputs / carried state
# --------------------------------------------------------------------------
MODES = ("local", "sync", "halo")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX engine's config on its ``vmap`` backend (the only ported
    one; the plan layer refuses ``shard_map`` with its ROADMAP item)."""

    num_machines: int
    mode: str = "local"            # "local" (Alg. 1/2) | "sync" | "halo" (GGS)
    with_correction: bool = False  # Alg. 2 lines 13-18
    reset_local_opt: bool = True   # fresh local optimizer each round (line 3)
    # payload codecs (repro_torch.comm.compress): `compression` applies to
    # the averaging of mode="local", `halo_compression` to the exchange of
    # mode="halo"; each is ignored by the modes it doesn't name
    compression: str = "none"
    halo_compression: str = "none"
    comm_seed: int = 0             # seed of the stochastic-rounding uniforms


@dataclasses.dataclass
class RoundInputs:
    """One round's host-sampled data on the device, stacked ``(P, K, …)``.

    ``corr_tables`` is either the static full-neighbor table ``(N, F)`` or,
    for the sampling-at-correction ablation, per-step tables ``(S, N, F)``.
    ``step_valid`` is the K-bucketing validity flag (host floats, 1.0 real /
    0.0 padded step); ``None`` means every step is real.  The four
    ``halo_*`` tables are the :class:`repro_torch.graph.halo.HaloProgram`
    index arrays driving ``mode="halo"``; required there, ignored otherwise.
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
    halo_send_idx: Any = None      # (P, max_send) int32
    halo_recv_idx: Any = None      # (P, max_halo) int32
    halo_dest_idx: Any = None      # (P, max_halo) int32
    halo_recv_valid: Any = None    # (P, max_halo) f32


@dataclasses.dataclass
class EngineState:
    params: Any
    # mode="local" with reset_local_opt: None (the per-round state is
    # rebuilt inside the round); mode="local" otherwise: the machines'
    # stacked state; modes "sync"/"halo": the one shared state
    local_opt_state: Any
    server_opt_state: Any = None
    # compression="int8_ef": per-machine error-feedback residual, a params
    # tree stacked (P, …).  None for every other codec.
    comm_residual: Any = None


def _masked_mean(losses: torch.Tensor, svalid) -> torch.Tensor:
    """Mean of ``(K, …)`` step losses over REAL steps only (masked padding
    adds 0 to both sums)."""
    per_step = losses[0].numel()           # machines sharing a step
    return losses.sum() / max(sum(svalid) * per_step, 1.0)


# --------------------------------------------------------------------------
# RoundProgram
# --------------------------------------------------------------------------
class RoundProgram:
    """One engine round: the mode's local phase + averaging (+ corrections).

    ``uniforms`` builds the stochastic-rounding source from ``comm_seed``
    (default :class:`repro_torch.comm.compress.UniformStream`); tests pass
    one that replays the JAX package's draws.
    """

    def __init__(self, model, local_opt: Optimizer,
                 server_opt: Optional[Optimizer], cfg: EngineConfig,
                 uniforms: Callable[[int], Any] = UniformStream):
        if cfg.mode not in MODES:
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.with_correction and server_opt is None:
            raise ValueError("with_correction requires a server optimizer")
        check_compression(cfg.compression)
        check_compression(cfg.halo_compression, halo=True)
        self.model, self.cfg = model, cfg
        self.local_opt, self.server_opt = local_opt, server_opt
        self._comp = cfg.compression if cfg.mode == "local" else "none"
        self._halo_comp = (cfg.halo_compression if cfg.mode == "halo"
                           else "none")
        self._ef = self._comp == "int8_ef"
        self._uniforms = (uniforms(cfg.comm_seed)
                          if self._comp in ("int8", "int8_ef") else None)
        self._local_round = make_local_round(model, local_opt,
                                             reset_opt=cfg.reset_local_opt)
        self._loss_fn = make_loss_fn(model)
        # distinct round / correction input signatures over the RUN (not
        # the process): a resumed process does not re-count shapes the
        # pre-crash process already saw
        self._round_traces = TraceCounter()
        self._corr_traces = TraceCounter()

    @property
    def num_retraces(self) -> int:
        return self._round_traces.count_value

    @property
    def num_corr_retraces(self) -> int:
        return self._corr_traces.count_value

    def trace_state(self) -> Dict:
        """JSON-able retrace position (for exact resume).  The signatures
        are the port's own (shapes and dtypes of the round's tensors), not
        the JAX package's jit trace signatures."""
        return {"round": self._round_traces.snapshot(),
                "corr": self._corr_traces.snapshot()}

    def restore_trace_state(self, snap: Dict) -> None:
        self._round_traces.restore(snap["round"])
        self._corr_traces.restore(snap["corr"])

    @property
    def uniforms(self):
        """The stochastic-rounding source (None without an int8 codec)."""
        return self._uniforms

    def init_state(self, params) -> EngineState:
        cfg, P = self.cfg, self.cfg.num_machines
        o = None
        if cfg.mode != "local":
            o = self.local_opt.init(params)
        elif not cfg.reset_local_opt:
            with torch.no_grad():
                stacked = tree_map(
                    lambda x: x[None].repeat(P, *([1] * x.dim())), params)
            o = self.local_opt.init(stacked)
        server = (self.server_opt.init(params) if cfg.with_correction
                  else None)
        residual = None
        if self._ef:
            residual = tree_map(
                lambda x: torch.zeros((P,) + tuple(x.shape), dtype=x.dtype,
                                      device=x.device), params)
        if self._uniforms is not None:
            self._uniforms.reset()   # restart the stochastic-rounding draws
        return EngineState(params=params, local_opt_state=o,
                           server_opt_state=server, comm_residual=residual)

    # ------------------------------------------------------------ mode local
    def _round_local(self, state: EngineState, feats, labels,
                     inputs: RoundInputs, svalid):
        """K local steps per machine, then the (compressed) average."""
        p_new, o_new, losses = self._local_round(
            state.params, state.local_opt_state, feats, labels,
            inputs.tables, inputs.masks, inputs.batches, inputs.bmasks,
            svalid)
        residual = state.comm_residual
        with torch.no_grad():
            loss = _masked_mean(losses, svalid)
            if self._comp == "none":
                # Alg. 1/2 line 12 — THE inter-machine collective
                params = tree_map(lambda x: x.mean(dim=0), p_new)
            else:
                # each machine compresses its param DELTA; the average is
                # over the dequantized deltas — what every machine gets
                # from the exchange of compressed payloads — and under EF
                # the quantization error stays on the machine
                delta = tree_map(lambda a, b: a - b, p_new, state.params)
                if self._ef:
                    delta = tree_map(torch.add, delta, residual)
                u = None
                if self._uniforms is not None:
                    u = self._uniforms.draw(
                        self.cfg.num_machines,
                        [x[0].numel() for x in tree_leaves(delta)],
                        loss.device)
                payload, scales = compress_tree(delta, self._comp, u=u,
                                                stacked=True)
                deq = decompress_tree(payload, scales, self._comp)
                params = tree_map(lambda p0, d: p0 + d.mean(dim=0),
                                  state.params, deq)
                if self._ef:
                    residual = tree_map(torch.sub, delta, deq)
        o_carry = None if self.cfg.reset_local_opt else o_new
        return params, o_carry, loss, residual

    # ------------------------------------------------- modes sync and halo
    def _round_sync(self, state: EngineState, feats, labels,
                    inputs: RoundInputs, svalid):
        """Per-step gradient averaging across machines sharing one set of
        parameters (GGS); in halo mode each step first fills the halo rows
        from the exchanged send buffers."""
        P = self.cfg.num_machines
        halo = self.cfg.mode == "halo"
        if halo:
            tabs = (inputs.halo_send_idx, inputs.halo_recv_idx,
                    inputs.halo_dest_idx, inputs.halo_recv_valid)
            if any(t is None for t in tabs):
                raise ValueError("mode='halo' requires the halo_* index "
                                 "tables in RoundInputs (see "
                                 "repro_torch.graph.halo.HaloProgram)")
            send_idx, recv_idx, dest_idx, recv_valid = tabs
            rows = torch.arange(P, device=feats.device)[:, None]
            flat = (send_idx.numel(), feats.shape[-1])

            def send_buffer():
                return feats[rows, send_idx.long()].reshape(flat)

            if self._halo_comp != "none":
                # the send buffer is compressed ONCE per round (features are
                # static); every machine sees the dequantized gather
                payload, scales = compress_features(send_buffer(),
                                                    self._halo_comp)
                gathered_comp = decompress_features(payload, scales,
                                                    self._halo_comp)
        p, o = state.params, state.local_opt_state
        losses = []
        for k, valid in enumerate(svalid):
            step_feats = feats
            if halo:
                # the exchange: what the all-gather hands every machine
                gathered = (send_buffer() if self._halo_comp == "none"
                            else gathered_comp)
                step_feats = halo_fill(feats, gathered, recv_idx, dest_idx,
                                       recv_valid)
            with torch.no_grad():
                stacked = tree_map(
                    lambda x: x[None].repeat(P, *([1] * x.dim())), p)
            loss, grads = value_and_grad(
                self._loss_fn, stacked, step_feats, inputs.tables[:, k],
                inputs.masks[:, k], inputs.batches[:, k], labels,
                inputs.bmasks[:, k])
            with torch.no_grad():
                g = tree_map(lambda x: x.mean(dim=0), grads)
            upd, o = masked_update(self.local_opt, g, o, p, valid)
            p = apply_updates(p, upd)
            losses.append(loss.mean() * valid)
        with torch.no_grad():
            loss = _masked_mean(torch.stack(losses), svalid)
        return p, o, loss, state.comm_residual

    # ------------------------------------------------------ correction phase
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
        self._round_traces.count(trace_signature(
            (feats, labels, inputs.tables, inputs.masks, inputs.batches,
             inputs.bmasks)))
        body = (self._round_local if self.cfg.mode == "local"
                else self._round_sync)
        params, opt_state, loss, residual = body(state, feats, labels,
                                                 inputs, svalid)
        # metrics stay device scalars; run_schedule floats them
        metrics = {"local_loss": loss}
        server_state = state.server_opt_state
        # S=0 corrections: skip entirely (a mean over no steps is NaN)
        if (self.cfg.with_correction and inputs.corr_batches is not None
                and inputs.corr_batches.shape[0] > 0):
            self._corr_traces.count(trace_signature(
                (inputs.corr_feats, inputs.corr_labels, inputs.corr_tables,
                 inputs.corr_masks, inputs.corr_batches, inputs.corr_bmasks),
                static=(None if inputs.corr_agg is None
                        else inputs.corr_agg.layout,)))
            params, server_state, closs = self._correction(
                params, server_state, inputs)
            metrics["corr_loss"] = closs
        return EngineState(params=params, local_opt_state=opt_state,
                           server_opt_state=server_state,
                           comm_residual=residual), metrics


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


@dataclasses.dataclass
class ResumePoint:
    """Where a checkpointed run left off (see :mod:`repro_torch.checkpoint`).

    ``state`` is the restored engine state, ``history`` the History as of
    the checkpointed round, ``start_round`` the first round still to
    EXECUTE (checkpoint round + 1).  The caller has restored the program's
    own state (sub-states, retrace signatures, uniform streams); with a
    ResumePoint :func:`run_schedule` skips ``program.init_state``.
    """

    state: Any
    history: History
    start_round: int


def run_schedule(program, init_params, feats, labels,
                 sample_fn: Callable[[int, int], RoundInputs],
                 schedule: List[int],
                 evaluate: Callable[[Any], tuple],
                 name: str,
                 bytes_per_round: Callable[[int, int], float],
                 steps_per_round: Callable[[int, int], int],
                 meta: Optional[Dict] = None,
                 bucketing: Optional[KBucketing] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_keep: int = 3,
                 checkpoint_hook: Optional[Any] = None,
                 resume: Optional[ResumePoint] = None) -> History:
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

    ``checkpoint_dir`` is the params export of the train→serve story: after
    each round's evaluation ``EngineState.params`` are written through
    :func:`repro_torch.checkpoint.store.save_checkpoint` (step = round,
    newest ``checkpoint_keep`` kept), ready for
    ``repro_torch.serving.gnn.GNNServingEngine.from_checkpoint``.

    ``checkpoint_hook`` is the full-state checkpoint tap:
    ``hook.after_round(r, state)`` fires right after round r runs — where
    the host RNG streams sit at "rounds 1..r drawn" — and
    ``hook.commit(r, state, hist)`` after round r's History rows land.
    ``resume`` (a :class:`ResumePoint`) continues a checkpointed run:
    ``program.init_state`` is skipped, rounds before ``resume.start_round``
    are skipped, and History and the byte/step sums continue from the
    restored History, so the completed run is bit-identical to one that was
    never interrupted.
    """
    if resume is None:
        state = program.init_state(init_params)
        hist = History(strategy=name, meta=dict(meta or {}))
        start = 1
    else:
        state, hist, start = resume.state, resume.history, resume.start_round
    for key in ("local_loss", "corr_loss", "corr_rounds"):
        hist.meta.setdefault(key, [])
    bytes_cum = float(hist.bytes_cum[-1]) if hist.bytes_cum else 0.0
    steps_cum = int(hist.steps_cum[-1]) if hist.steps_cum else 0
    for r, k in enumerate(schedule, start=1):
        if r < start:
            continue
        inputs = sample_fn(r, k)
        if bucketing is not None:
            inputs = pad_inputs_to_bucket(inputs, bucketing.pad_length(k))
        state, metrics = program.run_round(state, feats, labels, inputs)
        if checkpoint_hook is not None:
            checkpoint_hook.after_round(r, state)
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
        if checkpoint_dir:
            from repro_torch.checkpoint.store import save_checkpoint
            save_checkpoint(checkpoint_dir, r, state.params,
                            extra={"strategy": name, "round": r,
                                   "val_score": score},
                            keep=checkpoint_keep)
        if checkpoint_hook is not None:
            checkpoint_hook.commit(r, state, hist)
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
