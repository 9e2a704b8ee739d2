"""The LLCG round engine: K local steps on P machines, one parameter
average, S server corrections — the port of the JAX package's
``core/engine.py``.

The JAX engine compiles a round into one ``jit`` over a ``lax.scan`` of K
steps, with the machine axis executed by a backend.  PyTorch runs eagerly,
so the port executes the same round bodies directly (the K and S steps are
Python loops) on one of two backends:

* ``backend="vmap"`` — one process simulates every machine: the machine
  axis is a leading stack axis (:func:`repro_torch.core.machine.
  make_local_round`) and averaging is a mean over the stack.
* ``backend="shard_map"`` — the reference's device-per-machine backend,
  kept under its name so plans, configs and chaos specs carry across: one
  process per machine (:class:`repro_torch.launch.mesh.MachineMesh`, rank =
  machine), each running the same body on its own machine's slice.  The
  collectives are explicit: an all-reduce of the parameters (``local``),
  an all-gather of the compressed delta payloads, dequantized and averaged
  on every rank in the vmap backend's order (``local`` with a codec), a
  per-step gradient all-reduce (``sync``) and a per-step all-gather of the
  owner-bucketed send buffer (``halo``).  The server correction and the
  evaluation run on the lead rank (rank 0), which broadcasts the corrected
  parameters: ``index_add_`` atomics make two computations of the same
  correction differ on a GPU, and replicas must hold identical parameters.

Byte and step accounting and :class:`History` are shared by every plan.

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
from repro_torch.utils.logging import Timer
from repro_torch.utils.pytree import (map_with_paths, tree_leaves, tree_map,
                                      tree_unflatten)


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
BACKENDS = ("vmap", "shard_map")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX engine's config (module docstring for the backends)."""

    num_machines: int
    mode: str = "local"            # "local" (Alg. 1/2) | "sync" | "halo" (GGS)
    backend: str = "vmap"          # "vmap" | "shard_map" (one rank/machine)
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
    one that replays the JAX package's draws.  ``backend="shard_map"``
    needs ``mesh``, this process's :class:`~repro_torch.launch.mesh.
    MachineMesh`: the round's inputs, per-machine state and step losses
    are then this rank's machine only (a stack of one).
    """

    def __init__(self, model, local_opt: Optimizer,
                 server_opt: Optional[Optimizer], cfg: EngineConfig,
                 uniforms: Callable[[int], Any] = UniformStream, mesh=None):
        if cfg.mode not in MODES:
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.backend not in BACKENDS:
            raise ValueError(f"unknown backend {cfg.backend!r}; choose one "
                             f"of {BACKENDS}")
        if cfg.backend == "shard_map" and (
                mesh is None or mesh.size != cfg.num_machines):
            raise ValueError(
                "backend='shard_map' needs the MachineMesh of a group of "
                f"{cfg.num_machines} machines (repro_torch.launch.mesh)")
        if cfg.with_correction and server_opt is None:
            raise ValueError("with_correction requires a server optimizer")
        check_compression(cfg.compression)
        check_compression(cfg.halo_compression, halo=True)
        self.model, self.cfg = model, cfg
        self.mesh = mesh if cfg.backend == "shard_map" else None
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

    @property
    def _held(self) -> int:
        """Machines whose stack this process holds (1 per shard_map rank)."""
        return 1 if self.mesh is not None else self.cfg.num_machines

    def _mine(self, stacked):
        """This process's rows of a ``(P, …)`` machine stack."""
        return stacked if self.mesh is None else self.mesh.rows(stacked)

    # ------------------------------------------- per-machine state layout
    # stacked per machine: the error-feedback residual, and a ``local``
    # program's optimizer state when it threads it across rounds
    def to_global(self, tree):
        """A per-machine tree in the vmap layout: a shard_map rank's
        ``(1, …)`` leaves all-gathered to ``(P, …)`` (collective); scalar
        leaves (a shared step count) pass through."""
        if self.mesh is None or tree is None:
            return tree
        leaves = []
        map_with_paths(lambda _, x: leaves.append(x), tree)
        stacked = [x for x in leaves
                   if isinstance(x, torch.Tensor) and x.dim()]
        if not stacked:
            return tree
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for x in stacked:
            by_dtype.setdefault(x.dtype, []).append(x)
        full = {}
        for group in by_dtype.values():
            for x, g in zip(group, self.mesh.all_gather(group, "state")):
                full[id(x)] = g
        return map_with_paths(lambda _, x: full.get(id(x), x), tree)

    def to_machine(self, tree):
        """This rank's rows of a vmap-layout per-machine tree (the inverse
        of :meth:`to_global`, for a restored checkpoint)."""
        if self.mesh is None or tree is None:
            return tree
        return map_with_paths(
            lambda _, x: (self._mine(x) if isinstance(x, torch.Tensor)
                          and x.dim() else x), tree)

    def init_state(self, params) -> EngineState:
        cfg, P = self.cfg, self._held
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

    def _round_loss(self, losses: torch.Tensor, svalid) -> torch.Tensor:
        """The round's local loss from the ``(K, held)`` step losses: a
        shard_map rank gathers every machine's column first, so the mean
        is the vmap backend's over the same ``(K, P)`` table."""
        if self.mesh is not None:
            losses = torch.cat(self.mesh.all_gather(
                [losses.t().contiguous()], "loss")).t().contiguous()
        return _masked_mean(losses, svalid)

    # ------------------------------------------------------------ mode local
    def _round_local(self, state: EngineState, feats, labels,
                     inputs: RoundInputs, svalid):
        """K local steps per machine, then the (compressed) average."""
        with Timer("round.local"):
            p_new, o_new, losses = self._local_round(
                state.params, state.local_opt_state, feats, labels,
                inputs.tables, inputs.masks, inputs.batches, inputs.bmasks,
                svalid)
        with torch.no_grad():
            loss = self._round_loss(losses, svalid)
            params, residual = self.average(state, p_new)
        o_carry = None if self.cfg.reset_local_opt else o_new
        return params, o_carry, loss, residual

    def average(self, state: EngineState, p_new):
        """Alg. 1/2 line 12, THE inter-machine collective: the machines'
        new parameters ``p_new`` (stacked, this process's rows) averaged
        into the next global parameters.  Returns ``(params, residual)``.

        With a codec each machine compresses its parameter DELTA and the
        average is over the dequantized deltas — what every machine gets
        from the exchange of compressed payloads; under EF the
        quantization error stays on the machine.  On shard_map the payloads
        are all-gathered and every rank dequantizes and averages the
        ``(P, …)`` table as the vmap backend does, so both backends give
        the same bits from the same ``p_new``.
        """
        mesh, residual = self.mesh, state.comm_residual
        with Timer("round.average"), torch.no_grad():
            if self._comp == "none":
                if mesh is None:
                    return tree_map(lambda x: x.mean(dim=0), p_new), residual
                leaves = tree_leaves(p_new)
                return tree_unflatten(p_new, mesh.all_reduce_mean(
                    [x[0] for x in leaves], "averaging")), residual
            delta = tree_map(lambda a, b: a - b, p_new, state.params)
            if self._ef:
                delta = tree_map(torch.add, delta, residual)
            u = None
            if self._uniforms is not None:
                # every rank draws all P machines' uniforms, so the stream
                # is the vmap backend's
                u = [self._mine(x) for x in self._uniforms.draw(
                    self.cfg.num_machines,
                    [x[0].numel() for x in tree_leaves(delta)],
                    tree_leaves(delta)[0].device)]
            payload, scales = compress_tree(delta, self._comp, u=u,
                                            stacked=True)
            if mesh is not None:
                # the collective: every machine's compressed payload
                payload = tree_unflatten(payload, mesh.all_gather(
                    tree_leaves(payload), "averaging"))
                if scales is not None:
                    scales = tree_unflatten(scales, mesh.all_gather(
                        tree_leaves(scales), "averaging"))
            deq = decompress_tree(payload, scales, self._comp)
            params = tree_map(lambda p0, d: p0 + d.mean(dim=0),
                              state.params, deq)
            if self._ef:
                residual = tree_map(lambda d, q: d - self._mine(q), delta,
                                    deq)
        return params, residual

    # ------------------------------------------------- modes sync and halo
    def _round_sync(self, state: EngineState, feats, labels,
                    inputs: RoundInputs, svalid):
        """Per-step gradient averaging across machines sharing one set of
        parameters (GGS); in halo mode each step first fills the halo rows
        from the exchanged send buffers."""
        P, mesh = self._held, self.mesh
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
                if mesh is None:
                    gathered_comp = decompress_features(payload, scales,
                                                        self._halo_comp)

            def exchange():
                """What the all-gather hands every machine this step."""
                if mesh is None:
                    return (send_buffer() if self._halo_comp == "none"
                            else gathered_comp)
                if self._halo_comp == "none":
                    return mesh.all_gather([send_buffer()], "halo")[0]
                parts = [payload] + ([] if scales is None else [scales])
                got = [mesh.all_gather([t], "halo")[0] for t in parts]
                return decompress_features(got[0], got[1] if len(got) > 1
                                           else None, self._halo_comp)
        p, o = state.params, state.local_opt_state
        losses = []
        with Timer("round.local"):
            for k, valid in enumerate(svalid):
                step_feats = feats
                if halo:
                    step_feats = halo_fill(feats, exchange(), recv_idx,
                                           dest_idx, recv_valid)
                with torch.no_grad():
                    stacked = tree_map(
                        lambda x: x[None].repeat(P, *([1] * x.dim())), p)
                loss, grads = value_and_grad(
                    self._loss_fn, stacked, step_feats, inputs.tables[:, k],
                    inputs.masks[:, k], inputs.batches[:, k], labels,
                    inputs.bmasks[:, k])
                with torch.no_grad():
                    if mesh is None:
                        g = tree_map(lambda x: x.mean(dim=0), grads)
                    else:
                        g = tree_unflatten(grads, mesh.all_reduce_mean(
                            [x[0] for x in tree_leaves(grads)], "gradients"))
                with Timer("step.optimizer"):
                    upd, o = masked_update(self.local_opt, g, o, p, valid)
                    p = apply_updates(p, upd)
                losses.append(loss)
        with torch.no_grad():
            per_step = torch.stack(losses)                  # (K, held)
            if mesh is not None:
                # every machine's step losses, as the vmap backend holds them
                per_step = torch.cat(mesh.all_gather(
                    [per_step.t().contiguous()], "loss")).t().contiguous()
            loss = _masked_mean(torch.stack(
                [per_step[k].mean() * v for k, v in enumerate(svalid)]),
                svalid)
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
            with Timer("step.optimizer"):
                upd, server_state = self.server_opt.update(
                    grads, server_state, params)
                params = apply_updates(params, upd)
            losses.append(loss[0])
        return params, server_state, torch.stack(losses).mean()

    def _lead_correction(self, params, server_state, inputs: RoundInputs):
        """The correction on a shard_map group: the lead rank computes it
        and broadcasts the parameters and the loss; the other ranks keep
        their (unused) server state."""
        closs = torch.zeros((), device=tree_leaves(params)[0].device)
        if self.mesh.is_lead:
            params, server_state, closs = self._correction(
                params, server_state, inputs)
        leaves = tree_leaves(params) + [closs]
        got = self.mesh.broadcast(leaves)
        return tree_unflatten(params, got[:-1]), server_state, got[-1]

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
            correct = (self._correction if self.mesh is None
                       else self._lead_correction)
            with Timer("round.correction"):
                params, server_state, closs = correct(params, server_state,
                                                      inputs)
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


def _prefetcher(sample_fn, bucketing: Optional[KBucketing], prefetch: bool,
                device):
    """``(draw, take)`` for :func:`run_schedule`: ``draw(r, k)`` samples
    round r (padded to its bucket), on a side stream when prefetching on a
    CUDA device; ``take(inputs)`` hands the drawn inputs to the compute
    stream."""
    dev = torch.device(device) if device is not None else None
    side = None
    if prefetch and dev is not None and dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        # the side stream starts after everything enqueued so far (the
        # sampler's device-resident stacks)
        side.wait_stream(torch.cuda.current_stream(dev))

    def sample(r, k):
        inputs = sample_fn(r, k)
        if bucketing is not None:
            inputs = pad_inputs_to_bucket(inputs, bucketing.pad_length(k))
        return inputs

    def draw(r, k):
        if side is None:
            with Timer("round.draw"):
                return sample(r, k)
        # the span opens on the side stream, so its events time the draw
        with torch.cuda.stream(side), Timer("round.draw"):
            return sample(r, k)

    def take(inputs):
        if side is not None:
            compute = torch.cuda.current_stream(dev)
            compute.wait_stream(side)
            for f in dataclasses.fields(inputs):
                t = getattr(inputs, f.name)
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(compute)
        return inputs

    return draw, take


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
                 prefetch: bool = False,
                 checkpoint_hook: Optional[Any] = None,
                 resume: Optional[ResumePoint] = None,
                 device=None) -> History:
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

    ``prefetch=True`` double-buffers the sampling: round r+1's
    ``sample_fn`` is issued right after round r is enqueued (and after
    ``checkpoint_hook.after_round``), before anything blocks on round r
    (its metrics, the evaluation).  On a CUDA ``device`` the draw runs on a
    side stream; before round r+1 reads its inputs the compute stream waits
    for the draw, and every input tensor is recorded on the compute stream
    so the allocator cannot hand its memory out while round r+1 still
    uses it.  Rounds are consumed strictly in order, so a host sampler
    draws in the synchronous loop's order and the trajectory is the same
    bit for bit.

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
    draw, take = _prefetcher(sample_fn, bucketing, prefetch, device)
    pending = (draw(start, schedule[start - 1])
               if (prefetch and start <= len(schedule)) else None)
    for r, k in enumerate(schedule, start=1):
        if r < start:
            continue
        with Timer("round", round=r):
            inputs = take(pending) if prefetch else draw(r, k)
            state, metrics = program.run_round(state, feats, labels, inputs)
            if checkpoint_hook is not None:
                # BEFORE the prefetch draw: the snapshot must hold the RNG
                # streams at "rounds 1..r drawn, nothing beyond"
                checkpoint_hook.after_round(r, state)
            if prefetch:
                # round r is enqueued and nothing has blocked on it yet
                pending = (draw(r + 1, schedule[r]) if r < len(schedule)
                           else None)
            hist.meta["local_loss"].append(float(metrics["local_loss"]))
            if "corr_loss" in metrics:
                hist.meta["corr_loss"].append(float(metrics["corr_loss"]))
                hist.meta["corr_rounds"].append(r)
            bytes_cum += bytes_per_round(r, k)
            steps_cum += steps_per_round(r, k)
            with Timer("round.evaluate"):
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
