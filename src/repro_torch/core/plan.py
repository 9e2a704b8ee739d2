"""Composable TrainPlan API: strategies as declarative round-phase plans.

The port of the JAX package's ``core/plan.py``.  A :class:`TrainPlan` is a
tuple of :class:`RoundPhase` specs (``local_steps`` | ``averaging`` |
``correction`` | ``halo_exchange``) over grouped sub-configs, and ONE
entry point — :func:`build_trainer` — lowers it onto the round engine
(:mod:`repro_torch.core.engine`) and runs it on a device (``"cuda"`` unless
the caller passes another)::

    data, model, cfg = make_paper_setting("reddit")
    hist = build_trainer(data, model, llcg_plan(cfg)).run()

The canned plans :func:`psgd_pa_plan`, :func:`llcg_plan`, :func:`ggs_plan`
and :func:`single_machine_plan` are one-line compositions.  Each scheduled
round is lowered independently: the phases active at round ``r``
(scheduled length ``k``) pick the engine round mode, the optimizer-state
threading, the host sampling path and the byte/step accounting.

:class:`RoundSampler` owns the partition, the shard loaders, the shared
host RNG, the padded per-machine views, the server's full-neighbor
eval/correction tables and, built on demand by
:meth:`RoundSampler.ensure_halo`, the extended-graph views and
:class:`~repro_torch.graph.halo.HaloProgram` of the halo rounds; its RNG
draw order is the JAX package's, so both packages train on identical
samples from the same seeds.  ``CommSpec``'s codecs
(:mod:`repro_torch.comm.compress`) compress the averaging deltas and the
halo features, and every byte count prices the compressed wire format.

``TrainPlan.checkpoint_dir`` exports each round's params for serving
(:mod:`repro_torch.serving.gnn`); a :class:`CheckpointSpec` snapshots the
full training state every ``every`` rounds through
:class:`repro_torch.checkpoint.manager.CheckpointManager`, and
``PlanTrainer.run(resume_from=...)`` continues such a run bit-identical to
an uninterrupted one (:func:`repro_torch.launch.train.run_or_resume`).

``SamplerSpec(placement="device")`` draws each round's tables and batches
on the device from the JAX package's ``jax.random`` stream
(:func:`repro_torch.graph.sampling.sample_round_device`), so both packages
train on the same samples there too, and ``overlap`` prefetches round
r+1's draw on a side stream while round r runs.  ``backend="shard_map"``
runs the plan on a :class:`~repro_torch.launch.mesh.MachineMesh`, one
process per machine (:mod:`repro_torch.core.engine`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CheckpointRefused, TraceCounter,
                                            digest_json, trace_signature)
from repro_torch.comm.compress import (COMPRESSIONS, HALO_COMPRESSIONS,
                                       UniformStream,
                                       averaging_payload_bytes)
from repro_torch.core.engine import (
    BACKENDS, EngineConfig, EngineState, History, ResumePoint, RoundInputs,
    RoundProgram, run_schedule,
)
from repro_torch.core.machine import make_eval_fn, make_machine_step
from repro_torch.core.schedules import KBucketing, local_epoch_schedule
from repro_torch.data.graph_loader import make_shard_loaders, sample_round
from repro_torch.graph.csr import build_neighbor_table
from repro_torch.graph.datasets import SyntheticDataset
from repro_torch.graph.halo import (build_halo_plan, build_halo_program,
                                    ext_fanout)
from repro_torch.graph.partition import PARTITION_METHODS, partition_graph
from repro_torch.graph.sampling import (
    DeviceCSR, _all_nodes_plan, build_device_csr, sample_minibatch,
    sample_minibatch_batched, sample_neighbors, sample_neighbors_batched,
    sample_round_device,
)
from repro_torch.models.gnn.agg import (
    LAYOUTS as AGG_LAYOUTS, build_agg_operands, choose_layout,
)
from repro_torch.models.gnn.model import GNNModel
from repro_torch.optim.optimizers import OPTIMIZERS, make_optimizer
from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_bytes, tree_leaves


#: Round-phase kinds — the paper's composable primitives.
PHASE_KINDS = ("local_steps", "averaging", "correction", "halo_exchange")
#: K-bucketing grids (:class:`repro_torch.core.schedules.KBucketing`).
BUCKET_MODES = ("geometric", "fit")
#: Where :class:`SamplerSpec` draws a round's tables and batches.
PLACEMENTS = ("host", "device")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


# --------------------------------------------------------------------------
# Grouped sub-configs
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """The K-local-steps phase: per-machine optimizer + step budget."""

    local_k: int = 4                 # K
    batch_size: int = 32             # B_L
    lr: float = 1e-2                 # η
    optimizer: str = "adam"          # paper uses ADAM (App. A.2)
    agg_layout: str = "padded"       # "padded" | "auto" (sampled tables)

    def __post_init__(self):
        _check(self.local_k >= 1, "local_k must be ≥ 1")
        _check(self.batch_size >= 1, "batch_size must be ≥ 1")
        _check(self.lr > 0, "lr must be > 0")
        _check(self.optimizer in OPTIMIZERS,
               f"unknown optimizer {self.optimizer!r}; "
               f"choose one of {OPTIMIZERS}")
        _check(self.agg_layout in ("padded", "auto"),
               f"LocalSpec.agg_layout {self.agg_layout!r} is not available: "
               "local rounds train on sampled neighbor tables, which the "
               "full-graph layouts cannot represent; put 'csr' or "
               "'bcsr_kernel' on ServerSpec.agg_layout for the "
               "full-neighbor correction")


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """The server-correction phase (Eq. 2 / Alg. 2 lines 13-18)."""

    correction_steps: int = 1        # S
    server_batch_size: int = 64      # B_S
    server_lr: Optional[float] = None  # γ (None → local lr η)
    correction_sampling: bool = False  # App. A "sampling at correction"
    max_cut_minibatch: bool = False    # App. A.3 ablation
    agg_layout: str = "padded"       # aggregation layout of the correction

    def __post_init__(self):
        _check(self.correction_steps >= 0, "correction_steps must be ≥ 0")
        _check(self.server_batch_size >= 1, "server_batch_size must be ≥ 1")
        _check(self.server_lr is None or self.server_lr > 0,
               "server_lr must be > 0 (or None for the local lr)")
        _check(self.agg_layout in AGG_LAYOUTS,
               f"unknown agg_layout {self.agg_layout!r}; "
               f"choose one of {AGG_LAYOUTS}")
        _check(not (self.correction_sampling
                    and self.agg_layout in ("csr", "bcsr_kernel")),
               "correction_sampling draws per-step subsampled tables, which "
               f"the {self.agg_layout!r} layout cannot represent (it "
               "encodes the full edge set) — use agg_layout='padded' or "
               "'auto' with the sampling-at-correction ablation")


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Topology + communication semantics.

    ``compression`` is the averaging rounds' parameter-delta codec
    (``none | bf16 | int8 | int8_ef``; the int8 codecs round
    stochastically, ``int8_ef`` carries the per-machine error-feedback
    residual) and ``halo_compression`` the halo rounds' feature codec
    (``none | bf16 | int8``, deterministic rounding).  All byte accounting
    prices the compressed wire format.
    """

    num_machines: int = 8
    partition_method: str = "bfs"
    host_halo: bool = False          # GGS: host-materialized halo
    compression: str = "none"        # averaging-round param-delta codec
    halo_compression: str = "none"   # halo-round feature codec

    def __post_init__(self):
        _check(self.num_machines >= 1, "num_machines must be ≥ 1")
        _check(self.partition_method in PARTITION_METHODS,
               f"unknown partition_method {self.partition_method!r}; "
               f"choose one of {PARTITION_METHODS}")
        _check(self.compression in COMPRESSIONS,
               f"unknown compression {self.compression!r}; "
               f"choose one of {COMPRESSIONS}")
        _check(self.halo_compression in HALO_COMPRESSIONS,
               f"unknown halo_compression {self.halo_compression!r}; "
               f"choose one of {HALO_COMPRESSIONS} (error feedback needs "
               "a persistent per-machine residual, which per-step feature "
               "buffers don't carry)")
        _check(not (self.host_halo and self.halo_compression != "none"),
               "host_halo materializes raw f32 halo features on the host — "
               "halo_compression requires the executed device exchange "
               "(host_halo=False)")


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Neighbor sampling (Eq. 4): where it runs and whether it overlaps.

    ``placement="host"`` is the vectorized-numpy path with the JAX
    package's host RNG streams.  ``placement="device"`` draws the whole
    round on the device from the JAX package's documented ``jax.random``
    stream (:mod:`repro_torch.graph.sampling`), one asynchronous batch of
    kernels that can run while the previous round computes.  ``overlap``
    prefetches round r+1's draw while round r runs (``None`` → on exactly
    when placement is "device").  ``rng_compat`` needs host placement.
    """

    fanout: Optional[int] = 10       # None = full neighbors
    fanout_ratio: Optional[float] = None
    full_graph: bool = False         # centralized reference: sample the
                                     # UNpartitioned graph (requires P=1)
    placement: str = "host"          # "host" | "device"
    overlap: Optional[bool] = None   # None → (placement == "device")

    def __post_init__(self):
        _check(self.fanout is None or self.fanout >= 1,
               "fanout must be ≥ 1 or None (full neighbors)")
        _check(self.fanout_ratio is None or 0.0 < self.fanout_ratio <= 1.0,
               "fanout_ratio must be in (0, 1]")
        _check(self.placement in PLACEMENTS,
               f"unknown placement {self.placement!r}; "
               f"choose one of {PLACEMENTS}")

    @property
    def resolved_overlap(self) -> bool:
        return (self.placement == "device" if self.overlap is None
                else bool(self.overlap))


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """How many rounds, and how K grows (Section 3.1)."""

    rounds: int = 20
    rho: float = 1.0                 # ρ (>1 → exponential LLCG schedule)
    k_schedule: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        _check(self.rounds >= 1, "rounds must be ≥ 1")
        _check(self.rho >= 1.0, "ρ must be ≥ 1 (ρ=1 is the fixed schedule)")
        if self.k_schedule is not None:
            _check(len(self.k_schedule) == self.rounds,
                   "k_schedule length must equal rounds")
            _check(all(k >= 1 for k in self.k_schedule),
                   "k_schedule entries must be ≥ 1")

    def resolve(self, base_k: int) -> List[int]:
        if self.k_schedule is not None:
            return list(self.k_schedule)
        if self.rho > 1.0:
            return local_epoch_schedule(base_k, self.rho, self.rounds)
        return [base_k] * self.rounds


@dataclasses.dataclass(frozen=True)
class CompileSpec:
    """Sampling-stream and K-bucketing knobs (no effect on the math).

    The JAX package's ``cache_dir`` (its persistent compilation cache) has
    no counterpart in the eager port.
    """

    rng_compat: bool = False         # replay the pre-vectorization RNG
    k_bucketing: bool = False        # pad K to buckets (masked tail steps)
    bucket_growth: int = 2
    bucket_mode: str = "geometric"

    def __post_init__(self):
        _check(self.bucket_growth >= 2, "bucket_growth must be ≥ 2")
        _check(self.bucket_mode in BUCKET_MODES,
               f"unknown bucket_mode {self.bucket_mode!r}; "
               f"choose one of {BUCKET_MODES}")

    def bucketing_for(self, schedule: List[int],
                      base_k: int) -> Optional[KBucketing]:
        if not self.k_bucketing:
            return None
        if self.bucket_mode == "fit":
            return KBucketing.fit(schedule, min_len=base_k,
                                  growth=self.bucket_growth)
        return KBucketing(min_len=base_k, growth=self.bucket_growth)


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Preemption-safe full-state checkpointing (no effect on the math).

    Every ``every``-th round the trainer snapshots the ENTIRE training
    state — params, per-program optimizer states, the error-feedback
    ``comm_residual``, the shared server-optimizer state, every host RNG
    stream position, the stochastic-rounding uniform stream, the round
    cursor, retrace signatures and ``History`` — through
    :class:`repro_torch.checkpoint.manager.CheckpointManager` under
    ``dir``.  A run killed at ANY instant resumes from the latest valid
    checkpoint (``PlanTrainer.run(resume_from=...)`` /
    :func:`repro_torch.launch.train.resume`) bit-identical to an
    uninterrupted run on the CPU.  ``async_=True`` moves serialization and
    fsync to a writer thread; the bounded ``queue_size`` makes a slow disk
    backpressure the trainer instead of dropping checkpoints.
    """

    dir: str
    every: int = 1
    keep: int = 3
    async_: bool = True
    queue_size: int = 2

    def __post_init__(self):
        _check(bool(self.dir), "CheckpointSpec.dir must be a directory path")
        _check(self.every >= 1, "CheckpointSpec.every must be ≥ 1")
        _check(self.keep >= 0,
               "CheckpointSpec.keep must be ≥ 0 (0 = keep everything)")
        _check(self.queue_size >= 1, "CheckpointSpec.queue_size must be ≥ 1")


# --------------------------------------------------------------------------
# RoundPhase — one composable primitive + its per-round activity gates
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoundPhase:
    """One primitive of the round, active on a declarative subset of rounds.

    A phase runs at round r (1-based, scheduled length k) iff ALL gates
    pass: ``r % every == 0``, ``r ≤ first`` (when set), ``r > after``, and
    ``when(r, k)`` (when set).
    """

    kind: str
    every: int = 1
    first: Optional[int] = None
    after: int = 0
    when: Optional[Callable[[int, int], bool]] = None
    reset_opt: bool = True           # local_steps only: Alg. 2 line 3

    def __post_init__(self):
        _check(self.kind in PHASE_KINDS,
               f"unknown phase kind {self.kind!r}; "
               f"choose one of {PHASE_KINDS}")
        _check(self.every >= 1, "every must be ≥ 1")
        _check(self.first is None or self.first >= 0, "first must be ≥ 0")
        _check(self.after >= 0, "after must be ≥ 0")
        _check(self.kind == "local_steps" or self.reset_opt,
               f"reset_opt=False applies only to local_steps phases "
               f"(got kind={self.kind!r}; halo rounds always thread their "
               "per-step optimizer state)")

    def active(self, r: int, k: int) -> bool:
        return (r % self.every == 0
                and (self.first is None or r <= self.first)
                and r > self.after
                and (self.when is None or bool(self.when(r, k))))

    def describe(self) -> Dict:
        d = {"kind": self.kind, "every": self.every, "first": self.first,
             "after": self.after, "when": bool(self.when)}
        if self.kind == "local_steps":
            d["reset_opt"] = self.reset_opt
        return d


def local_steps(**kw) -> RoundPhase:
    """K dependency-free local steps per machine (Alg. 1/2 lines 3-9)."""
    return RoundPhase("local_steps", **kw)


def averaging(**kw) -> RoundPhase:
    """The end-of-round parameter-average collective (Alg. 1/2 line 12)."""
    return RoundPhase("averaging", **kw)


def correction(**kw) -> RoundPhase:
    """S global server-correction steps (Alg. 2 lines 13-18)."""
    return RoundPhase("correction", **kw)


def halo_exchange(**kw) -> RoundPhase:
    """GGS rounds: per-step cut-node feature exchange + per-step gradient
    averaging on the extended (local ∪ halo) graphs."""
    return RoundPhase("halo_exchange", **kw)


# --------------------------------------------------------------------------
# TrainPlan
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """A declarative training strategy: phases × grouped sub-configs."""

    phases: Tuple[RoundPhase, ...]
    local: LocalSpec = LocalSpec()
    server: ServerSpec = ServerSpec()
    comm: CommSpec = CommSpec()
    sampler: SamplerSpec = SamplerSpec()
    schedule: ScheduleSpec = ScheduleSpec()
    compile: CompileSpec = CompileSpec()
    name: str = "plan"
    seed: int = 0
    checkpoint_dir: Optional[str] = None  # per-round params export (serving)
    checkpoint: Optional[CheckpointSpec] = None  # full-state resume snapshots

    def __post_init__(self):
        if not isinstance(self.phases, tuple):
            object.__setattr__(self, "phases", tuple(self.phases))
        _check(len(self.phases) > 0, "a TrainPlan needs at least one phase")
        if self.sampler.full_graph:
            _check(self.comm.num_machines == 1,
                   "sampler.full_graph (centralized reference) requires "
                   "num_machines=1")
            _check(all(p.kind != "halo_exchange" for p in self.phases),
                   "sampler.full_graph cannot be combined with "
                   "halo_exchange phases")
        _check(not (self.sampler.placement == "device"
                    and self.compile.rng_compat),
               "sampler.placement='device' draws from the documented "
               "jax.random stream, not the pre-vectorization host RNG "
               "streams — rng_compat requires placement='host'")

    def describe(self) -> Dict:
        """JSON-able summary for ``History.meta`` (callables elided)."""
        return {
            "name": self.name,
            "phases": [p.describe() for p in self.phases],
            "local": dataclasses.asdict(self.local),
            "server": dataclasses.asdict(self.server),
            "comm": dataclasses.asdict(self.comm),
            "sampler": dataclasses.asdict(self.sampler),
            "schedule": dataclasses.asdict(self.schedule),
            "compile": dataclasses.asdict(self.compile),
            "seed": self.seed,
            "checkpoint": (dataclasses.asdict(self.checkpoint)
                           if self.checkpoint is not None else None),
        }


@dataclasses.dataclass(frozen=True)
class RoundDesc:
    """One scheduled round after lowering: mode, threading and accounting."""

    r: int
    k: int
    kind: str                        # data path: "local" | "ext" | "full"
    mode: str                        # engine mode: "local" | "sync" | "halo"
    averaging: bool
    correction: bool
    reset_opt: bool

    @property
    def program_key(self) -> Tuple:
        """Rounds share an engine program iff they run the same mode and
        (local mode) thread the local optimizer state alike."""
        return (self.mode, self.reset_opt if self.mode == "local" else None)


def lower_plan(plan: TrainPlan) -> List[RoundDesc]:
    """Resolve the schedule and per-round phase activity into RoundDescs.

    Pure and cheap — composition errors (a round with no compute phase,
    local_steps+halo_exchange in the same round, missing averaging on >1
    machine) surface here, before any data or program is built.
    """
    P = plan.comm.num_machines
    descs = []
    for r, k in enumerate(plan.schedule.resolve(plan.local.local_k), 1):
        active = [p for p in plan.phases if p.active(r, k)]
        kinds = {p.kind for p in active}
        if "halo_exchange" in kinds:
            _check("local_steps" not in kinds,
                   f"round {r}: local_steps and halo_exchange cannot both "
                   "be active — a round is either K independent local steps "
                   "or per-step synchronized halo rounds")
            _check("averaging" not in kinds,
                   f"round {r}: halo_exchange already averages gradients "
                   "every step; drop the averaging phase on halo rounds")
            descs.append(RoundDesc(
                r=r, k=k, kind="ext",
                mode="sync" if plan.comm.host_halo else "halo",
                averaging=True, correction="correction" in kinds,
                reset_opt=False))
            continue
        _check("local_steps" in kinds,
               f"round {r}: no compute phase is active — every round needs "
               "local_steps or halo_exchange")
        avg = "averaging" in kinds
        _check(avg or P == 1,
               f"round {r}: local_steps on {P} machines requires the "
               "averaging phase (the engine's round always ends in the "
               "parameter-average collective); add averaging() or set "
               "num_machines=1")
        resets = {p.reset_opt for p in active if p.kind == "local_steps"}
        _check(len(resets) == 1,
               f"round {r}: conflicting reset_opt on active local_steps "
               "phases")
        descs.append(RoundDesc(
            r=r, k=k, kind="full" if plan.sampler.full_graph else "local",
            mode="local", averaging=avg,
            correction="correction" in kinds, reset_opt=resets.pop()))
    return descs


def _f32_mask(shape, fill: float = 1.0) -> np.ndarray:
    """One float32 mask/bmask buffer (validity weights are f32 everywhere)."""
    return np.full(shape, fill, np.float32)


# --------------------------------------------------------------------------
# RoundSampler — host-side sampling + the device copies of every view
# --------------------------------------------------------------------------
class RoundSampler:
    """Partitioned views + RNG streams for any plan.

    One instance serves every round kind: padded per-machine local views,
    the server's full-neighbor eval/correction tables, the single shared
    host RNG in the JAX package's draw order, and, built on demand by
    :meth:`ensure_halo`, the extended-graph views and
    :class:`~repro_torch.graph.halo.HaloProgram` of the halo rounds.  Every
    array the engine reads is copied to ``device`` once here or once per
    round.  With device placement the round's tables and batches are drawn
    on the device from per-kind :class:`~repro_torch.graph.sampling.
    DeviceCSR` stacks keyed ``fold_in(PRNGKey(seed), r)``.

    With a ``mesh`` (the ``shard_map`` backend) this process is machine
    ``mesh.rank``: it still draws every host stream for all P machines, so
    the streams are the vmap backend's, but copies only its own machine's
    rows to the device; a device-placed draw covers its machine alone.
    """

    def __init__(self, data: SyntheticDataset, model: GNNModel,
                 plan: TrainPlan, device, mesh=None):
        self.data, self.model, self.plan = data, model, plan
        self.device = torch.device(device)
        self.mesh = mesh
        comm, smp, loc, srv = plan.comm, plan.sampler, plan.local, plan.server
        self.num_machines = comm.num_machines
        self.rng_compat = plan.compile.rng_compat
        self.batch_size = loc.batch_size
        self.placement = smp.placement
        self.partition = partition_graph(data.graph, comm.num_machines,
                                         method=comm.partition_method,
                                         seed=plan.seed)
        self.loaders, self.server_sampler = make_shard_loaders(
            data, self.partition, fanout=smp.fanout,
            fanout_ratio=smp.fanout_ratio, seed=plan.seed,
            rng_compat=self.rng_compat)
        self.rng = np.random.default_rng(plan.seed + 1)

        P = comm.num_machines
        self.n_max = max(len(self.partition.part_nodes[p]) for p in range(P))
        # pad width must cover every machine's fanout (fanout_ratio resolves
        # per-machine fanouts from the local max degrees)
        self.fanout = max(ld.sampler.fanout for ld in self.loaders)
        d = data.feature_dim
        feats = np.zeros((P, self.n_max, d), np.float32)
        labels = np.zeros((P, self.n_max), np.int32)
        for p in range(P):
            nl = self.loaders[p].num_nodes
            feats[p, :nl] = self.loaders[p].features
            labels[p, :nl] = self.loaders[p].labels
        self.feats = self._dev(self._mine(feats))
        self.labels = self._dev(self._mine(labels))

        self.opt = make_optimizer(loc.optimizer, loc.lr)
        self.step = make_machine_step(model, self.opt)
        server_lr = srv.server_lr if srv.server_lr is not None else loc.lr
        self.server_opt = make_optimizer(loc.optimizer, server_lr)
        self.eval_fn = make_eval_fn(model)

        # full-graph full-neighbor table for eval + correction
        self.full_table, self.full_mask = build_neighbor_table(data.graph)
        self.full_feats = self._dev(data.features)
        self.full_labels = self._dev(data.labels)
        self.full_table_d = self._dev(self.full_table)
        self.full_mask_d = self._dev(self.full_mask)

        # correction-phase aggregation layout, resolved ONCE against the
        # full table's geometry; operands build lazily / at prewarm
        self.corr_agg_layout = choose_layout(
            srv.agg_layout, num_nodes=data.num_nodes,
            num_edges=data.graph.num_edges,
            width=self.full_table.shape[1],
            full_width=self.full_table.shape[1],
            sampled=srv.correction_sampling)
        self._corr_agg = None

        params0 = model.init_numpy(plan.seed)
        self.param_bytes = tree_bytes(params0)
        # one machine's averaging payload on the wire (== param_bytes for
        # compression="none"; the compressed wire format otherwise)
        self.avg_payload_bytes = averaging_payload_bytes(
            params0, plan.comm.compression)
        self._halo_built = False

        # device placement: per-kind DeviceCSR stacks, built once; the
        # distinct (kind, num_steps, width, batch_size) draws are counted
        # as the reference counts its sampler's jit traces
        self._device_key = threefry.prng_key(plan.seed)
        self._device_csrs: Dict[str, DeviceCSR] = {}
        self._sampler_traces = TraceCounter()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _mine(self, stacked):
        """This process's machine rows of a ``(P, …)`` stack: all of them,
        or a shard_map rank's one."""
        return stacked if self.mesh is None else self.mesh.rows(stacked)

    @property
    def num_sampler_retraces(self) -> int:
        return self._sampler_traces.count_value

    # ----------------------------------------------------------- rng snapshot
    def snapshot(self) -> Dict:
        """JSON-able position of every host RNG stream (for exact resume):
        the ONE shared rng (mini-batches, correction draws, extended
        tables), the per-loader neighbor-table rngs and the server's
        full-neighbor sampler rng."""
        gen = lambda g: g.bit_generator.state
        return {"rng": gen(self.rng),
                "loader_rngs": [gen(ld.sampler._rng) for ld in self.loaders],
                "server_rng": gen(self.server_sampler._rng),
                "sampler_traces": self._sampler_traces.snapshot()}

    def restore_snapshot(self, snap: Dict) -> None:
        self.rng.bit_generator.state = snap["rng"]
        loader_states = snap["loader_rngs"]
        if len(loader_states) != len(self.loaders):
            raise ValueError(
                f"checkpoint has {len(loader_states)} loader RNG streams, "
                f"this plan has {len(self.loaders)} machines")
        for ld, st in zip(self.loaders, loader_states):
            ld.sampler._rng.bit_generator.state = st
        self.server_sampler._rng.bit_generator.state = snap["server_rng"]
        if "sampler_traces" in snap:
            self._sampler_traces.restore(snap["sampler_traces"])

    # ------------------------------------------------------- device sampling
    def _device_csr(self, kind: str) -> DeviceCSR:
        """The kind's :class:`DeviceCSR`, built once and cached: the whole
        stack, or a shard_map rank's own machine at the stack's padded
        shapes (``n_pad``, ``t_pad``, ``dmax``: the bits depend on them)."""
        dcsr = self._device_csrs.get(kind)
        if dcsr is not None:
            return dcsr
        if kind == "local":
            graphs = [ld.sampler.graph for ld in self.loaders]
            n_pad = self.n_max
            pools = [ld.train_nodes for ld in self.loaders]
            fanouts = [ld.sampler.fanout for ld in self.loaders]
        elif kind == "ext":
            self.ensure_halo()
            graphs = list(self.halo_plan.ext_graphs)
            n_pad = self.n_ext_max
            pools = [ld.train_nodes for ld in self.loaders]
            fanouts = [self.fanout_ext] * self.num_machines
        elif kind == "full":
            graphs, n_pad = [self.data.graph], self.data.num_nodes
            pools, fanouts = [self.data.train_nodes], [self.fanout]
        else:
            raise ValueError(f"unknown round kind {kind!r}")
        machines = list(range(len(graphs)))
        if self.mesh is not None and len(graphs) > 1:
            machines = [self.mesh.rank]
        dcsr = build_device_csr(
            [graphs[p] for p in machines], n_pad=n_pad,
            train_nodes=[pools[p] for p in machines],
            fanouts=[fanouts[p] for p in machines],
            t_pad_min=max(max(len(t) for t in pools), self.batch_size),
            device=self.device, machines=machines,
            dmax=max(max(g.max_degree() for g in graphs), 1))
        self._device_csrs[kind] = dcsr
        return dcsr

    def _round_width(self, kind: str) -> int:
        return self.fanout_ext if kind == "ext" else self.fanout

    def sample_round_on_device(self, desc: RoundDesc,
                               k_pad: Optional[int] = None):
        """One round's ``(tables, masks, batches, bmasks, step_valid)``
        drawn on the device at the bucketed length ``k_pad`` (the per-round
        key is ``fold_in(PRNGKey(seed), r)``; padded steps are real draws of
        later step indices, flagged invalid in ``step_valid``)."""
        k = desc.k if k_pad is None else k_pad
        dcsr = self._device_csr(desc.kind)      # builds the halo view first
        width = self._round_width(desc.kind)
        self._sampler_traces.count(trace_signature(
            (), static=(desc.kind, k, width, self.batch_size)))
        tables, masks, batches, bmasks = sample_round_device(
            dcsr, threefry.fold_in(self._device_key, desc.r), k, width,
            self.batch_size)
        svalid = None
        if k_pad is not None:
            svalid = [1.0] * desc.k + [0.0] * (k_pad - desc.k)
        return tables, masks, batches, bmasks, svalid

    def prewarm(self, kinds, correction: bool = False) -> None:
        """Build every sampling structure up front, so no round pays the
        build: host placement touches each graph's cached sampling plan
        (skipped under ``rng_compat``), device placement builds each kind's
        :class:`DeviceCSR`; ``correction`` also builds the correction's
        aggregation operands."""
        if correction:
            self.correction_operands()
        if self.placement == "device":
            for kind in kinds:
                self._device_csr(kind)
            return
        if self.rng_compat:
            return
        if "local" in kinds:
            for ld in self.loaders:
                _all_nodes_plan(ld.sampler.graph, ld.sampler.fanout)
        if "ext" in kinds:
            self.ensure_halo()
            for g in self.halo_plan.ext_graphs:
                _all_nodes_plan(g, self.fanout_ext)
        if "full" in kinds:
            _all_nodes_plan(self.data.graph, self.fanout)

    # ------------------------------------------------------------- halo view
    def ensure_halo(self) -> None:
        """Build the extended-graph (local ∪ halo) machinery once.

        Deterministic — consumes no host RNG, so building it lazily leaves
        every sampling stream untouched.  The halo index tables go to the
        device here, once.
        """
        if self._halo_built:
            return
        data, P = self.data, self.num_machines
        self.halo_plan = build_halo_plan(data.graph, self.partition)
        self.n_ext_max = max(g.num_nodes for g in self.halo_plan.ext_graphs)
        self.halo_program = build_halo_program(data.graph, self.partition,
                                               plan=self.halo_plan,
                                               n_ext_pad=self.n_ext_max)
        self.fanout_ext = ext_fanout(self.halo_plan, self.fanout)
        d = data.feature_dim

        # padded extended features: local rows always; halo rows fetched
        # from global X host-side (host_halo) or left zero for the
        # engine's exchange to fill
        self.ext_feats = np.zeros((P, self.n_ext_max, d), np.float32)
        self.local_feats = np.zeros((P, self.n_ext_max, d), np.float32)
        self.ext_labels = np.zeros((P, self.n_ext_max), np.int32)
        for p in range(P):
            local = self.partition.part_nodes[p]
            rows = np.concatenate([local, self.halo_plan.halo_nodes[p]]
                                  ).astype(np.int64)
            self.ext_feats[p, : rows.size] = data.features[rows]
            self.ext_labels[p, : rows.size] = data.labels[rows]
            self.local_feats[p, : local.size] = data.features[local]
        fdtype = self.ext_feats.dtype
        halo_comp = self.plan.comm.halo_compression
        self.halo_bytes_per_step = self.halo_program.halo_bytes(
            d, dtype=fdtype, compression=halo_comp)
        self.exchange_bytes_per_step = self.halo_program.exchange_bytes(
            d, dtype=fdtype, compression=halo_comp)
        hp = self.halo_program
        self.halo_inputs = dict(
            halo_send_idx=self._dev(self._mine(hp.send_idx)),
            halo_recv_idx=self._dev(self._mine(hp.recv_idx)),
            halo_dest_idx=self._dev(self._mine(hp.dest_idx)),
            halo_recv_valid=self._dev(self._mine(hp.recv_valid)))
        self._halo_built = True

    # ---------------------------------------------------------------- local
    def local_batch(self, p: int):
        """One mini-batch of machine ``p``'s train nodes (numpy), drawn
        from the shared RNG, and its all-ones validity mask."""
        batch = sample_minibatch(self.loaders[p].train_nodes,
                                 self.batch_size, self.rng).astype(np.int32)
        return batch, _f32_mask(self.batch_size)

    # --------------------------------------------------------------- server
    def correction_operands(self):
        """The correction forward's prebuilt :class:`~repro_torch.models.gnn.
        agg.AggOperands` (None for the padded layout), cached on the graph."""
        if self.corr_agg_layout == "padded":
            return None
        if self._corr_agg is None:
            self._corr_agg = build_agg_operands(
                self.data.graph, self.corr_agg_layout, self.device)
        return self._corr_agg

    def correction_pool(self) -> np.ndarray:
        """Train-node pool for the server batch (Eq. 2 / App. A.3)."""
        if self.plan.server.max_cut_minibatch:
            src, dst = self.data.graph.to_edges()
            asg = self.partition.assignment
            cut_nodes = np.unique(np.concatenate(
                [src[asg[src] != asg[dst]], dst[asg[src] != asg[dst]]]))
            pool = np.intersect1d(cut_nodes, self.data.train_nodes)
            if pool.size:
                return pool
        return self.data.train_nodes

    def sample_correction(self) -> Dict:
        """S stacked server batches (+ per-step sampled tables if ablated)."""
        srv = self.plan.server
        S, Bs = srv.correction_steps, srv.server_batch_size
        pool = self.correction_pool()
        batches = np.zeros((S, Bs), np.int32)
        corr_tables, corr_masks = self.full_table_d, self.full_mask_d
        if srv.correction_sampling:
            if self.rng_compat:
                tabs = np.zeros((S, self.data.num_nodes, self.fanout),
                                np.int32)
                msks = _f32_mask(tabs.shape, 0.0)
                for s in range(S):
                    batches[s] = sample_minibatch(pool, Bs, self.rng)
                    t, m = sample_neighbors(self.data.graph,
                                            np.arange(self.data.num_nodes),
                                            self.fanout, self.rng,
                                            rng_compat=True)
                    tabs[s], msks[s] = t, m
            else:
                batches[:] = sample_minibatch_batched(pool, Bs, S, self.rng)
                tabs, msks = sample_neighbors_batched(
                    self.data.graph, None, self.fanout, self.rng, num_steps=S)
            corr_tables, corr_masks = self._dev(tabs), self._dev(msks)
        elif self.rng_compat:
            for s in range(S):
                batches[s] = sample_minibatch(pool, Bs, self.rng)
        else:
            batches[:] = sample_minibatch_batched(pool, Bs, S, self.rng)
        return dict(corr_feats=self.full_feats, corr_labels=self.full_labels,
                    corr_tables=corr_tables, corr_masks=corr_masks,
                    corr_batches=self._dev(batches),
                    corr_bmasks=self._dev(_f32_mask((S, Bs))),
                    corr_agg=self.correction_operands())

    # --------------------------------------------------------- round kinds
    def sample_local_round(self, k: int):
        """(tables, masks, batches, bmasks) numpy stacks for a local round."""
        return sample_round(self.loaders, k, self.batch_size, self.n_max,
                            self.fanout, self.rng, rng_compat=self.rng_compat)

    def sample_ext_round(self, k: int):
        """One halo round's extended-graph tables + local batches (numpy)."""
        self.ensure_halo()
        P, B = self.num_machines, self.batch_size
        tables = np.zeros((P, k, self.n_ext_max, self.fanout_ext), np.int32)
        masks = _f32_mask((P, k, self.n_ext_max, self.fanout_ext), 0.0)
        batches = np.zeros((P, k, B), np.int32)
        if self.rng_compat:
            # step-major / machine-minor on the ONE shared rng — the draw
            # order of the JAX package's per-step loop
            for i in range(k):
                for p in range(P):
                    g = self.halo_plan.ext_graphs[p]
                    t, m = sample_neighbors(g, np.arange(g.num_nodes),
                                            self.fanout_ext, self.rng,
                                            rng_compat=True)
                    tables[p, i, : g.num_nodes, : t.shape[1]] = t
                    masks[p, i, : g.num_nodes, : m.shape[1]] = m
                    batches[p, i] = sample_minibatch(
                        self.loaders[p].train_nodes, B, self.rng)
        else:
            for p in range(P):
                g = self.halo_plan.ext_graphs[p]
                t, m = sample_neighbors_batched(g, None, self.fanout_ext,
                                                self.rng, num_steps=k)
                tables[p, :, : g.num_nodes] = t
                masks[p, :, : g.num_nodes] = m
                batches[p] = sample_minibatch_batched(
                    self.loaders[p].train_nodes, B, k, self.rng)
        return tables, masks, batches, _f32_mask((P, k, B))

    def sample_full_round(self, k: int):
        """Centralized reference: sample the UNpartitioned graph (P=1)."""
        data, N, B = self.data, self.data.num_nodes, self.batch_size
        if self.rng_compat:
            tables = np.zeros((1, k, N, self.fanout), np.int32)
            masks = _f32_mask((1, k, N, self.fanout), 0.0)
            batches = np.zeros((1, k, B), np.int32)
            for i in range(k):
                t, m = sample_neighbors(data.graph, np.arange(N), self.fanout,
                                        self.rng, rng_compat=True)
                tables[0, i, :, : t.shape[1]] = t
                masks[0, i, :, : m.shape[1]] = m
                batches[0, i] = sample_minibatch(data.train_nodes, B,
                                                 self.rng)
        else:
            t, m = sample_neighbors_batched(data.graph, None, self.fanout,
                                            self.rng, num_steps=k)
            tables, masks = t[None], m[None]
            batches = sample_minibatch_batched(
                data.train_nodes, B, k, self.rng)[None].astype(np.int32)
        return tables, masks, batches, _f32_mask((1, k, B))

    def sample(self, desc: RoundDesc,
               k_pad: Optional[int] = None) -> RoundInputs:
        """One round's :class:`RoundInputs` on the device.

        Host placement: the draw order per round is the JAX package's —
        the round's tables + batches first, then, only on rounds where the
        correction phase is active, the server batches.  Device placement:
        the round is drawn on the device (at the bucketed length ``k_pad``
        when given, the real prefix flagged in ``step_valid``); the
        correction batches stay host-drawn from the shared RNG, so the
        placement never perturbs the server stream.  No placement falls
        back to the other.
        """
        svalid = None
        if self.placement == "device":
            tables, masks, batches, bmasks, svalid = \
                self.sample_round_on_device(desc, k_pad)
        else:
            if desc.kind == "local":
                arrays = self.sample_local_round(desc.k)
            elif desc.kind == "ext":
                arrays = self.sample_ext_round(desc.k)
            elif desc.kind == "full":
                arrays = self.sample_full_round(desc.k)
            else:
                raise ValueError(f"unknown round kind {desc.kind!r}")
            tables, masks, batches, bmasks = (self._dev(self._mine(a))
                                              for a in arrays)
        corr = self.sample_correction() if desc.correction else {}
        halo = self.halo_inputs if desc.mode == "halo" else {}
        return RoundInputs(tables=tables, masks=masks, batches=batches,
                           bmasks=bmasks, step_valid=svalid, **corr, **halo)

    def round_feats_labels(self, kind: str) -> Tuple[Any, Any]:
        """The (feats, labels) device tensors a round kind trains on."""
        if kind == "local":
            return self.feats, self.labels
        if kind == "ext":
            self.ensure_halo()
            feats = (self.ext_feats if self.plan.comm.host_halo
                     else self.local_feats)
            return (self._dev(self._mine(feats)),
                    self._dev(self._mine(self.ext_labels)))
        if kind == "full":
            return self.full_feats[None], self.full_labels[None]
        raise ValueError(f"unknown round kind {kind!r}")

    def evaluate(self, params, nodes):
        """Full-graph validation ``(loss, score)``; on a shard_map group
        the lead rank evaluates and broadcasts the two numbers."""
        if self.mesh is None or self.mesh.is_lead:
            loss, score = self.eval_fn(params, self.full_feats,
                                       self.full_table_d, self.full_mask_d,
                                       self.full_labels, self._dev(nodes))
            out = torch.tensor([float(loss), float(score)],
                               dtype=torch.float64)
        else:
            out = torch.zeros(2, dtype=torch.float64)
        if self.mesh is not None:
            out = self.mesh.broadcast([out])[0]
        return float(out[0]), float(out[1])

    def cut_stats(self) -> Dict:
        from repro_torch.graph.partition import cut_edge_stats
        return cut_edge_stats(self.data.graph, self.partition.assignment)


# --------------------------------------------------------------------------
# Plan program — per-round dispatch over the engine's RoundPrograms
# --------------------------------------------------------------------------
class _PlanProgram:
    """Duck-typed ``RoundProgram`` that dispatches each round to the right
    engine program and threads the mixed optimizer state.

    A plan can mix round modes and ``reset_opt`` settings, so this facade
    keeps one :class:`RoundProgram` per distinct ``(mode, reset_opt)`` key,
    one persistent sub-state per program (local rounds their optimizer
    state and error-feedback residual, halo/sync rounds their per-step
    optimizer moments), and ONE shared server-optimizer state injected into
    whichever program runs a correction round.  Each round trains on its
    own kind's arrays from the sampler.
    """

    def __init__(self, model, sampler: RoundSampler,
                 descs: List[RoundDesc], uniforms=UniformStream,
                 backend: str = "vmap"):
        plan = sampler.plan
        self.descs = descs
        self.sampler = sampler
        self.with_correction = any(d.correction for d in descs)
        self.server_opt = sampler.server_opt if self.with_correction else None
        # correction machinery goes only into programs that run a
        # correction round
        corr_keys = {d.program_key for d in descs if d.correction}
        self.programs: Dict[Tuple, RoundProgram] = {}
        for key in {d.program_key for d in descs}:
            mode, reset = key
            self.programs[key] = RoundProgram(
                model, sampler.opt,
                self.server_opt if key in corr_keys else None,
                EngineConfig(num_machines=plan.comm.num_machines,
                             mode=mode, backend=backend,
                             with_correction=key in corr_keys,
                             reset_local_opt=(reset if mode == "local"
                                              else True),
                             compression=plan.comm.compression,
                             halo_compression=plan.comm.halo_compression,
                             comm_seed=plan.seed),
                uniforms=uniforms, mesh=sampler.mesh)
        self._data = {kind: sampler.round_feats_labels(kind)
                      for kind in {d.kind for d in descs}}
        self._cursor = 0
        self._sub: Dict[Tuple, EngineState] = {}
        self._server_state = None
        self._key_by_str = {self._key_str(k): k for k in self.programs}

    @staticmethod
    def _key_str(key: Tuple) -> str:
        """Program key as the JAX package's checkpoint tree key
        (``"local:True"``, ``"halo:None"``)."""
        mode, reset = key
        return f"{mode}:{reset}"

    @property
    def num_retraces(self) -> int:
        return sum(p.num_retraces for p in self.programs.values())

    @property
    def num_corr_retraces(self) -> int:
        return sum(p.num_corr_retraces for p in self.programs.values())

    # --------------------------------------------------- checkpoint snapshot
    def snapshot_state(self, state: EngineState) -> Dict:
        """The FULL mutable tensor state as one tree (for the manager).

        The global params, the shared server-optimizer state, and every
        program's optimizer state and error-feedback residual, keyed as the
        JAX package keys them — a program that rebuilds its optimizer each
        round carries the reference's scalar placeholder there.  One entry
        is the port's own: ``uniforms/<program>``, the uint8 state of the
        CPU generator the int8 codecs draw their stochastic-rounding
        uniforms from (the JAX package folds stateless keys instead).
        Under shard_map every rank takes part: the per-machine leaves are
        gathered to the vmap layout, so the file is the same, and the lead
        rank's tree is the one written.  Call :meth:`init_state` first to
        build the same tree as a template.
        """
        subs = {}
        for k, s in self._sub.items():
            prog = self.programs[k]
            opt = s.local_opt_state
            if opt is None:
                opt = self._placeholder(state.params)
            elif prog.cfg.mode == "local":      # stacked per machine
                opt = prog.to_global(opt)
            subs[self._key_str(k)] = {
                "opt": opt, "residual": prog.to_global(s.comm_residual)}
        tree = {"params": state.params,
                "server": self._server_state,
                "subs": subs}
        streams = {self._key_str(k): p.uniforms.get_state()
                   for k, p in self.programs.items()
                   if hasattr(p.uniforms, "get_state")}
        if streams:
            tree["uniforms"] = streams
        return tree

    @staticmethod
    def _placeholder(params) -> torch.Tensor:
        """The JAX engine's scalar local-optimizer placeholder."""
        leaf = next(iter(tree_leaves(params)))
        return torch.zeros((), dtype=torch.float32, device=leaf.device)

    def train_state(self) -> Dict:
        """JSON-able non-tensor position: cursor + per-program trace state."""
        return {"cursor": self._cursor,
                "programs": {self._key_str(k): p.trace_state()
                             for k, p in self.programs.items()}}

    def restore_run_state(self, tree: Dict, aux: Dict) -> EngineState:
        """Rehydrate from a checkpoint; returns the outer EngineState.

        ``tree`` is a restored :meth:`snapshot_state` tree, ``aux`` the
        matching :meth:`train_state`.  Runs after :meth:`init_state` (which
        built the template and reset the uniform streams, whose positions
        are set here).
        """
        params = tree["params"]
        self._cursor = int(aux["cursor"])
        for ks, snap in aux["programs"].items():
            key = self._key_by_str.get(ks)
            if key is None:
                raise ValueError(f"checkpoint carries engine program {ks!r} "
                                 "this plan does not lower")
            self.programs[key].restore_trace_state(snap)
        if self.with_correction:
            self._server_state = tree["server"]
        for key, prog in self.programs.items():
            sub_t = tree["subs"][self._key_str(key)]
            keeps_opt = prog.cfg.mode != "local" or not prog.cfg.reset_local_opt
            opt = sub_t["opt"] if keeps_opt else None
            if prog.cfg.mode == "local":
                opt = prog.to_machine(opt)      # a shard_map rank's rows
            self._sub[key] = EngineState(
                params=params, local_opt_state=opt, server_opt_state=None,
                comm_residual=prog.to_machine(sub_t["residual"]))
        for ks, st in tree.get("uniforms", {}).items():
            self.programs[self._key_by_str[ks]].uniforms.set_state(st)
        return EngineState(params=params, local_opt_state=None)

    def init_state(self, params) -> EngineState:
        self._cursor = 0
        self._sub = {k: p.init_state(params)
                     for k, p in self.programs.items()}
        if self.with_correction:
            self._server_state = self.server_opt.init(params)
        return EngineState(params=params, local_opt_state=None)

    def run_round(self, state: EngineState, feats, labels,
                  inputs: RoundInputs):
        desc = self.descs[self._cursor]
        self._cursor += 1
        prog = self.programs[desc.program_key]
        sub = self._sub[desc.program_key]
        corr = prog.cfg.with_correction
        sub = EngineState(params=state.params,
                          local_opt_state=sub.local_opt_state,
                          server_opt_state=(self._server_state if corr
                                            else None),
                          comm_residual=sub.comm_residual)
        feats, labels = self._data[desc.kind]
        new, metrics = prog.run_round(sub, feats, labels, inputs)
        self._sub[desc.program_key] = new
        if corr:
            self._server_state = new.server_opt_state
        return EngineState(params=new.params, local_opt_state=None), metrics


# --------------------------------------------------------------------------
# checkpoint identity + the run_schedule checkpoint hook
# --------------------------------------------------------------------------
def plan_digest_of(plan: TrainPlan, backend: str) -> str:
    """Digest of everything that shapes the trajectory (for resume refusal):
    the plan description, the backend and the resolved schedule — but not
    the checkpoint spec, which does not change the math."""
    desc = plan.describe()
    desc.pop("checkpoint", None)
    return digest_json({"plan": desc, "backend": backend,
                        "schedule": plan.schedule.resolve(plan.local.local_k)})


def dataset_digest(data: SyntheticDataset) -> str:
    """Content digest of the dataset a checkpoint was trained on."""
    src, dst = data.graph.to_edges()
    h = hashlib.sha256()
    for arr in (data.features, data.labels, data.train_nodes,
                data.val_nodes, src, dst):
        h.update(np.ascontiguousarray(arr).tobytes())
    return digest_json({"num_nodes": int(data.num_nodes),
                        "num_edges": int(data.graph.num_edges),
                        "payload": h.hexdigest()})


class _PlanCheckpointHook:
    """Two-phase checkpoint tap that ``run_schedule`` drives every round.

    ``after_round(r)``, right after round r runs, snapshots the host RNG
    streams at exactly "rounds 1..r drawn"; ``commit(r)``, once round r's
    History rows land, pairs that snapshot with the tensor state and hands
    both to the manager.  Rounds where ``r % every != 0`` skip both.
    """

    def __init__(self, manager: CheckpointManager, sampler: RoundSampler,
                 program: _PlanProgram, every: int,
                 plan_digest: str, data_digest: str):
        self.manager = manager
        self.sampler = sampler
        self.program = program
        self.every = every
        self.plan_digest = plan_digest
        self.data_digest = data_digest
        self._rng_snap: Optional[Dict] = None

    def _due(self, r: int) -> bool:
        return r % self.every == 0

    def after_round(self, r: int, state: EngineState) -> None:
        if self._due(r):
            self._rng_snap = self.sampler.snapshot()

    def commit(self, r: int, state: EngineState, hist: History) -> None:
        if not self._due(r):
            return
        tree = self.program.snapshot_state(state)   # collective on shard_map
        if self.manager is not None:                # the writing rank
            train = {"round": r,
                     "sampler": self._rng_snap,
                     "program": self.program.train_state(),
                     "history": hist.to_json()}
            self.manager.save(r, tree, train=train,
                              plan_digest=self.plan_digest,
                              data_digest=self.data_digest)
        self._rng_snap = None


# --------------------------------------------------------------------------
# build_trainer — the one entry point
# --------------------------------------------------------------------------
class PlanTrainer:
    """A lowered :class:`TrainPlan`, ready to run on ``device``.

    Construction validates and lowers the plan (:func:`lower_plan`).
    :meth:`run` builds the :class:`RoundSampler`, the engine programs and
    the schedule loop fresh on every call, so repeated runs reproduce
    identical trajectories (the RNG streams restart).

    ``uniforms`` builds the stochastic-rounding source of the compressed
    codecs from a seed (default :class:`repro_torch.comm.compress.
    UniformStream`, which draws on the host, so the card and the CPU see
    the same uniforms).

    ``backend="shard_map"`` runs this process as one machine of ``mesh``
    (a :class:`~repro_torch.launch.mesh.MachineMesh` of ``num_machines``
    ranks, each calling :meth:`run`), on the mesh's device; the lead rank
    writes the checkpoints and its History is the run's.
    """

    def __init__(self, data: SyntheticDataset, model: GNNModel,
                 plan: TrainPlan, backend: str = "vmap", device="cuda",
                 uniforms=UniformStream, mesh=None):
        _check(backend in BACKENDS,
               f"unknown backend {backend!r}; choose one of {BACKENDS}")
        if backend == "shard_map":
            _check(mesh is not None
                   and mesh.size == plan.comm.num_machines,
                   "backend='shard_map' requires the MachineMesh of a group "
                   f"of {plan.comm.num_machines} machines "
                   "(repro_torch.launch.mesh.launch_machines)")
            device = mesh.device
        self.data, self.model, self.plan = data, model, plan
        self.backend = backend
        self.mesh = mesh if backend == "shard_map" else None
        self.device = torch.device(device)
        self.uniforms = uniforms
        self.descs = lower_plan(plan)
        self.schedule = [d.k for d in self.descs]

    # ------------------------------------------------------------ accounting
    def accounting(self, sampler: Optional[RoundSampler] = None
                   ) -> List[Dict]:
        """Per-round (kind, bytes, steps) without running any training.

        Averaging rounds move the parameter payload up + down per machine,
        priced at the compressed wire format; a halo round moves, per step,
        the executed exchange (or, with ``host_halo``, the ideal halo
        bytes) plus the f32 gradient average.  Plans with halo rounds build
        a host-side :class:`RoundSampler` for the halo byte model unless one
        is passed; others need only the model.
        """
        P = self.plan.comm.num_machines
        if sampler is None and any(d.kind == "ext" for d in self.descs):
            sampler = RoundSampler(self.data, self.model, self.plan, "cpu")
        if sampler is None:
            params0 = self.model.init_numpy(self.plan.seed)
            pb = tree_bytes(params0)
            apb = averaging_payload_bytes(params0,
                                          self.plan.comm.compression)
        else:
            pb, apb = sampler.param_bytes, sampler.avg_payload_bytes
        rows = []
        for d in self.descs:
            if d.kind == "ext":
                sampler.ensure_halo()
                comm_step = (sampler.halo_bytes_per_step
                             if self.plan.comm.host_halo
                             else sampler.exchange_bytes_per_step)
                # the per-step gradient average stays full f32 (only the
                # averaging deltas and the halo features are compressed)
                nbytes = d.k * (comm_step + 2 * P * pb)
            elif d.kind == "local" and d.averaging:
                nbytes = 2.0 * P * apb
            else:
                nbytes = 0.0
            rows.append({"round": d.r, "k": d.k, "kind": d.kind,
                         "mode": d.mode, "correction": d.correction,
                         "bytes": nbytes, "steps": P * d.k})
        return rows

    # ------------------------------------------------------------------- run
    def run(self, resume_from: Optional[str] = None,
            resume_step: Optional[int] = None) -> History:
        """Run the plan on the trainer's device; returns the History.

        ``resume_from`` names a :class:`CheckpointSpec` directory: the
        latest VALID checkpoint (or ``resume_step``) is restored onto the
        trainer's device — params, optimizer states, comm residual, RNG
        streams, uniform streams, cursor, retrace signatures, History — and
        training continues mid-schedule.  Checkpoints whose plan or dataset
        digest differs from this trainer's are refused.
        """
        plan, data, model = self.plan, self.data, self.model
        sampler = RoundSampler(data, model, plan, self.device,
                               mesh=self.mesh)
        sampler.prewarm({d.kind for d in self.descs},
                        correction=any(d.correction for d in self.descs))
        program = _PlanProgram(model, sampler, self.descs, self.uniforms,
                               backend=self.backend)
        by_round = {row["round"]: row for row in self.accounting(sampler)}
        bucketing = plan.compile.bucketing_for(self.schedule,
                                               plan.local.local_k)
        meta: Dict = {"param_bytes": sampler.param_bytes,
                      "plan": plan.describe(),
                      "device": str(self.device),
                      "sampler_placement": sampler.placement,
                      "sampler_overlap": plan.sampler.resolved_overlap,
                      "corr_agg_layout": sampler.corr_agg_layout}
        if any(d.kind == "ext" for d in self.descs):
            meta.update({
                "halo_executed": not plan.comm.host_halo,
                "halo_bytes_per_step": sampler.halo_bytes_per_step,
                "exchange_bytes_per_step": sampler.exchange_bytes_per_step,
                "halo_max_send": sampler.halo_program.max_send,
                "halo_max_halo": sampler.halo_program.max_halo})
        desc_by_round = {d.r: d for d in self.descs}
        if sampler.placement == "device" and bucketing is not None:
            # draw directly at the bucketed length (step_valid marks the
            # real prefix): no host-side padding
            def sample_fn(r, k):
                return sampler.sample(desc_by_round[r],
                                      k_pad=bucketing.pad_length(k))
        else:
            def sample_fn(r, k):
                return sampler.sample(desc_by_round[r])
        pdig = plan_digest_of(plan, self.backend)
        ddig = dataset_digest(data)
        resume = None
        if resume_from is not None:
            resume = self._restore(resume_from, resume_step, program,
                                   model.init(plan.seed, device=self.device),
                                   pdig, ddig)
        lead = self.mesh is None or self.mesh.is_lead
        manager = hook = None
        if plan.checkpoint is not None:
            ck = plan.checkpoint
            if lead:                     # one writer per run
                manager = CheckpointManager(ck.dir, keep=ck.keep,
                                            async_=ck.async_,
                                            queue_size=ck.queue_size)
            hook = _PlanCheckpointHook(manager, sampler, program, ck.every,
                                       pdig, ddig)
        try:
            hist = run_schedule(
                program, model.init(plan.seed, device=self.device), None,
                None, sample_fn, self.schedule,
                lambda p: sampler.evaluate(p, data.val_nodes),
                plan.name,
                bytes_per_round=lambda r, k: by_round[r]["bytes"],
                steps_per_round=lambda r, k: by_round[r]["steps"],
                meta=meta,
                bucketing=bucketing,
                checkpoint_dir=plan.checkpoint_dir if lead else None,
                prefetch=plan.sampler.resolved_overlap,
                checkpoint_hook=hook,
                resume=resume,
                device=self.device)
        finally:
            if manager is not None:
                manager.close()
        hist.meta["cut_stats"] = sampler.cut_stats()
        hist.meta["round_kinds"] = [d.kind for d in self.descs]
        hist.meta["sampler_retraces"] = sampler.num_sampler_retraces
        hist.meta["device"] = str(self.device)   # where the run finished
        return hist

    def _restore(self, resume_from: str, resume_step: Optional[int],
                 program: _PlanProgram, params0, pdig: str,
                 ddig: str) -> ResumePoint:
        """Load the latest valid (or explicit) checkpoint into ``program``.

        The template is the freshly initialized program state on the
        trainer's device — the exact tree, shapes and dtypes of every leaf
        — so a checkpoint of another architecture or codec fails the shape
        and dtype checks; the digests catch everything subtler.  The
        sampler must not have drawn yet (its streams are overwritten).
        """
        def check_identity(manifest):
            if manifest.get("plan_digest") != pdig:
                raise CheckpointRefused(
                    f"checkpoint under {resume_from} was written by a "
                    "different plan/backend (plan digest mismatch); refusing "
                    "to resume — a silent divergence is worse than a restart")
            if manifest.get("data_digest") != ddig:
                raise CheckpointRefused(
                    f"checkpoint under {resume_from} was trained on "
                    "different data (dataset digest mismatch); refusing to "
                    "resume")

        reader = CheckpointManager(resume_from, keep=0, async_=False)
        template = program.snapshot_state(program.init_state(params0))
        tree, manifest = reader.restore(template, step=resume_step,
                                        manifest_check=check_identity)
        train = manifest["train"]
        state0 = program.restore_run_state(tree, train["program"])
        program.sampler.restore_snapshot(train["sampler"])
        return ResumePoint(state=state0,
                           history=History.from_json(train["history"]),
                           start_round=int(train["round"]) + 1)


def build_trainer(data: SyntheticDataset, model: GNNModel, plan: TrainPlan,
                  backend: str = "vmap", device="cuda",
                  uniforms=UniformStream, mesh=None) -> PlanTrainer:
    """Lower ``plan`` onto the round engine; run with ``.run() -> History``.

    Runs on ``device`` — the GPU unless the caller passes another (the
    tests pass ``"cpu"``, where the kernels' plain versions run).
    ``backend="shard_map"`` runs this process as machine ``mesh.rank`` of
    the mesh, on its device (every rank builds and runs the same plan).
    ``uniforms`` replaces the stochastic-rounding source (see
    :class:`PlanTrainer`).
    """
    return PlanTrainer(data, model, plan, backend=backend, device=device,
                       uniforms=uniforms, mesh=mesh)


# --------------------------------------------------------------------------
# DistConfig — the flat config, validated into the grouped specs
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DistConfig:
    """Flat config; every field is validated at construction and
    :meth:`specs` regroups them into the typed sub-configs."""

    num_machines: int = 8
    rounds: int = 20
    local_k: int = 4                 # K
    rho: float = 1.0                 # ρ  (>1 → LLCG schedule; 1.0 → PSGD-PA)
    correction_steps: int = 1        # S
    batch_size: int = 32             # B_L
    server_batch_size: int = 64      # B_S
    fanout: Optional[int] = 10       # neighbor-sampling fanout (None = full)
    fanout_ratio: Optional[float] = None
    lr: float = 1e-2                 # η
    server_lr: Optional[float] = None  # γ (defaults to η)
    optimizer: str = "adam"          # paper uses ADAM (App. A.2)
    partition_method: str = "bfs"
    correction_sampling: bool = False  # App. A "sampling at correction"
    max_cut_minibatch: bool = False    # App. A.3 ablation
    server_agg_layout: str = "padded"  # correction-forward agg layout
    rng_compat: bool = False         # replay the pre-vectorization RNG
    k_bucketing: bool = False        # pad K to buckets
    bucket_growth: int = 2           # bucket lengths are local_k·growth^i
    bucket_mode: str = "geometric"   # "geometric" | "fit" (schedule-aware)
    ggs_host_halo: bool = False      # GGS: host-materialized halo
    checkpoint_dir: Optional[str] = None  # params export (train→serve hook)
    seed: int = 0

    def __post_init__(self):
        self.specs()

    def specs(self) -> Dict[str, Any]:
        """Regroup into the TrainPlan sub-configs (validates all fields)."""
        return dict(
            local=LocalSpec(local_k=self.local_k, batch_size=self.batch_size,
                            lr=self.lr, optimizer=self.optimizer),
            server=ServerSpec(correction_steps=self.correction_steps,
                              server_batch_size=self.server_batch_size,
                              server_lr=self.server_lr,
                              correction_sampling=self.correction_sampling,
                              max_cut_minibatch=self.max_cut_minibatch,
                              agg_layout=self.server_agg_layout),
            comm=CommSpec(num_machines=self.num_machines,
                          partition_method=self.partition_method,
                          host_halo=self.ggs_host_halo),
            sampler=SamplerSpec(fanout=self.fanout,
                                fanout_ratio=self.fanout_ratio),
            schedule=ScheduleSpec(rounds=self.rounds, rho=self.rho),
            compile=CompileSpec(rng_compat=self.rng_compat,
                                k_bucketing=self.k_bucketing,
                                bucket_growth=self.bucket_growth,
                                bucket_mode=self.bucket_mode),
        )


# --------------------------------------------------------------------------
# Canned plans — the paper's strategies as one-line compositions
# --------------------------------------------------------------------------
def _plan(cfg: DistConfig, phases: Tuple[RoundPhase, ...], name: str,
          **overrides) -> TrainPlan:
    specs = cfg.specs()
    specs.update(overrides)
    return TrainPlan(phases=phases, name=name, seed=cfg.seed,
                     checkpoint_dir=cfg.checkpoint_dir, **specs)


def psgd_pa_plan(cfg: DistConfig) -> TrainPlan:
    """Algorithm 1 — K local steps + parameter averaging, fixed schedule."""
    cfg = dataclasses.replace(cfg, rho=1.0)
    return _plan(cfg, (local_steps(), averaging()), "psgd_pa")


def llcg_plan(cfg: DistConfig, correction_every: int = 1) -> TrainPlan:
    """Algorithm 2 — PSGD-PA + the global server correction.

    ``correction_every=m`` runs the correction only on every m-th round.
    """
    return _plan(cfg, (local_steps(), averaging(),
                       correction(every=correction_every)), "llcg")


def ggs_plan(cfg: DistConfig) -> TrainPlan:
    """GGS baseline — per-step halo exchange + per-step averaging."""
    return _plan(cfg, (halo_exchange(),), "ggs",
                 schedule=ScheduleSpec(rounds=cfg.rounds, rho=1.0))


def single_machine_plan(cfg: DistConfig) -> TrainPlan:
    """Centralized full-graph reference (Figure 4's dashed baseline)."""
    specs = cfg.specs()
    return _plan(cfg, (local_steps(reset_opt=False),), "single",
                 comm=CommSpec(num_machines=1, partition_method="random"),
                 sampler=dataclasses.replace(specs["sampler"],
                                             full_graph=True),
                 schedule=ScheduleSpec(rounds=cfg.rounds, rho=1.0))
