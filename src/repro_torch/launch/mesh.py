"""Machine meshes: one process per machine over ``torch.distributed``, and
the production meshes of the sharded LM steps.

The counterpart of the JAX package's host mesh for the GNN engine's
``shard_map`` backend.  Where the reference binds one device per machine on
a ``('machine',)`` mesh axis and lowers the round with ``shard_map``, the
port runs one process per machine: rank ``p`` of a process group is machine
``p``, holds only that machine's round inputs on its device, and meets the
other ranks only in the collectives of :class:`MachineMesh` — the
parameter all-reduce, the all-gather of compressed payloads, the per-step
gradient all-reduce and halo all-gather, and the lead rank's broadcast of
the corrected parameters.

The process group runs gloo, which takes CUDA tensors (it stages them
through host memory itself) and, unlike NCCL, lets several ranks share one
card.  :func:`launch_machines` starts a group: the calling process is rank
0 and ranks 1..P-1 are spawned processes; the rendezvous is a file
(``init_method="file://…"``), so concurrent launches never race for a
port.

:func:`make_production_mesh` builds the JAX package's production meshes,
(16, 16) ``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``,
as a ``DeviceMesh`` over the default process group (a real one of 256 or
512 ranks, or the dry run's fake one).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import signal
import tempfile
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

#: Seconds a rank waits in the rendezvous or in one collective before the
#: run fails.
DEFAULT_TIMEOUT_S = 300.0


def machine_device(device, rank: int) -> torch.device:
    """The device of machine ``rank``: ``"cuda"`` spreads the ranks over
    the visible cards round-robin (all on ``cuda:0`` with one card); an
    explicit index or ``"cpu"`` is taken as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


@dataclasses.dataclass
class MachineMesh:
    """One rank's view of the machine group: its machine index ``rank``,
    the number of machines ``size`` and its ``device``.

    ``wire_bytes`` sums, per kind of traffic, the bytes this rank hands to
    the collectives (its operand, once per call): ``"averaging"`` (the
    parameter or compressed-delta payload), ``"halo"`` (the send buffer),
    ``"gradients"`` (the per-step gradient all-reduce), ``"lead"`` (the
    corrected parameters and the evaluation the lead rank sends), ``"loss"``
    (the step losses) and ``"state"`` (per-machine state gathered for a
    checkpoint).  The first three are the traffic the trainer's byte
    accounting prices.
    """

    rank: int
    size: int
    device: torch.device
    wire_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def rows(self, stacked):
        """This machine's rows of a ``(P, …)`` machine stack: a stack of
        one."""
        return stacked[self.rank: self.rank + 1]

    def _count(self, kind: str, flat: torch.Tensor) -> None:
        self.wire_bytes[kind] = (self.wire_bytes.get(kind, 0)
                                 + flat.numel() * flat.element_size())

    @staticmethod
    def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in tensors])

    @staticmethod
    def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        parts = flat.split([t.numel() for t in like])
        return [p.view(t.shape) for p, t in zip(parts, like)]

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor],
                        kind: str) -> List[torch.Tensor]:
        """The mean over machines of each tensor (one f32 all-reduce of
        the tensors packed into one buffer, then a division by P)."""
        flat = self._flat(tensors)
        self._count(kind, flat)
        dist.all_reduce(flat)
        return self._split(flat / self.size, tensors)

    def all_gather(self, tensors: Sequence[torch.Tensor],
                   kind: str) -> List[torch.Tensor]:
        """Every machine's copy of each tensor, concatenated machine-major
        along dim 0 (a ``(1, …)`` slice becomes the ``(P, …)`` stack).  One
        all-gather of the tensors packed into one buffer; all must share a
        dtype, which travels as its bytes (gloo moves no 16-bit integers,
        and a gather needs no arithmetic)."""
        flat = self._flat(tensors)
        self._count(kind, flat)
        wire = flat.view(torch.uint8)
        outs = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(outs, wire)
        per_rank = [self._split(o.view(flat.dtype), tensors) for o in outs]
        return [torch.cat([r[i] for r in per_rank])
                for i in range(len(tensors))]

    def broadcast(self, tensors: Sequence[torch.Tensor],
                  kind: str = "lead") -> List[torch.Tensor]:
        """The lead rank's tensors on every rank (one broadcast of one
        packed buffer of a single dtype)."""
        flat = self._flat(tensors).contiguous()
        if self.is_lead:
            self._count(kind, flat)
        dist.broadcast(flat, 0)
        return self._split(flat, tensors)

    def gather_wire_bytes(self) -> List[Dict[str, int]]:
        """Every rank's :attr:`wire_bytes`, in rank order (collective)."""
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, dict(self.wire_bytes))
        return out


def init_machine_mesh(rank: int, size: int, init_file: str, device="cuda",
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> MachineMesh:
    """Join the gloo group of ``size`` machines as ``rank``; a rank that
    cannot join within ``timeout_s`` raises."""
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    return MachineMesh(rank=rank, size=size,
                       device=machine_device(device, rank))


def _die_with_parent() -> None:
    """Ask Linux to SIGKILL this process when its parent dies, so a rank
    never outlives the run (a SIGKILLed lead rank included)."""
    try:
        import ctypes
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except OSError:
        pass


def _rank_main(rank: int, size: int, init_file: str, device: str,
               deterministic: bool, timeout_s: float, parent: int,
               fn: Callable, args: tuple) -> None:
    _die_with_parent()
    if os.getppid() != parent:
        os._exit(1)                      # the parent died before prctl
    torch.set_num_threads(1)
    if deterministic:
        torch.use_deterministic_algorithms(True)
    mesh = init_machine_mesh(rank, size, init_file, device, timeout_s)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def launch_machines(fn: Callable, num_machines: int, *args,
                    device="cuda", deterministic: bool = False,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run ``fn(mesh, *args)`` on ``num_machines`` ranks and return rank
    0's result.

    The calling process is rank 0; ranks 1..P-1 are spawned processes
    (``fn`` and ``args`` must pickle: a module-level function, and data,
    models and plans without lambdas).  Every rank runs with one CPU thread
    and, with ``deterministic``, under
    ``torch.use_deterministic_algorithms(True)``.  Raises if any rank
    fails or cannot join the group.
    """
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="machines-")
    init_file = os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, num_machines, init_file, str(device),
                               deterministic, timeout_s, os.getpid(), fn,
                               args))
             for r in range(1, num_machines)]
    threads = torch.get_num_threads()
    was_det = torch.are_deterministic_algorithms_enabled()
    try:
        for p in procs:
            p.start()
        torch.set_num_threads(1)
        if deterministic:
            torch.use_deterministic_algorithms(True)
        mesh = init_machine_mesh(0, num_machines, init_file, device,
                                 timeout_s)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        for r, p in enumerate(procs, 1):
            p.join(timeout_s)
            if p.exitcode != 0:
                raise RuntimeError(f"machine rank {r} failed "
                                   f"(exit code {p.exitcode})")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(was_det)
        shutil.rmtree(tmp, ignore_errors=True)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The LM trainer's machine grid on this host: ``shape`` maps the
    JAX package's axis names (``"data"``, ``"model"``) to their sizes, and
    every LLCG copy lives on ``device``."""

    shape: Dict[str, int]
    device: torch.device


def make_host_mesh(model_parallel: int = 1, device="cuda") -> HostMesh:
    """Whatever this host has, as the JAX package's ``make_host_mesh``:
    the devices of ``device``'s type (the visible cards, or the one CPU)
    split into ``data`` × ``model`` = n / model_parallel × model_parallel.
    The trainer's LLCG group axis is ``data``."""
    dev = torch.device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} {dev.type} device(s) do not split into "
                         f"model_parallel={model_parallel}")
    return HostMesh(shape={"data": n // model_parallel,
                           "model": model_parallel}, device=dev)


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production mesh as a ``DeviceMesh`` over the first 256 (or 512)
    ranks of the default process group; raises, naming the world size it
    needs, where there is no group or it has too few ranks (as the JAX
    package's raises where the host has too few devices)."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return make_device_mesh(shape, names, device_type)


def make_device_mesh(shape, names, device_type="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the first
    ranks of the default process group (rank-major: the last axis
    fastest)."""
    from torch.distributed.device_mesh import DeviceMesh
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"a {'×'.join(map(str, shape))} mesh needs a process group of "
            f"{need} ranks (world size {need}); "
            + (f"this one has {have}" if have else "none is initialized"))
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))
