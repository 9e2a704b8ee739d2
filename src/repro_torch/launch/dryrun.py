"""The dry run: trace every (arch × shape × mesh) case's per-device program
on a fake process group, with nothing allocated — the port of the JAX
package's ``launch/dryrun.py``.

For each case the dry run:
  1. opens a fake process group of 256 (16×16) or 512 (2×16×16) ranks
     (torch's ``"fake"`` backend: collectives return at once) and builds
     the production mesh over it (:func:`~repro_torch.launch.mesh.
     make_production_mesh`);
  2. builds the shape kind's step with that mesh
     (:mod:`repro_torch.distributed.steps`):
       train_4k    → the LLCG round step (K local steps, the average over
                     the group axis, S server corrections), or the
                     synchronous step (``--variant sync``),
       prefill_32k → the prefill forward,
       decode_*    → one decode step against caches laid out by
                     :func:`_state_pspecs`;
  3. runs rank 0's program once on fake tensors of its local shard shapes
     (``FakeTensorMode``): "lowering" is this trace and ``lower_s`` its
     time; there is nothing to compile (``compile_s`` stays 0);
  4. records per-device collective bytes (counted where the program calls
     the collectives: :class:`~repro_torch.distributed.tensor_parallel.
     ShardComm`), FLOPs (``torch.utils.flop_counter.FlopCounterMode`` over
     the local-shard ops: matmuls, convolutions and attention only, where
     XLA's ``cost_analysis`` also counts elementwise work, so the two do
     not compare) and memory: the arguments' and outputs' local bytes, and
     ``temp_size_in_bytes``, the peak of live fake storage beyond the
     arguments during the trace.

The group is created inside :func:`run_case` and destroyed after it; a run
refuses to start while a real group is up.  Importing this module sets
nothing (the JAX module sets ``XLA_FLAGS``).  The fake tensors are CPU
tensors; the scan kernels' wrappers take them to two shape-only stand-in
ops (:func:`repro_torch.kernels.linear_scan.is_traced`) whose outputs are
the kernels' and whose FLOPs are the chunked form's.  Phase DW of
``chip_smoke.py`` runs the same program on real ranks on the card
(:func:`real_round`) and holds its bytes to this trace's.

:func:`run_gnn_engine_case` traces rank 0's round of the GNN engine's
``shard_map`` backend (:class:`~repro_torch.core.engine.RoundProgram` on a
:class:`~repro_torch.launch.mesh.MachineMesh`) on a fake group of
``num_machines`` ranks, on the JAX case's graph.

:func:`roofline_terms` prices a case with the H100 SXM 80 GB's datasheet
figures (never a TPU's): dense BF16 tensor-core peak, HBM3 bandwidth,
NVLink per GPU for intra-group bytes and the network per GPU for
inter-group bytes.  A 16-wide ``model`` axis spans two 8-GPU NVLink nodes,
so the NVLink figure is optimistic for it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gnn-round
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES, TensorSpec, get_config,
                                 get_long_context_config, prefill_batch_specs,
                                 shape_supported, train_batch_specs)
from repro_torch.distributed.sharding import (_axes_of, _fix_divisibility,
                                              axis_sizes,
                                              batch_pspec, group_axis_for,
                                              local_shape, local_shard,
                                              param_pspecs)
from repro_torch.distributed.tensor_parallel import KINDS
from repro_torch.distributed.steps import (LLCGStepConfig,
                                           build_decode_step,
                                           build_llcg_round_step,
                                           build_prefill_step,
                                           build_sync_train_step)
from repro_torch.launch.mesh import MachineMesh
from repro_torch.models.transformer.model import LM
from repro_torch.optim import adamw
from repro_torch.utils.logging import get_logger
from repro_torch.utils.pytree import tree_leaves, tree_map

log = get_logger("repro_torch.dryrun")

# ----------------------------------------------------------- the hardware
#: NVIDIA H100 SXM 80 GB datasheet figures.
PEAK_FLOPS = 989e12          # dense BF16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
HBM_BYTES = 80e9             # device memory
NVLINK_BW = 450e9            # NVLink bytes/s per GPU, one direction
NETWORK_BW = 50e9            # 400 Gb/s network per GPU, bytes/s

# ------------------------------------------------------------ state rules
def _state_pspecs(state_shapes, cfg, mesh) -> Any:
    """Sharding rules for decode caches and states (the JAX package's):
    batch over the data axes; a cache's KV heads on ``model`` where it
    divides them, else its ``head_dim``; a recurrent state's fused
    batch·heads over the data axes and ``model``; a conv state's channels
    on ``model``."""
    names = axis_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    daxis = data_axes if len(data_axes) > 1 else data_axes[0]

    def one(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        if name in ("k", "v") and nd >= 4:
            kv_dim, hd_dim = leaf.shape[nd - 2], leaf.shape[nd - 1]
            msize = names["model"]
            if kv_dim % msize == 0:
                spec = [None] * (nd - 4) + [daxis, None, "model", None]
            elif hd_dim % msize == 0:
                spec = [None] * (nd - 4) + [daxis, None, None, "model"]
            else:
                spec = [None] * (nd - 4) + [daxis, None, None, None]
        elif name == "h" and nd >= 3:
            spec = [None] * (nd - 3) + [tuple(data_axes) + ("model",), None,
                                        None]
        elif name == "conv" and nd >= 3:
            spec = [None] * (nd - 3) + [daxis, None, "model"]
        elif name in ("k_scale", "v_scale") and nd >= 3:
            spec = [None] * (nd - 3) + [daxis, None, None]
        elif name in ("x_att", "x_ffn", "emb0_last") and nd >= 3:
            spec = [None] * (nd - 3) + [daxis, None, None]
        else:
            spec = [None] * nd
        return _fix_divisibility(tuple(spec), leaf.shape, mesh)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return one(path, tree)
    return walk(state_shapes, ())


def state_specs(model: LM, batch: int, max_seq: int) -> Dict:
    """``model.init_states``' tree as :class:`TensorSpec` leaves (drawn on fake
    tensors: nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        states = model.init_states({"embed": torch.empty(0)}, batch, max_seq)
        return tree_map(lambda x: TensorSpec(tuple(x.shape), x.dtype),
                        states)


# ----------------------------------------------------------------- results
@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    variant: str
    ok: bool
    error: Optional[str] = None
    lower_s: float = 0.0
    compile_s: float = 0.0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective: Dict[str, Any] = dataclasses.field(default_factory=dict)
    memory: Dict[str, float] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Case:
    """A built case: the step, its arguments (:class:`_Arg` trees, or plain
    Python values), and the mesh."""
    step: Any
    args: Tuple[Any, ...]
    mesh: Any


@dataclasses.dataclass
class _Arg:
    """One tensor-tree argument: its global :class:`TensorSpec` leaves and the
    partition specs that cut it; ``adam`` makes it the port's Adam state
    over such a tree (a step count and two f32 moments)."""
    specs: Any
    pspecs: Any
    adam: bool = False

    def local(self, mesh):
        return tree_map(lambda s, p: TensorSpec(
            local_shape(s.shape, p, mesh),
            torch.float32 if self.adam else s.dtype), self.specs, self.pspecs)

    def nbytes(self, mesh) -> int:
        one = sum(math.prod(s.shape) * torch.empty(0, dtype=s.dtype)
                  .element_size() for s in tree_leaves(self.local(mesh)))
        return 2 * one if self.adam else one

    def materialize(self, mesh):
        """Local fake tensors (inside a ``FakeTensorMode``)."""
        tree = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                        self.local(mesh))
        if not self.adam:
            return tree
        from repro_torch.optim.optimizers import _AdamState
        return _AdamState(step=0, mu=tree, nu=tree_map(torch.zeros_like,
                                                       tree))


# --------------------------------------------------------------- the cases
def build_case(arch: str, shape_name: str, mesh, variant: str = "llcg",
               llcg_k: int = 2, llcg_s: int = 1, remat: bool = True,
               cfg_override=None, unroll: bool = False,
               expert_hint: bool = False, avg_bf16: bool = False,
               serve_params_dtype: str = "float32",
               global_batch: Optional[int] = None,
               seq_len: Optional[int] = None) -> Case:
    """The case's per-rank step on ``mesh`` and its abstract arguments.
    ``unroll`` is accepted for the JAX CLI's sake and means nothing here:
    eager torch runs every layer.  ``global_batch`` / ``seq_len`` override
    the shape's (the real-group checks use small ones)."""
    from repro_torch.distributed.hints import set_hint
    names = axis_sizes(mesh)
    set_hint("expert_axis", "model" if expert_hint else None)
    set_hint("expert_axis_size", names["model"] if expert_hint else 0)
    shp = SHAPES[shape_name]
    gb = global_batch or shp.global_batch
    sl = seq_len or shp.seq_len
    cfg = cfg_override
    if cfg is None:
        cfg = (get_long_context_config(arch) if shape_name == "long_500k"
               else get_config(arch))
    model = LM(cfg)
    pshapes = model.param_specs()
    pspec = param_pspecs(pshapes, cfg, mesh)

    if shp.kind == "train":
        opt = adamw(1e-3)
        if variant == "sync":
            batch = train_batch_specs(cfg, gb, sl)
            bspec = tree_map(lambda _: batch_pspec(mesh), batch)
            step = build_sync_train_step(model, opt, remat=remat, mesh=mesh)
            return Case(step, (_Arg(pshapes, pspec),
                               _Arg(pshapes, pspec, adam=True),
                               _Arg(batch, bspec)), mesh)
        gaxis = group_axis_for(mesh)
        G = names[gaxis]
        stack = lambda tree, lead: tree_map(
            lambda s: TensorSpec(tuple(lead) + s.shape, s.dtype), tree)
        pspec_G = param_pspecs(pshapes, cfg, mesh, group_axis=gaxis)
        lb = train_batch_specs(cfg, gb // G, sl)
        local_batch = stack(lb, (G, llcg_k))
        lbspec = tree_map(lambda _: batch_pspec(mesh, stacked_group=True,
                                                extra_leading=1), lb)
        cb = train_batch_specs(cfg, gb, sl)
        corr_batch = stack(cb, (llcg_s,))
        cbspec = tree_map(lambda _: batch_pspec(mesh, extra_leading=1), cb)
        step = build_llcg_round_step(
            model, adamw(1e-3), adamw(5e-4),
            LLCGStepConfig(num_groups=G, local_steps=llcg_k,
                           correction_steps=llcg_s, remat=remat,
                           avg_bf16=avg_bf16), mesh=mesh)
        return Case(step, (_Arg(stack(pshapes, (G,)), pspec_G),
                           _Arg(stack(pshapes, (G,)), pspec_G, adam=True),
                           _Arg(pshapes, pspec, adam=True),
                           _Arg(local_batch, lbspec),
                           _Arg(corr_batch, cbspec)), mesh)

    if serve_params_dtype != "float32":
        pshapes = tree_map(lambda s: TensorSpec(
            s.shape, getattr(torch, serve_params_dtype)), pshapes)
    params = _Arg(pshapes, pspec)
    if shp.kind == "prefill":
        batch = prefill_batch_specs(cfg, gb, sl)
        bspec = tree_map(lambda _: batch_pspec(mesh), batch)
        sspecs = state_specs(model, gb, sl)
        step = build_prefill_step(model, max_seq=sl, mesh=mesh,
                                  state_specs=_state_pspecs(sspecs, cfg,
                                                            mesh))
        return Case(step, (params, _Arg(batch, bspec)), mesh)

    sshapes = state_specs(model, gb, sl)
    sspec = _state_pspecs(sshapes, cfg, mesh)
    daxes = tuple(a for a in ("pod", "data") if a in names)
    split = gb % math.prod(names[a] for a in daxes) == 0
    tok = TensorSpec((gb,), torch.int32)
    tok_spec = ((daxes if len(daxes) > 1 else daxes[0]),) if split else (None,)
    step = build_decode_step(model, max_seq=sl, mesh=mesh, state_specs=sspec,
                             token_sharded=split)
    return Case(step, (params, _Arg(sshapes, sspec), _Arg(tok, tok_spec),
                       sl - 1), mesh)


# --------------------------------------------------------- fake execution
@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit; refused while a real group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs no process group to be up: "
                           "one is initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _LiveBytes:
    """Peak bytes of live storage created while active: every new storage
    an op returns is counted until the tensor that owns it is freed."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        tracker = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in _tensors(out):
                    tracker._add(t)
                return out

        self.mode = Mode()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _tensors(o)


def _out_bytes(out) -> int:
    total = 0
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


def trace_case(case: Case, res: DryrunResult) -> DryrunResult:
    """Run the case's step on rank 0's fake local shards and record its
    trace time, FLOPs, collective bytes and memory into ``res``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    mesh = case.mesh
    tensors = [a for a in case.args if isinstance(a, _Arg)]
    res.memory["argument_size_in_bytes"] = float(
        sum(a.nbytes(mesh) for a in tensors))
    with FakeTensorMode():
        args = [a.materialize(mesh) if isinstance(a, _Arg) else a
                for a in case.args]
        case.step.comm.reset()
        counter = FlopCounterMode(display=False)
        live = _LiveBytes()
        t0 = time.perf_counter()
        with counter, live:
            out = case.step(*args)
        res.lower_s = time.perf_counter() - t0
        res.memory["output_size_in_bytes"] = float(_out_bytes(out))
        res.memory["temp_size_in_bytes"] = float(live.peak)
        res.flops = float(counter.get_total_flops())
        res.collective = case.step.comm.summary()
        del out, args
    return res


def run_case(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "llcg", llcg_k: int = 2, llcg_s: int = 1,
             remat: bool = True, cfg_override=None, keep_hlo: bool = False,
             unroll: bool = False, expert_hint: bool = False,
             avg_bf16: bool = False, serve_params_dtype: str = "float32",
             mesh_shape: Optional[Sequence[int]] = None,
             global_batch: Optional[int] = None,
             seq_len: Optional[int] = None) -> DryrunResult:
    """Trace one case on a fake group of the production mesh's size (or of
    ``mesh_shape``, axes as the production mesh of that rank count);
    failures are recorded in the result, never raised.  ``keep_hlo`` is
    the JAX CLI's and means nothing here."""
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_device_mesh
    shape, names = PRODUCTION_SHAPES[multi_pod]
    if mesh_shape is not None:
        shape = tuple(mesh_shape)
        names = names[-len(shape):] if len(shape) <= len(names) else names
    mesh_name = "x".join(map(str, shape))
    res = DryrunResult(arch=arch, shape=shape_name, mesh=mesh_name,
                       variant=variant, ok=False)
    res.meta.update(llcg_k=llcg_k, llcg_s=llcg_s, remat=remat, unroll=unroll)
    try:
        with fake_group(math.prod(shape)):
            mesh = make_device_mesh(shape, names, device_type="cpu")
            case = build_case(arch, shape_name, mesh, variant=variant,
                              llcg_k=llcg_k, llcg_s=llcg_s, remat=remat,
                              cfg_override=cfg_override, unroll=unroll,
                              expert_hint=expert_hint, avg_bf16=avg_bf16,
                              serve_params_dtype=serve_params_dtype,
                              global_batch=global_batch, seq_len=seq_len)
            trace_case(case, res)
            res.ok = True
    except Exception as e:  # noqa: BLE001
        res.error = f"{type(e).__name__}: {e}"[:2000]
    return res


# ---------------------------------------------------- a real group's round
def real_round(machine, cfg, mesh_shape: Sequence[int], *, global_batch: int,
               seq_len: int, llcg_k: int = 2, llcg_s: int = 1,
               lr: float = 1e-3, server_lr: float = 5e-4, seed: int = 0,
               device="cuda", tol: float = 2e-4,
               first_grads: bool = False) -> Optional[list]:
    """The sharded LLCG round on this rank of a real group (a
    :class:`~repro_torch.launch.mesh.MachineMesh` rank of
    :func:`~repro_torch.launch.mesh.launch_machines`), held to the unsharded
    round on the same inputs.

    Every rank draws the weights of ``cfg`` (``LM.init(seed)``) and the
    batches (``seed``; ``global_batch`` rows a correction step and
    ``global_batch / G`` a group's local step), keeps its blocks under the
    dry run's specs on ``mesh_shape`` (``data`` × ``model``) and runs the
    sharded round on ``device``; rank 0 then gathers every rank's blocks,
    runs the unsharded round on the whole model there once (ranks may
    share a card) and compares each rank's blocks leaf by leaf: per leaf
    the max |sharded − unsharded| and its scale ``max(1, max
    |unsharded|)``, the elements beyond ``tol + tol·|unsharded|``
    (``off``), and ``update_err``, the norm of the difference of the two
    rounds' updates over the norm of the unsharded update.  With
    ``first_grads`` each such element is also checked to have a gradient
    within ``GRAD_FLOOR`` of zero at one of the round's Adam first steps
    (whose sign, and so the element's ±lr move, is undetermined:
    ``undetermined_ok``, and ``off_determined`` counts the elements that
    are not), and each
    rank's gradient of its group's first local step on its shards is held
    to the unsharded one (``grad_err``, the largest difference over the
    leaf's largest gradient: Adam's updates do not see a gradient's
    scale, this does).

    Returns, on rank 0, every rank's record in rank order: ``coord``, the
    sharded round's ``collective`` summary and scan-kernel ``launches``,
    both rounds' losses and the per-leaf comparison; None on the others.
    """
    import numpy as np

    from repro_torch.kernels.linear_scan import (linear_scan_chunked,
                                                 linear_scan_chunked_bwd)
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_device_mesh

    dev = machine.device
    names = PRODUCTION_SHAPES[False][1][-len(mesh_shape):]
    mesh = make_device_mesh(tuple(mesh_shape), names, dev.type)
    sizes = axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    G = sizes["data"]
    model = LM(cfg)
    full = model.init(seed, "cpu")
    shapes = model.param_specs()
    pspec = param_pspecs(shapes, cfg, mesh)
    pspec_G = param_pspecs(shapes, cfg, mesh, group_axis="data")
    block = lambda x, sp: local_shard(x, sp, mesh, coord)
    rng = np.random.default_rng(seed)
    ints = lambda *shape: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape).astype(np.int32))
    b_local = global_batch // G
    local = {"tokens": ints(G, llcg_k, b_local, seq_len),
             "labels": ints(G, llcg_k, b_local, seq_len)}
    corr = {"tokens": ints(llcg_s, global_batch, seq_len),
            "labels": ints(llcg_s, global_batch, seq_len)}
    lspec = batch_pspec(mesh, stacked_group=True, extra_leading=1)
    cspec = batch_pspec(mesh, extra_leading=1)
    on = lambda tree: {k: v.to(dev) for k, v in tree.items()}
    step_cfg = LLCGStepConfig(num_groups=G, local_steps=llcg_k,
                              correction_steps=llcg_s)

    stacked = lambda p: tree_map(lambda x: x.unsqueeze(0).expand(
        G, *x.shape).clone(), p)
    p_G = tree_map(lambda x, sp: block(x, sp).to(dev), stacked(full),
                   pspec_G)
    server = adamw(server_lr).init(tree_map(lambda x, sp: block(x, sp).to(
        dev), full, pspec))
    step = build_llcg_round_step(model, adamw(lr), adamw(server_lr),
                                 step_cfg, mesh=mesh)
    for k in (linear_scan_chunked, linear_scan_chunked_bwd):
        k.launches = 0
    step.comm.reset()
    out_G, _, _, metrics = step(
        p_G, adamw(lr).init(p_G), server,
        on({k: block(v, lspec) for k, v in local.items()}),
        on({k: block(v, cspec) for k, v in corr.items()}))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    record = {"coord": coord, "collective": step.comm.summary(),
              "launches": {k.__name__: k.launches for k in (
                  linear_scan_chunked, linear_scan_chunked_bwd)},
              "losses": {k: float(v) for k, v in metrics.items()}}
    record["got"] = tree_map(lambda x: x.cpu(), out_G)
    del out_G, p_G, server, step
    if first_grads:
        from repro_torch.distributed.steps import (_sharded_value_and_grad,
                                                   _shard)
        tp = _shard(model, mesh, [a for a in _axes_of(lspec[-1])])
        g = coord["data"]
        first = {k: block(v[g, 0], lspec[2:]).to(dev)
                 for k, v in local.items()}
        grads = _sharded_value_and_grad(
            model, tp, tree_map(lambda x, sp: block(x, sp).to(dev), full,
                                pspec), first, remat=False)[1]
        record["grad"] = tree_map(lambda x: x.cpu(), grads)
        del grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # every rank's blocks to rank 0, which runs the unsharded round once
    # (ranks sharing a card could not each hold the whole model)
    records = [None] * dist.get_world_size() if dist.get_rank() == 0 \
        else None
    dist.gather_object(record, records, dst=0)
    if dist.get_rank() != 0:
        return None
    _held_to_unsharded(records, model, full, dev, pspec, pspec_G, mesh,
                       stacked, local, corr, on, step_cfg, lr, server_lr,
                       tol, first_grads)
    return records


def _held_to_unsharded(records, model, full, dev, pspec, pspec_G, mesh,
                       stacked, local, corr, on, step_cfg, lr, server_lr,
                       tol, first_grads) -> None:
    """:func:`real_round`'s comparison: the unsharded round on ``dev``
    and, leaf by leaf, each record's blocks (``got``, replaced by the
    comparison) against the blocks of it at the record's coordinate."""
    from repro_torch.distributed.steps import value_and_grad
    G = step_cfg.num_groups
    params = tree_map(lambda x: x.to(dev), full)
    ref = build_llcg_round_step(model, adamw(lr), adamw(server_lr), step_cfg)
    ref_G, _, _, ref_m = ref(stacked(params), adamw(lr).init(stacked(params)),
                             adamw(server_lr).init(params), on(local),
                             on(corr))
    firsts = []
    if first_grads:
        # each group's first local step, and the server's first step at
        # the average (a round whose server moves nothing)
        for g in range(G):
            firsts.append(value_and_grad(model.loss, params, on(
                {k: v[g, 0] for k, v in local.items()}))[1])
        still = build_llcg_round_step(model, adamw(lr), adamw(0.0), step_cfg)
        avg_G = still(stacked(params), adamw(lr).init(stacked(params)),
                      adamw(0.0).init(params), on(local), on(corr))[0]
        avg = tree_map(lambda x: x[0], avg_G)
        firsts.append(value_and_grad(model.loss, avg, on(
            {k: v[0] for k, v in corr.items()}))[1])
    for rec in records:
        got, coord = rec.pop("got"), rec["coord"]
        grad = rec.pop("grad", None)
        block = lambda x, sp: local_shard(x, sp, mesh, coord)
        leaves = {}
        for path, want in _leaf_paths(ref_G):
            w = block(want, _get(pspec_G, path)).float()
            diff = (_get(got, path).to(dev).float() - w).abs()
            off = diff > tol + tol * w.abs()
            start = _get(params, path)
            update = w - block(start.expand(G, *start.shape),
                               _get(pspec_G, path)).float()
            info = {"err": float(diff.max()), "scale": max(1.0, float(
                w.abs().max())), "off": int(off.sum()), "n": w.numel(),
                "update_err": float(diff.norm() / update.norm().clamp_min(
                    1e-30))}
            if firsts:
                und = torch.zeros(off.shape[1:], dtype=torch.bool,
                                  device=dev)
                for gr in firsts:
                    gl = block(_get(gr, path), _get(pspec, path))
                    und |= gl.abs() <= GRAD_FLOOR * _get(gr, path).abs().max()
                info["undetermined_ok"] = bool(und[off.any(dim=0)].all())
                info["off_determined"] = int((off.any(dim=0) & ~und).sum())
                want_g = _get(firsts[coord["data"]], path)
                gl = block(want_g, _get(pspec, path)).float()
                info["grad_err"] = float(
                    (_get(grad, path).to(dev).float() - gl).abs().max()
                    / want_g.abs().max().clamp_min(1e-30))
            leaves["/".join(path)] = info
        rec["ref_losses"] = {k: float(v) for k, v in ref_m.items()}
        rec["leaves"] = leaves

#: The gradient floor under which an Adam first step's sign is undetermined
#: (``tests/test_torch_llcg_steps.py``'s rule).
GRAD_FLOOR = 2e-4


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------ the GNN case
@dataclasses.dataclass
class _CountingMachineMesh(MachineMesh):
    """A :class:`~repro_torch.launch.mesh.MachineMesh` whose collectives
    also count their per-device result bytes (the JAX dry run's unit), by
    collective and by kind of traffic."""
    result_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)

    def all_reduce_mean(self, tensors, kind):
        self._result(2 * _nbytes(tensors), "all-reduce", kind)
        return super().all_reduce_mean(tensors, kind)

    def all_gather(self, tensors, kind):
        self._result(self.size * _nbytes(tensors), "all-gather", kind)
        return super().all_gather(tensors, kind)

    def broadcast(self, tensors, kind="lead"):
        self._result(_nbytes(tensors), "collective-permute", kind)
        return super().broadcast(tensors, kind)

    def _result(self, nbytes, op, kind):
        self.result_bytes[op] = self.result_bytes.get(op, 0) + nbytes
        key = f"{op}:{kind}"
        self.by_kind[key] = self.by_kind.get(key, 0) + nbytes


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def build_gnn_engine_case(num_machines: int = 16, num_nodes: int = 4096,
                          feature_dim: int = 64, num_classes: int = 16,
                          hidden_dim: int = 64, local_k: int = 4,
                          batch_size: int = 64, fanout: int = 16,
                          mode: str = "local",
                          halo_compression: str = "none"):
    """Rank 0's GNN engine round (``shard_map`` backend) and its inputs, as
    the JAX package's case builds them: a GG model, K local steps of
    ``batch_size`` nodes at ``fanout``; ``mode="halo"`` partitions the JAX
    case's SBM graph (bfs, seed 0) to get a real
    :class:`~repro_torch.graph.halo.HaloProgram` and its byte accounting.
    Call inside a (fake) group of ``num_machines`` ranks.  Returns
    ``(run, mesh, meta)``: ``run()`` executes the round."""
    from repro_torch.core.engine import EngineConfig, RoundInputs, RoundProgram
    from repro_torch.models.gnn import build_model
    from repro_torch.optim import adam

    mesh = _CountingMachineMesh(rank=0, size=num_machines,
                                device=torch.device("cpu"))
    model = build_model("GG", feature_dim, num_classes, hidden_dim=hidden_dim)
    engine_mode = "halo" if mode == "halo" else "local"
    program = RoundProgram(
        model, adam(1e-2), None,
        EngineConfig(num_machines=num_machines, mode=engine_mode,
                     backend="shard_map", with_correction=False,
                     halo_compression=halo_compression), mesh=mesh)
    params = model.init(0, device="cpu")
    state = program.init_state(params)
    K = local_k
    meta: Dict[str, Any] = {"engine_mode": engine_mode, "exchanges": 0}
    halo_tabs = {}
    if mode == "halo":
        from repro_torch.graph import sbm_graph
        from repro_torch.graph.halo import build_halo_program, ext_fanout
        from repro_torch.graph.partition import partition_graph
        data = sbm_graph(num_nodes=num_nodes, num_classes=num_classes,
                         feature_dim=feature_dim, feature_snr=0.3,
                         homophily=0.9, seed=0)
        part = partition_graph(data.graph, num_machines, method="bfs",
                               seed=0)
        halo = build_halo_program(data.graph, part)
        n_max = halo.n_ext_pad
        fanout = ext_fanout(halo.plan, fanout)
        meta.update(
            halo_max_send=halo.max_send, halo_max_halo=halo.max_halo,
            halo_compression=halo_compression, exchanges=K,
            halo_bytes_per_step=halo.halo_bytes(
                feature_dim, compression=halo_compression),
            exchange_bytes_per_step=halo.exchange_bytes(
                feature_dim, compression=halo_compression),
            expected_all_gather_bytes=halo.gathered_bytes_per_device(
                feature_dim, compression=halo_compression))
        i32 = lambda n: torch.zeros((1, n), dtype=torch.int32)
        halo_tabs = dict(halo_send_idx=i32(halo.max_send),
                         halo_recv_idx=i32(halo.max_halo),
                         halo_dest_idx=i32(halo.max_halo),
                         halo_recv_valid=torch.zeros((1, halo.max_halo)))
    else:
        n_max = num_nodes // num_machines
    feats = torch.zeros((1, n_max, feature_dim))
    labels = torch.zeros((1, n_max), dtype=torch.int32)
    inputs = RoundInputs(
        tables=torch.zeros((1, K, n_max, fanout), dtype=torch.int32),
        masks=torch.zeros((1, K, n_max, fanout)),
        batches=torch.zeros((1, K, batch_size), dtype=torch.int32),
        bmasks=torch.zeros((1, K, batch_size)), **halo_tabs)

    def run():
        return program.run_round(state, feats, labels, inputs)
    return run, mesh, meta


def run_gnn_engine_case(num_machines: int = 16, mode: str = "local",
                        **kw) -> DryrunResult:
    """Trace rank 0's GNN engine round on a fake group of ``num_machines``
    ranks.  ``collective`` holds every collective's per-device result
    bytes; ``meta["all_gather_bytes_per_exchange"]`` is the all-gather's
    bytes for one halo exchange (the round runs K), the unit the JAX
    package's HLO count gives (its loop body is lowered once), and
    ``halo_bytes_match`` holds it to
    ``HaloProgram.gathered_bytes_per_device`` (equal up to padding, as the
    JAX check)."""
    from torch.utils.flop_counter import FlopCounterMode
    res = DryrunResult(arch="gnn-engine",
                       shape="round" if mode == "local" else "round-halo",
                       mesh=f"machine{num_machines}",
                       variant="llcg" if mode == "local" else "ggs-halo",
                       ok=False)
    try:
        with fake_group(num_machines):
            run, mesh, meta = build_gnn_engine_case(num_machines, mode=mode,
                                                    **kw)
            res.meta.update(meta)
            counter = FlopCounterMode(display=False)
            t0 = time.perf_counter()
            with counter:
                run()
            res.lower_s = time.perf_counter() - t0
            res.flops = float(counter.get_total_flops())
            kinds = dict(mesh.result_bytes)
            res.collective = {k: float(kinds.get(k, 0)) for k in KINDS}
            res.collective["total"] = float(sum(kinds.values()))
            res.collective["inter_group"] = res.collective["total"]
            res.collective["intra_group"] = 0.0
            res.collective["by_span"] = {"machine": res.collective["total"]}
            res.meta["by_traffic"] = dict(mesh.by_kind)
            per = float(mesh.by_kind.get("all-gather:halo", 0)) / max(
                meta["exchanges"], 1)
            res.meta["all_gather_bytes_per_exchange"] = per
            if mode == "halo":
                want = meta["expected_all_gather_bytes"]
                res.meta["measured_all_gather_bytes"] = per
                res.meta["halo_bytes_match"] = bool(
                    per > 0 and want <= per <= 1.25 * want)
            res.ok = True
    except Exception as e:  # noqa: BLE001
        res.error = f"{type(e).__name__}: {e}"[:2000]
    return res


# ---------------------------------------------------------------- roofline
def roofline_terms(res: DryrunResult, chips: int) -> Dict[str, float]:
    """The three roofline terms of a step, in seconds, on H100 SXM 80 GB
    datasheet figures (module docstring).  ``res.flops`` is per device
    (the local-shard ops), so the compute term divides by no chip count;
    the memory term reads the per-device arguments and temporaries once;
    the collective term prices intra-group bytes at NVLink's rate and
    inter-group bytes at the network's.  ``chips`` is kept for the JAX
    signature."""
    mem = res.memory
    moved = mem.get("argument_size_in_bytes", 0.0) + mem.get(
        "temp_size_in_bytes", 0.0)
    coll = res.collective
    return {"compute_s": res.flops / PEAK_FLOPS,
            "memory_s": moved / HBM_BW,
            "collective_s": coll.get("intra_group", 0.0) / NVLINK_BW
            + coll.get("inter_group", 0.0) / NETWORK_BW}


def per_device_gb(res: DryrunResult) -> float:
    """Arguments + temporaries per device, GB (against the card's 80)."""
    return (res.memory.get("argument_size_in_bytes", 0.0)
            + res.memory.get("temp_size_in_bytes", 0.0)) / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", choices=["llcg", "sync"], default="llcg")
    ap.add_argument("--llcg-k", type=int, default=2)
    ap.add_argument("--llcg-s", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the JAX CLI; eager torch always runs "
                         "every layer, so it changes nothing")
    ap.add_argument("--gnn-round", action="store_true",
                    help="also trace the GNN engine round (shard_map "
                         "backend) on a fake machine group")
    ap.add_argument("--gnn-machines", type=int, default=16)
    ap.add_argument("--gnn-mode", choices=["local", "halo", "both"],
                    default="both")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.gnn_round:
        os.makedirs(args.out, exist_ok=True)
        modes = (["local", "halo"] if args.gnn_mode == "both"
                 else [args.gnn_mode])
        runs = [(m, "none") for m in modes]
        if "halo" in modes:
            runs.append(("halo", "int8"))
        all_ok = True
        for mode, halo_comp in runs:
            res = run_gnn_engine_case(args.gnn_machines, mode=mode,
                                      halo_compression=halo_comp)
            stem = "gnn_engine" if mode == "local" else "gnn_engine_halo"
            if halo_comp != "none":
                stem += f"_{halo_comp}"
            with open(os.path.join(args.out, f"{stem}__machine"
                                   f"{args.gnn_machines}.json"), "w") as f:
                json.dump(dataclasses.asdict(res), f, indent=2)
            log.info("%s gnn-engine %s × %s: trace %.1fs coll=%.3e "
                     "all-gather/exchange=%.3e %s",
                     "OK " if res.ok else "FAIL", res.shape, res.mesh,
                     res.lower_s, res.collective.get("total", 0),
                     res.meta.get("all_gather_bytes_per_exchange", 0),
                     res.error or "")
            all_ok &= res.ok
        if args.arch is None and not args.all:
            return 0 if all_ok else 1

    cases = []
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for a in archs:
        for s in shapes:
            if not shape_supported(a, s):
                log.info("skip %s × %s (the skip rules)", a, s)
                continue
            for mp in meshes:
                cases.append((a, s, mp))

    os.makedirs(args.out, exist_ok=True)
    n_ok = 0
    for a, s, mp in cases:
        res = run_case(a, s, mp, variant=args.variant, llcg_k=args.llcg_k,
                       llcg_s=args.llcg_s, remat=not args.no_remat,
                       unroll=args.unroll)
        chips = 512 if mp else 256
        blob = dataclasses.asdict(res)
        blob["roofline"] = roofline_terms(res, chips)
        blob["per_device_gb"] = per_device_gb(res)
        fname = os.path.join(args.out,
                             f"{a}__{s}__{res.mesh}__{res.variant}.json")
        with open(fname, "w") as f:
            json.dump(blob, f, indent=2)
        log.info("%s %s × %s × %s: trace %.1fs flops=%.3e coll=%.3e "
                 "inter=%.3e %.1f GB/device %s", "OK " if res.ok else "FAIL",
                 a, s, res.mesh, res.lower_s, res.flops,
                 res.collective.get("total", 0),
                 res.collective.get("inter_group", 0), per_device_gb(res),
                 res.error or "")
        n_ok += res.ok
    log.info("dry-run complete: %d/%d OK", n_ok, len(cases))
    return 0 if n_ok == len(cases) else 1


if __name__ == "__main__":
    sys.exit(main())
