"""Step builders for LM training: the fully synchronous baseline, the LLCG
round step, and the serving (prefill / decode) steps — the port of the JAX
package's ``distributed/steps.py``.

The LLCG round step is the paper's Algorithm 2:

  1. **Local phase** — each of the G machines takes K optimizer steps on
     its own batches.  Where the JAX package ``vmap``\\ s the G chains, the
     port runs them one after another on the device (the scan kernel has
     no batching rule); nothing crosses machines here.
  2. **Parameter averaging** — the mean over G, in f32 (or of bf16-cast
     parameters with ``avg_bf16``; the paper's line 12).
  3. **Server correction** — S steps on globally mixed batches with the
     *server* optimizer (lines 13-18).
  4. **Broadcast** — the corrected model refills the G copies (line 3 of
     the next round).

Parameters and optimizer states are nested dicts of tensors
(:mod:`repro_torch.utils.pytree`); a stacked tree has a leading (G, …) axis
on every leaf.  Gradients are torch autograd of ``LM.loss``
(:func:`value_and_grad`); ``remat`` recomputes each block of the forward
in the backward (``torch.utils.checkpoint``, :meth:`LM.forward`), so a
step holds every block's input and one block's activations at a time.

Spans and a counter.  A round opens the tracer's spans
(:class:`~repro_torch.utils.logging.Timer`) ``round`` and its phases
``round.local``, ``round.average`` (the mean and the broadcast) and
``round.correction``, as the GNN round engine does; every step opens
``step.forward``, ``step.backward`` and ``step.optimizer``.  The round
step counts the bytes its exchanges carry in ``round_step.wire_bytes``
(cumulative): each copy up to the mean and the corrected model back, at
the wire format (bfloat16 for the float32 leaves under ``avg_bf16``).  The
unsharded step adds up the tensors :func:`average` and :func:`broadcast`
handle; a rank of the sharded step, which holds only its block of a copy,
counts the whole model's bytes from its global shapes
(:func:`wire_bytes_per_round`), 2 · G · the parameters' bytes a round.

Sharded steps.  Each ``build_*`` function takes an optional ``mesh`` (a
``torch.distributed.device_mesh.DeviceMesh`` with axes ``data`` × ``model``
or ``pod`` × ``data`` × ``model``); given one, it returns the per-rank
program that GSPMD makes of the JAX package's step under the dry run's
shardings (:mod:`repro_torch.launch.dryrun`): every argument is the rank's
block of the global array under the rules of
:mod:`repro_torch.distributed.sharding`, the model's own code runs
tensor-parallel over ``model`` on those blocks (its entry points given the
rank's :class:`~repro_torch.distributed.tensor_parallel.ModelShard`),
gradients are summed over the axes that shard the batch, and the LLCG
average is a mean over the group axis.  The step's
:class:`~repro_torch.distributed.tensor_parallel.ShardComm` is its ``comm``
attribute (the bytes of its collectives).

Memory.  The round step updates ``params_G``, the stacked local optimizer
state and the server state in place, leaf by leaf (as a donated argument of
a jitted JAX step would be), and returns them: on top of the states it
holds one machine's gradients, the average and one leaf's update at a time.
Callers that keep the inputs pass copies.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distributed.sharding import (batch_pspec, data_axes_for,
                                              group_axis_for, param_pspecs,
                                              _axes_of)
from repro_torch.models.transformer.model import LM
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.utils.logging import Timer
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class LLCGStepConfig:
    num_groups: int          # G = P local machines
    local_steps: int = 1     # K for this round
    correction_steps: int = 1  # S
    remat: bool = False      # recompute each block in the backward pass
    avg_bf16: bool = False   # average bf16-cast params (halves the
                             # inter-group bytes; beyond-paper §Perf lever)


def _loss_fn(model: LM, remat: bool) -> Callable:
    return functools.partial(model.loss, remat=True) if remat else model.loss


def wire_bytes_per_round(model: LM, num_groups: int,
                         avg_bf16: bool = False) -> int:
    """The bytes a round's exchanges carry: 2 · G · the parameters' bytes
    at the wire format (bfloat16 for the float32 leaves under
    ``avg_bf16``), from the model's global shapes."""
    total = 0
    for spec in tree_leaves(model.param_specs()):
        dtype = (torch.bfloat16 if avg_bf16 and spec.dtype == torch.float32
                 else spec.dtype)
        total += math.prod(spec.shape) * torch.empty(
            0, dtype=dtype).element_size()
    return 2 * num_groups * total


def value_and_grad(loss_fn: Callable, params: Dict, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict]:
    """``(loss, grads)`` of ``loss_fn(params, batch)`` — ``jax.
    value_and_grad``: grads in ``params``' structure (zeros for a leaf the
    loss does not read), the loss detached."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        with Timer("step.forward"):
            loss = loss_fn(tree_unflatten(params, leaves), batch)
        with Timer("step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _state_leaf(state: Any, i: int) -> Any:
    """The optimizer state restricted to leaf ``i``: each field that is a
    tree (moments, velocity) becomes ``{"x": its leaf i}``, the rest (the
    step count) stays."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_state_leaf(f, i) for f in state))
    if isinstance(state, dict):
        return {"x": tree_leaves(state)[i]}
    return state


def _state_map(state: Any, fn: Callable) -> Any:
    """``fn`` over every tensor of the state's trees (the step count
    stays)."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_state_map(f, fn) for f in state))
    if isinstance(state, dict):
        return tree_map(fn, state)
    return state


def _update_in_place(optimizer: Optimizer, grads: Dict, state: Any,
                     params: Dict) -> Any:
    """One optimizer step written into ``params`` and ``state``'s tensors,
    a leaf at a time: each leaf runs ``optimizer.update`` on its own (the
    same elementwise arithmetic as the whole tree) and
    :func:`~repro_torch.optim.optimizers.apply_updates`, so the transient
    memory is one leaf's.  Returns the new state (its step count advanced,
    its tensors the ones passed in)."""
    p_leaves = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    new = state
    with Timer("step.optimizer"):
        for i, (p, g) in enumerate(zip(p_leaves, g_leaves)):
            sub = _state_leaf(state, i)
            upd, new_sub = optimizer.update({"x": g}, sub, {"x": p})
            with torch.no_grad():
                p.copy_(apply_updates({"x": p}, upd)["x"])
                _copy_state(sub, new_sub)
            new = new_sub
    return _with_trees(state, new)


def _copy_state(dst: Any, src: Any) -> None:
    if isinstance(dst, tuple) and hasattr(dst, "_fields"):
        for d, s in zip(dst, src):
            _copy_state(d, s)
    elif isinstance(dst, dict):
        dst["x"].copy_(src["x"])


def _with_trees(state: Any, new: Any) -> Any:
    """``state``'s trees (updated in place) with ``new``'s other fields."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_with_trees(s, n) for s, n in zip(state, new)))
    return state if isinstance(state, dict) else new


def build_sync_train_step(model: LM, optimizer: Optimizer,
                          remat: bool = False, mesh=None) -> Callable:
    """Fully synchronous data-parallel step (the PSGD per-step-sync baseline
    and the §Perf comparison point): ``(params, opt_state, batch) →
    (params, opt_state, loss)``, functional.  With ``mesh``, the per-rank
    program (module docstring): parameters replicated over the data axes,
    the batch sharded over them."""
    if mesh is not None:
        return _sharded_sync_step(model, optimizer, remat, mesh)
    loss_fn = _loss_fn(model, remat)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return train_step


def _wire(x: torch.Tensor, avg_bf16: bool) -> torch.Tensor:
    """``x`` at the wire format: bfloat16 for a float32 leaf under
    ``avg_bf16``, else as it is."""
    return x.to(torch.bfloat16) if avg_bf16 and x.dtype == torch.float32 \
        else x


def average(params_G: Dict, avg_bf16: bool = False) -> Tuple[Dict, int]:
    """The mean over the G stacked copies (Alg. 2, line 12), in f32, or of
    the bf16-cast copies with ``avg_bf16``, and the bytes of the copies it
    took in at the wire format."""
    carried = 0

    def mean(x):
        nonlocal carried
        sent = _wire(x, avg_bf16)
        carried += sent.numel() * sent.element_size()
        if sent is x:
            return x.mean(0)
        return sent.float().mean(0).to(torch.bfloat16).to(x.dtype)

    with torch.no_grad():
        return tree_map(mean, params_G), carried


def broadcast(params_G: Dict, avg: Dict, avg_bf16: bool = False) -> int:
    """Every copy of ``params_G`` takes ``avg`` (line 3 of the next round);
    the bytes of the copies written, at the wire format (under
    ``avg_bf16`` the mean's float32 leaves are bfloat16 values already)."""
    carried = 0
    with torch.no_grad():
        for x, a in zip(tree_leaves(params_G), tree_leaves(avg)):
            sent = _wire(a, avg_bf16)
            x.copy_(sent.expand_as(x))
            carried += x.numel() * sent.element_size()
    return carried


def build_llcg_round_step(model: LM, local_opt: Optimizer,
                          server_opt: Optimizer,
                          step_cfg: LLCGStepConfig, mesh=None) -> Callable:
    """One LLCG round (K local steps · G machines + averaging + S
    corrections).

    Args to the returned function, as the JAX package's:
      params_G     — tree stacked (G, …)
      local_opt_G  — ``local_opt.init(params_G)``: its trees stacked (G, …),
                     one step count for all G (every machine takes K steps)
      server_state — server optimizer state (unstacked)
      local_batch  — leaves (G, K, B_local, …)
      corr_batch   — leaves (S, B_server, …)
    Returns ``(params_G, local_opt_G, server_state, metrics)``, the first
    three updated in place (module docstring); ``metrics`` holds the mean
    ``local_loss`` (over G of each machine's mean over K) and ``corr_loss``
    (over S), 0-d f32 tensors.

    With ``mesh``, the per-rank program (:func:`_sharded_round_step`).
    """
    if mesh is not None:
        return _sharded_round_step(model, local_opt, server_opt, step_cfg,
                                   mesh)
    g_count = step_cfg.num_groups
    loss_fn = _loss_fn(model, step_cfg.remat)

    def round_step(params_G, local_opt_G, server_state, local_batch,
                   corr_batch):
        round_step.rounds += 1
        with Timer("round", round=round_step.rounds):
            # 1. local training, machine by machine (no inter-group traffic)
            local_losses = []
            new_local = local_opt_G
            with Timer("round.local"):
                for g in range(g_count):
                    p = tree_map(lambda x: x[g], params_G)
                    o = _state_map(local_opt_G, lambda x: x[g])
                    losses = []
                    for i in range(step_cfg.local_steps):
                        batch = {k: v[g, i] for k, v in local_batch.items()}
                        loss, grads = value_and_grad(loss_fn, p, batch)
                        o = _update_in_place(local_opt, grads, o, p)
                        del grads
                        losses.append(loss)
                    local_losses.append(torch.stack(losses).mean())
                    new_local = _with_trees(local_opt_G, o)

            # 2. parameter averaging across the machines (Alg. 2, line 12)
            with Timer("round.average"):
                avg, carried = average(params_G, step_cfg.avg_bf16)

            # 3. server correction: S global synchronous steps (lines 13-18)
            corr_losses = []
            with Timer("round.correction"):
                for s in range(len(next(iter(corr_batch.values())))):
                    batch = {k: v[s] for k, v in corr_batch.items()}
                    loss, grads = value_and_grad(loss_fn, avg, batch)
                    server_state = _update_in_place(server_opt, grads,
                                                    server_state, avg)
                    del grads
                    corr_losses.append(loss)

            # 4. broadcast the corrected model to every machine (line 3)
            with Timer("round.average"):
                carried += broadcast(params_G, avg, step_cfg.avg_bf16)
            metrics = {"local_loss": torch.stack(local_losses).mean(),
                       "corr_loss": torch.stack(corr_losses).mean()}
        round_step.wire_bytes += carried
        return params_G, new_local, server_state, metrics

    round_step.rounds = 0
    round_step.wire_bytes = 0
    return round_step


def build_prefill_step(model: LM, max_seq: int, mesh=None,
                       state_specs=None) -> Callable:
    """``(params, batch) → (logits_last, states)``.  With ``mesh``, the
    per-rank program: the batch sharded over the data axes, the states
    laid out by ``state_specs`` (the dry run's state rules)."""
    if mesh is not None:
        tp = _shard(model, mesh, _data_axes(mesh), state_specs)

        def sharded_prefill(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch, max_seq, tp=tp)
        sharded_prefill.comm = tp.comm
        return sharded_prefill

    def prefill(params, batch):
        return model.prefill(params, batch, max_seq=max_seq)
    return prefill


def build_decode_step(model: LM, max_seq: int, mesh=None, state_specs=None,
                      token_sharded: bool = True) -> Callable:
    """``(params, states, token, position) → (logits, states)``.  With
    ``mesh``, the per-rank program against states laid out by
    ``state_specs``; ``token_sharded`` says whether the tokens are split
    over the data axes (else every rank holds them all)."""
    if mesh is not None:
        tp = _shard(model, mesh, _data_axes(mesh) if token_sharded else (),
                    state_specs)

        def sharded_decode(params, states, token, position):
            with torch.no_grad():
                return model.decode_step(params, states, token,
                                         int(position), max_seq, tp=tp)
        sharded_decode.comm = tp.comm
        return sharded_decode

    def decode(params, states, token, position):
        return model.decode_step(params, states, token, position,
                                 max_seq=max_seq)
    return decode


# --------------------------------------------------------------------------
# The sharded (per-rank) steps
# --------------------------------------------------------------------------
def _data_axes(mesh) -> Tuple[str, ...]:
    return data_axes_for(mesh, with_group=False)


def _shard(model: LM, mesh, batch_axes, state_specs=None, comm=None):
    """The rank's :class:`~repro_torch.distributed.tensor_parallel.
    ModelShard` of ``model`` on ``mesh`` (a new ``ShardComm`` unless
    ``comm`` is given)."""
    from repro_torch.distributed.tensor_parallel import ModelShard, ShardComm
    comm = comm or ShardComm(mesh)
    specs = param_pspecs(model.param_specs(), model.cfg, mesh)
    return ModelShard.of(comm, specs, state_specs, batch_axes)


def _sharded_value_and_grad(model: LM, tp, params: Dict, batch: Dict,
                            remat: bool) -> Tuple[torch.Tensor, Dict]:
    """``(loss, grads)`` of the global loss on this rank's shards: the
    rank's share differentiated, its gradients summed over the axes that
    shard the batch (``tp.batch_axes``)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        with Timer("step.forward"):
            nll, aux = model.loss_terms(tree_unflatten(params, leaves), batch,
                                        tp=tp, remat=remat)
        with Timer("step.backward"):
            grads = torch.autograd.grad(nll + aux, leaves, allow_unused=True)
    comm, axes = tp.comm, tp.batch_axes
    grads = [torch.zeros_like(x) if g is None else comm.all_reduce(g, axes)
             for x, g in zip(leaves, grads)]
    loss = comm.all_reduce(nll.detach(), axes) + aux.detach()
    return loss, tree_unflatten(params, grads)


def _sharded_sync_step(model: LM, optimizer: Optimizer, remat: bool, mesh
                       ) -> Callable:
    tp = _shard(model, mesh, _data_axes(mesh))

    def train_step(params, opt_state, batch):
        loss, grads = _sharded_value_and_grad(model, tp, params, batch,
                                              remat)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    train_step.comm = tp.comm
    return train_step


def _sharded_round_step(model: LM, local_opt: Optimizer,
                        server_opt: Optimizer, step_cfg: LLCGStepConfig,
                        mesh) -> Callable:
    """One LLCG round on one rank of ``mesh``.

    Arguments are the rank's blocks of the JAX package's round-step
    arguments under the dry run's specs: ``params_G`` (1, …) — its group's
    copy, sharded over ``model``; ``local_opt_G`` its state; the server
    state sharded as the parameters without the group dim; ``local_batch``
    (1, K, b, …) — its group's batches, split over the data axes other
    than the group axis; ``corr_batch`` (S, b, …) — the correction batches
    split over all the data axes.  The K local steps sum gradients over
    the group's data axes only; the average is one all-reduce over the
    group axis (an all-gather of the bf16-cast copies with ``avg_bf16``,
    whose mean is then the unsharded step's); the S corrections sum over
    every data axis; every copy then takes the corrected parameters (no
    traffic: the average is already on every rank).  Updated in place as
    the unsharded step."""
    gaxis = group_axis_for(mesh)
    local_tp = _shard(model, mesh, _axes_of(
        batch_pspec(mesh, stacked_group=True)[-1]))
    comm = local_tp.comm
    corr_tp = _shard(model, mesh, _data_axes(mesh), comm=comm)
    n_groups = comm.size((gaxis,))
    remat = step_cfg.remat

    wire = wire_bytes_per_round(model, n_groups, step_cfg.avg_bf16)

    def round_step(params_G, local_opt_G, server_state, local_batch,
                   corr_batch):
        round_step.rounds += 1
        with Timer("round", round=round_step.rounds):
            p = tree_map(lambda x: x[0], params_G)
            o = _state_map(local_opt_G, lambda x: x[0])
            losses = []
            with Timer("round.local"):
                for i in range(step_cfg.local_steps):
                    batch = {k: v[0, i] for k, v in local_batch.items()}
                    loss, grads = _sharded_value_and_grad(
                        model, local_tp, p, batch, remat)
                    o = _update_in_place(local_opt, grads, o, p)
                    del grads
                    losses.append(loss)
            new_local = _with_trees(local_opt_G, o)
            local_loss = comm.all_reduce(torch.stack(losses).mean(),
                                         (gaxis,)) / n_groups

            with Timer("round.average"), torch.no_grad():
                if step_cfg.avg_bf16:
                    avg = tree_map(
                        lambda x: comm.all_gather(x.to(torch.bfloat16), 0,
                                                  (gaxis,)).float().mean(0)
                        .to(torch.bfloat16).to(x.dtype)
                        if x.dtype == torch.float32 else
                        comm.all_reduce(x[0], (gaxis,)) / n_groups, params_G)
                else:
                    avg = tree_map(lambda x: comm.all_reduce(x, (gaxis,))
                                   / n_groups, p)

            corr_losses = []
            with Timer("round.correction"):
                for s in range(len(next(iter(corr_batch.values())))):
                    batch = {k: v[s] for k, v in corr_batch.items()}
                    loss, grads = _sharded_value_and_grad(
                        model, corr_tp, avg, batch, remat)
                    server_state = _update_in_place(server_opt, grads,
                                                    server_state, avg)
                    del grads
                    corr_losses.append(loss)

            with Timer("round.average"), torch.no_grad():
                tree_map(lambda x, a: x.copy_(a.expand_as(x)), params_G, avg)
            metrics = {"local_loss": local_loss,
                       "corr_loss": torch.stack(corr_losses).mean()}
        round_step.wire_bytes += wire
        return params_G, new_local, server_state, metrics

    round_step.rounds = 0
    round_step.wire_bytes = 0
    round_step.comm = comm
    return round_step
