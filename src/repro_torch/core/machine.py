"""Per-machine loss / round-body / evaluation functions.

:func:`make_loss_fn` is the single loss definition; :func:`make_local_round`
is the K-step local phase of every machine.  The JAX package ``vmap``s one
machine's ``lax.scan`` over the machine axis; the port writes both axes
out: the P machines' parameters are stacked on a leading axis and every
step runs one forward over all P graphs, so one ``backward`` of the SUM of
the P per-machine losses yields each machine's own gradients (machine p's
loss depends only on machine p's parameters), and the optimizer — which is
elementwise — updates the stack at once.  The K steps are a Python loop.
:func:`halo_fill` is the per-step half of the engine's ``halo`` round mode:
it splices the exchanged cut-node features into every machine's extended
feature rows (:class:`repro_torch.graph.halo.HaloProgram` supplies the
index tables).  :func:`make_machine_step` is the single-step building
block of one machine, which the subgraph-approximation baseline and
differential tests drive.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.models.gnn.model import (GNNModel, cross_entropy_on_batch,
                                          f1_micro)
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          masked_update)
from repro_torch.utils.logging import Timer
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class MachineStep:
    """One machine's step functions (the JAX package's jitted pair, run
    eagerly on the tensors' device)."""

    local_step: Callable
    loss_and_grad: Callable


def make_loss_fn(model: GNNModel) -> Callable:
    """Masked mini-batch cross-entropy, one value per stacked graph.

    ``loss_fn(params, feats, table, mask, batch, labels, bmask, agg=None)``
    takes B stacked graphs (params leaves ``(B, …)``, ``feats (B, N, d)``,
    ``batch (B, Bs)``, …) and returns the ``(B,)`` losses
    ``Σ nll·bmask / clip(Σ bmask, 1)`` — the JAX package's loss per graph.
    """

    def loss_fn(params, feats, table, mask, batch, labels, bmask, agg=None):
        logits = model.apply_stacked(params, feats, table, mask, agg=agg)
        b, n, c = logits.shape
        rows = torch.arange(b, device=logits.device)[:, None]
        idx = batch.long()
        # index_select: a backward that sums repeated batch rows in a fixed
        # order (see repro_torch.models.gnn.layers._gather)
        picked = logits.reshape(b * n, c).index_select(
            0, (idx + rows * n).reshape(-1)).reshape(b, -1, c)
        logp = torch.log_softmax(picked, dim=-1)               # (B, Bs, C)
        nll = -logp.gather(-1, labels[rows, idx].long()[..., None])[..., 0]
        return (nll * bmask).sum(-1) / bmask.sum(-1).clamp_min(1.0)

    return loss_fn


def value_and_grad(loss_fn: Callable, params, *args, **kw):
    """``(losses, grads)``: the ``(B,)`` losses and the gradient of their
    sum with respect to every leaf of ``params``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with Timer("step.forward"):
        losses = loss_fn(tree_unflatten(params, leaves), *args, **kw)
    with Timer("step.backward"):
        grads = torch.autograd.grad(losses.sum(), leaves)
    return losses.detach(), tree_unflatten(params, list(grads))


def make_local_round(model: GNNModel, optimizer: Optimizer,
                     reset_opt: bool = True) -> Callable:
    """Every machine's local phase (Alg. 1/2 lines 3-9).

    Returns ``round(params, opt_state, feats, labels, tables, masks,
    batches, bmasks, svalid) -> (params, opt_state, losses)``: ``params``
    are the incoming server parameters (unstacked), the data carry leading
    ``(P, K, …)`` axes (``tables (P, K, N, F)``, ``batches (P, K, B)``),
    and the results are the P machines' parameters stacked ``(P, …)``,
    their optimizer state and the ``(K, P)`` step losses.  With
    ``reset_opt`` the optimizer is freshly initialized from the incoming
    parameters — line 3 of the paper's algorithms — and ``opt_state`` is
    ignored; otherwise it is the machines' stacked state, threaded on.

    ``svalid`` (K host numbers) is the K-bucketing validity flag: steps
    with ``svalid == 0`` are padding and run as true no-ops
    (:func:`repro_torch.optim.optimizers.masked_update`); their losses are
    zeroed.
    """
    loss_fn = make_loss_fn(model)

    def local_round(params, opt_state, feats, labels, tables, masks,
                    batches, bmasks, svalid: Sequence[float]):
        P = feats.shape[0]
        with torch.no_grad():
            p = tree_map(lambda x: x[None].repeat(P, *([1] * x.dim())),
                         params)
        o = optimizer.init(p) if reset_opt else opt_state
        losses = []
        for k, valid in enumerate(svalid):
            loss, grads = value_and_grad(
                loss_fn, p, feats, tables[:, k], masks[:, k], batches[:, k],
                labels, bmasks[:, k])
            with Timer("step.optimizer"):
                upd, o = masked_update(optimizer, grads, o, p, valid)
                p = apply_updates(p, upd)
            losses.append(loss * valid)
        return p, o, torch.stack(losses)

    return local_round


def make_machine_step(model: GNNModel, optimizer: Optimizer) -> MachineStep:
    """The SGD step of Algorithm 1/2 lines 6-8 on ONE machine's view.

    Inputs per call (unstacked, no machine axis):
      feats  (N, d)    local (padded) features
      table  (N, F)    this step's sampled neighbor table
      mask   (N, F)    validity
      batch  (B,)      mini-batch node indices (local)
      labels (N,)      local labels
      bmask  (B,)      1.0 for real batch entries (padding-safe)
    """
    loss_fn = make_loss_fn(model)

    def loss_and_grad(params, feats, table, mask, batch, labels, bmask):
        loss, grads = value_and_grad(
            loss_fn, tree_map(lambda x: x[None], params), feats[None],
            table[None], mask[None], batch[None], labels[None], bmask[None])
        return loss[0], tree_map(lambda g: g[0], grads)

    def local_step(params, opt_state, feats, table, mask, batch, labels,
                   bmask):
        loss, grads = loss_and_grad(params, feats, table, mask, batch,
                                    labels, bmask)
        with Timer("step.optimizer"):
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, loss

    return MachineStep(local_step=local_step, loss_and_grad=loss_and_grad)


def halo_fill(feats: torch.Tensor, gathered_flat: torch.Tensor,
              recv_idx: torch.Tensor, dest_idx: torch.Tensor,
              recv_valid: torch.Tensor) -> torch.Tensor:
    """Splice exchanged cut-node features into every machine's feature rows.

    ``feats (P, n_ext_pad, d)`` holds only the machines' local rows;
    ``gathered_flat (P · max_send, d)`` is the flattened all-gather of every
    machine's owner-bucketed send buffer.  Machine p's halo rows are
    gathered out of it (``recv_idx[p]``) and scattered to their
    extended-buffer rows (``dest_idx[p]``).  Padded slots carry
    ``recv_valid == 0`` and a destination of ``n_ext_pad``: the JAX package
    drops that out-of-bounds write (``mode="drop"``); a torch index op would
    raise (on CUDA, a device-side assert), so the scatter writes into one
    sink row past the buffer, which is sliced off.
    """
    P, n, d = feats.shape
    halo = gathered_flat[recv_idx.long()] * recv_valid[..., None]
    out = torch.cat([feats, feats.new_zeros((P, 1, d))], dim=1)
    out.scatter_(1, dest_idx.long()[..., None].expand(-1, -1, d), halo)
    return out[:, :n]


def make_eval_fn(model: GNNModel) -> Callable:
    """Full-graph, full-neighbor evaluation (the paper's 'global validation
    score' — computed on the server with the complete graph)."""

    def evaluate(params, feats, table, mask, labels, nodes):
        with torch.no_grad():
            logits = model.apply(params, feats, table, mask)
            return (cross_entropy_on_batch(logits, labels, nodes),
                    f1_micro(logits, labels, nodes))

    return evaluate
