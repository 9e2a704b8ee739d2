"""Optimizers as functional ``(init, update)`` transforms over param dicts.

``update(grads, state, params) -> (updates, state)`` returns *updates to
add* to the params (already negated and scaled by the LR), matching the
convention ``params = apply_updates(params, updates)`` of the JAX package's
``optim/optimizers.py``.  LLCG composes these per machine: the local
machines and the server correction can run different learning rates (η vs
γ in Algorithm 2).

Params and grads are nested dicts of tensors (:mod:`repro_torch.utils.
pytree`).  The update is elementwise, so it works unchanged on params
stacked over a leading machine axis: every machine of a round shares the
step count (each round re-initializes the local optimizer, and the
K-bucketing validity flag is the same on every machine).  The step count
is a host ``int`` and the learning rate a Python float, which torch
applies in the tensor's float32 exactly as JAX applies a weakly typed
scalar; every tensor op runs under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.utils.pytree import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def apply_updates(params, updates):
    with torch.no_grad():
        return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


#: Names accepted by :func:`make_optimizer` — the single registry every
#: config validates against.
OPTIMIZERS = ("adam", "adamw", "sgd", "sgd_momentum")


def make_optimizer(name: str, lr: float) -> Optimizer:
    """Build a registered optimizer by name (see :data:`OPTIMIZERS`)."""
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adamw(lr)
    if name == "sgd":
        return sgd(lr)
    if name == "sgd_momentum":
        return sgd_momentum(lr)
    raise ValueError(f"unknown optimizer {name!r}; "
                     f"choose one of {OPTIMIZERS}")


def masked_update(optimizer: Optimizer, grads, state, params, valid: float):
    """``optimizer.update`` gated by a per-step validity flag.

    With ``valid > 0`` this is exactly ``optimizer.update(grads, state,
    params)``.  With ``valid == 0`` the step is a true no-op: the updates
    are zero and the *incoming* state object is returned unchanged — no
    step-count increment, no moment decay — so padded tail steps of a
    K-bucketed round leave the optimizer bit for bit as if they never ran.
    ``valid`` is a host number (the bucketing flags are built on the host),
    so the gate is ordinary control flow.
    """
    if valid > 0:
        return optimizer.update(grads, state, params)
    with torch.no_grad():
        return tree_map(torch.zeros_like, grads), state


class _SGDState(NamedTuple):
    step: int


def sgd(lr: float) -> Optimizer:
    """Plain SGD — the optimizer analyzed in Theorems 1 & 2."""

    def init(params):
        del params
        return _SGDState(step=0)

    def update(grads, state, params=None):
        del params
        with torch.no_grad():
            updates = tree_map(lambda g: -lr * g, grads)
        return updates, _SGDState(step=state.step + 1)

    return Optimizer(init, update)


class _MomentumState(NamedTuple):
    step: int
    velocity: Any


def sgd_momentum(lr: float, momentum: float = 0.9,
                 nesterov: bool = False) -> Optimizer:
    def init(params):
        with torch.no_grad():
            return _MomentumState(step=0,
                                  velocity=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        del params
        with torch.no_grad():
            vel = tree_map(lambda v, g: momentum * v + g, state.velocity,
                           grads)
            if nesterov:
                upd = tree_map(lambda v, g: -lr * (momentum * v + g), vel,
                               grads)
            else:
                upd = tree_map(lambda v: -lr * v, vel)
        return upd, _MomentumState(step=state.step + 1, velocity=vel)

    return Optimizer(init, update)


class _AdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with decoupled weight decay; moments kept in f32.

    The arithmetic follows the JAX package's order of operations, with the
    bias corrections ``1 - b**step`` taken in float32 as it does.
    """

    def init(params):
        with torch.no_grad():
            f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
            return _AdamState(step=0, mu=tree_map(f32, params),
                              nu=tree_map(f32, params))

    def update(grads, state, params):
        step = state.step + 1
        with torch.no_grad():
            g32 = tree_map(lambda g: g.float(), grads)
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu,
                          g32)
            t = torch.tensor(float(step), dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)

            def upd(m, v, p):
                u = -(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
                if weight_decay:
                    u = u - lr * weight_decay * p.float()
                return u.to(p.dtype)

            updates = tree_map(upd, mu, nu, params)
        return updates, _AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)

