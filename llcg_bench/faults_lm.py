"""Faults planted under the LM rounds' timed path (``drivers/lm_rounds``),
to show that the comparison sees them: each is a context manager that
patches the program for one run.

* ``bf16_state`` — the scan's state kept in bfloat16, a lower precision
  than the configuration states: the scan runs a chunk at a time, its
  state rounded to bfloat16 between chunks (the precision control);
* ``no_average`` — the average between machines left out: machine 0's
  parameters are taken for the mean;
* ``half_batch`` — half of every batch left out: each sequence cut to its
  first half (tokens and labels), as the trainer's batch functions draw it;
* ``no_correction`` — the server's update left out: the correction's
  gradient is taken, its Adam step is not applied;
* ``bwd_bf16`` — the scan's backward in bfloat16: the gradient that
  enters it and every gradient it gives rounded to bfloat16 (the forward
  unchanged);
* ``wrong_sign`` — every update applied with the wrong sign, the local
  machines' and the server's.

The gradient kernel's one fault found so far (d log w summed over every
later step of the sequence, 5.7e-6 of its norm off float64 at 4,096
steps) is not planted here: it lies under what a sound step reads of a
leaf's gradient from its own block (up to 8.6e-4 off float64, where the
first token amplifies it), and the card test of the kernel against
float64 catches it.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

FAULTS = ("bf16_state", "no_average", "half_batch", "no_correction",
          "bwd_bf16", "wrong_sign")


@contextlib.contextmanager
def _patched(obj, name: str, make: Callable) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _all(*managers) -> Iterator[None]:
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def lm(fault: str):
    """The context manager that plants ``fault`` under the LM round."""
    import torch

    from repro_torch.distributed import steps
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.utils.pytree import tree_map

    if fault == "bf16_state":
        def make(orig):
            def linear_scan(q, k, v, log_w, h0=None, chunk=64, strict=False,
                            u=None):
                ys, h = [], h0
                for a in range(0, q.shape[1], chunk):
                    part = slice(a, a + chunk)
                    y, h = orig(q[:, part], k[:, part], v[:, part],
                                log_w[:, part], h, chunk=chunk,
                                strict=strict, u=u)
                    h = h.to(torch.bfloat16).float()
                    ys.append(y)
                return torch.cat(ys, dim=1), h
            return linear_scan
        return _patched(ops, "linear_scan", make)
    if fault == "no_average":
        def make(orig):
            def average(params_G, avg_bf16=False):
                with torch.no_grad():
                    return tree_map(lambda x: x[0].clone(), params_G), 0
            return average
        return _patched(steps, "average", make)
    if fault == "half_batch":
        def halve(orig):
            def draw(*args):
                return {k: v[..., :v.shape[-1] // 2]
                        for k, v in orig(*args).items()}
            return draw
        return _all(_patched(train, "_local_batches", halve),
                    _patched(train, "_corr_batches", halve))
    if fault == "no_correction":
        server = {}

        def capture(orig):
            def build(model, local_opt, server_opt, *args, **kw):
                server["opt"] = server_opt
                return orig(model, local_opt, server_opt, *args, **kw)
            return build

        def skip(orig):
            def update(optimizer, grads, state, params):
                if optimizer is server.get("opt"):
                    return state
                return orig(optimizer, grads, state, params)
            return update
        return _all(_patched(steps, "build_llcg_round_step", capture),
                    _patched(steps, "_update_in_place", skip))
    if fault == "bwd_bf16":
        class Rounded(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.clone()

            @staticmethod
            def backward(ctx, g):
                return g.to(torch.bfloat16).to(g.dtype)

        def make(orig):
            def linear_scan(q, k, v, log_w, h0=None, chunk=64, strict=False,
                            u=None):
                r = lambda x: None if x is None else Rounded.apply(x)
                y, h = orig(r(q), r(k), r(v), r(log_w), r(h0), chunk=chunk,
                            strict=strict, u=r(u))
                return Rounded.apply(y), Rounded.apply(h)
            return linear_scan
        return _patched(ops, "linear_scan", make)
    if fault == "wrong_sign":
        def make(orig):
            def apply_updates(params, updates):
                return orig(params, tree_map(lambda x: -x, updates))
            return apply_updates
        return _patched(steps, "apply_updates", make)
    raise ValueError(f"unknown fault {fault!r}")

