"""Faults planted under the timed path, to show that the comparison sees
them: each is a context manager that patches the program for one run.

GNN rounds (``gnn_rounds``) have:

* ``unchanged`` — the round returns the state it was given;
* ``half_batch`` — half of every batch left out, the mean over the rest;
* ``no_exchange`` — the average between machines left out: machine 0's
  parameters are taken for the mean;
* ``altered`` — an answer altered where it is produced: the round's mean
  local loss, by one part in a thousand.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


@contextlib.contextmanager
def _patched(obj, name: str, make: Callable) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def gnn(fault: str):
    """The context manager that plants ``fault`` under the GNN round."""
    from repro_torch.core import engine, plan
    from repro_torch.utils.pytree import tree_map

    if fault == "unchanged":
        def make(orig):
            def run_round(self, state, feats, labels, inputs):
                _, metrics = orig(self, state, feats, labels, inputs)
                return state, metrics
            return run_round
        return _patched(plan._PlanProgram, "run_round", make)
    if fault == "half_batch":
        def make(orig):
            def sample(self, desc, k_pad=None):
                x = orig(self, desc, k_pad)
                b = x.bmasks.clone()
                b[..., b.shape[-1] // 2:] = 0.0
                c = x.corr_bmasks
                if c is not None:
                    c = c.clone()
                    c[..., c.shape[-1] // 2:] = 0.0
                return dataclasses.replace(x, bmasks=b, corr_bmasks=c)
            return sample
        return _patched(plan.RoundSampler, "sample", make)
    if fault == "no_exchange":
        def make(orig):
            def average(self, state, p_new):
                return tree_map(lambda x: x[0], p_new), state.comm_residual
            return average
        return _patched(engine.RoundProgram, "average", make)
    if fault == "altered":
        def make(orig):
            def masked_mean(losses, svalid):
                return orig(losses, svalid) * 1.001
            return masked_mean
        return _patched(engine, "_masked_mean", make)
    raise ValueError(f"unknown fault {fault!r}")
