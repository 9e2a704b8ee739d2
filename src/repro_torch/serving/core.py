"""Backend-agnostic serving core: the wave scheduler.

:class:`WaveScheduler` is synchronous batching: requests queue up, are
grouped into *buckets* of identical shape, each bucket drains in fixed-size
*waves* through one backend call, and a wave finishes before the next is
admitted.  What a "shape" is (an LM prompt length) is the backend's
business; the scheduler only needs bucket keys to be sortable and hashable.

Per-request timing is split into **queue wait** (submit → admission) and
**service time** (admission → completion), in :meth:`WaveScheduler.stats`
(summaries) and per request in ``request_log``.

A :class:`ServingBackend` owns model execution:

* ``validate(request)``     — reject malformed requests at submit time.
* ``bucket_key(request)``   — requests sharing a key may share a wave.
* ``run_wave(requests, wave_index)`` — execute up to ``batch_size``
  same-bucket requests; returns one result per request, in order.

Sampling stays deterministic in queue-independent terms:
:func:`request_generator` seeds a CPU ``torch.Generator`` from ``(seed, uid,
step)`` — *per-request* determinism (a request's sampled continuation never
depends on what shared its wave) — where the JAX package folds ``jax.random``
keys (``fold_request_key``); the draws differ from JAX's, the property is the
same.  :func:`wave_rng` seeds a numpy generator from a wave's request ids.

The continuous-batching ``SlotScheduler`` / ``SlotBackend`` are ROADMAP.md
Queue 1 item 11's work.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Hashable, List, Sequence

import numpy as np
import torch


class ServingBackend:
    """Interface a workload plugs into :class:`WaveScheduler`.

    Subclassing is optional (duck typing suffices); this base provides the
    neutral defaults so simple backends only implement ``run_wave``.
    """

    def validate(self, request) -> None:
        """Raise ``ValueError`` if the request cannot be served."""

    def bucket_key(self, request) -> Hashable:
        """Shape key; requests sharing a key may share a wave."""
        return 0

    def run_wave(self, requests: Sequence[Any], wave_index: int) -> List[Any]:
        raise NotImplementedError

    def stats(self) -> Dict:
        """Backend-specific counters merged into the scheduler's stats."""
        return {}


def _time_summary(xs: Sequence[float]) -> Dict:
    """mean/p50/p99/max summary of a latency component (seconds)."""
    if not xs:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    a = np.asarray(xs, np.float64)
    return {"n": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


def request_generator(seed: int, uid: int, step: int = 0) -> torch.Generator:
    """Deterministic per-request CPU generator for ``(seed, uid, step)``.

    Sampling driven by it depends only on the request identity and its
    position in its own generation, never on wave composition or queue
    order.
    """
    state = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(uid) & 0xFFFFFFFF,
         int(step) & 0xFFFFFFFF]).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(state))


def wave_rng(seed: int, uids: Sequence[int]) -> np.random.Generator:
    """Deterministic numpy generator for one wave's host-side sampling.

    Seeded from ``(seed, *uids)`` so a wave of the same requests draws the
    same tables on every replay, independent of previous waves.
    """
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & 0xFFFFFFFF]
                               + [int(u) & 0xFFFFFFFF for u in uids]))


class WaveScheduler:
    """Queue → buckets → fixed-size waves → backend, with counters.

    Buckets drain in sorted key order (deterministic service order) and each
    bucket is chunked into waves of at most ``batch_size`` requests in
    submission order.

    Per-request timing is split into **queue wait** (submit → the wall
    instant its wave starts) and **service time** (wave start → that
    request's own completion, the backend-reported ``latency_s`` when
    present, else the wave duration).
    """

    def __init__(self, backend: ServingBackend, batch_size: int = 4):
        if batch_size < 1:
            raise ValueError("batch_size must be ≥ 1")
        self.backend = backend
        self.batch_size = batch_size
        self._queue: List[Any] = []
        self._submit_t: Dict[int, float] = {}
        self._wave = 0
        self._served = 0
        self.request_log: List[Dict] = []

    # ------------------------------------------------------------------ api
    def submit(self, request) -> None:
        self.backend.validate(request)
        self._queue.append(request)
        self._submit_t[id(request)] = time.perf_counter()

    def run(self) -> List[Any]:
        """Drain the queue; returns results in completion order."""
        results: List[Any] = []
        buckets: Dict[Hashable, List[Any]] = {}
        for r in self._queue:
            buckets.setdefault(self.backend.bucket_key(r), []).append(r)
        self._queue = []
        for key in sorted(buckets):
            group = buckets[key]
            while group:
                wave, group = group[: self.batch_size], group[self.batch_size:]
                self._wave += 1
                t_start = time.perf_counter()
                out = self.backend.run_wave(wave, self._wave)
                if len(out) != len(wave):
                    raise RuntimeError(
                        f"backend returned {len(out)} results for a wave of "
                        f"{len(wave)} requests")
                wave_s = time.perf_counter() - t_start
                for req, res in zip(wave, out):
                    service = getattr(res, "latency_s", None)
                    if service is None:
                        service = wave_s
                    t_sub = self._submit_t.pop(id(req), t_start)
                    self.request_log.append({
                        "uid": getattr(req, "uid", None),
                        "submit_t": t_sub, "admit_t": t_start,
                        "finish_t": t_start + service,
                        "queue_wait_s": t_start - t_sub,
                        "service_s": service})
                self._served += len(out)
                results.extend(out)
        return results

    def stats(self) -> Dict:
        s = {"waves": self._wave, "queued": len(self._queue),
             "served": self._served, "batch_size": self.batch_size,
             "queue_wait_s": _time_summary(
                 [r["queue_wait_s"] for r in self.request_log]),
             "service_s": _time_summary(
                 [r["service_s"] for r in self.request_log])}
        s.update(self.backend.stats())
        return s
