"""Backend-agnostic serving core: wave and slot (continuous) schedulers.

:class:`WaveScheduler` is synchronous batching: requests queue up, are
grouped into *buckets* of identical shape, each bucket drains in fixed-size
*waves* through one backend call, and a wave finishes before the next is
admitted.  What a "shape" is (an LM prompt length, a GNN neighbor-table
width) is the backend's business; the scheduler only needs bucket keys to
be sortable and hashable.

:class:`SlotScheduler` is continuous batching over a fixed pool of
*slots*: requests are admitted into free slots the moment one opens, the
backend advances ALL active slots one step per :meth:`SlotScheduler.step`,
and each request retires individually the step it finishes, so a short
request never waits for a long co-resident.  Slot-capable backends
implement :class:`SlotBackend` (``num_slots`` / ``admit`` / ``step``).

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
same.  :func:`wave_rng` seeds a numpy generator from a wave's request ids,
and :func:`wave_key` folds them into the JAX package's ``jax.random`` key
for the device sampler.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils import threefry


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


class SlotBackend(ServingBackend):
    """Extra protocol a backend implements to run under
    :class:`SlotScheduler`.

    A slot backend owns a fixed pool of per-slot serve state; the scheduler
    owns admission order, slot bookkeeping and timing.  ``admit`` must
    overwrite the slot's state fully, so slot reuse never leaks state
    between requests.
    """

    @property
    def num_slots(self) -> int:
        raise NotImplementedError

    def admit(self, slot: int, request) -> Optional[Any]:
        """Install ``request`` into ``slot``.  Returns a finished result if
        the request completed during admission (then the slot stays free),
        else ``None``."""
        raise NotImplementedError

    def step(self) -> Dict[int, Any]:
        """Advance every active slot one step; returns ``{slot: result}``
        for the slots whose request finished this step."""
        raise NotImplementedError


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


def wave_key(seed: int, uids: Sequence[int]) -> threefry.Key:
    """The JAX package's ``jax.random`` key for one wave's device-side
    sampling, as two uint32 words (:mod:`repro_torch.utils.threefry`):
    ``PRNGKey(seed)`` folded with each uid in submission order, so a wave
    of the same requests draws the same tables on every replay,
    independent of previous waves."""
    key = threefry.prng_key(int(seed) & 0x7FFFFFFF)
    for u in uids:
        key = threefry.fold_in(key, int(u) & 0x7FFFFFFF)
    return key


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


class SlotScheduler:
    """Continuous batching: a fixed slot pool with mid-flight admit/retire.

    The scheduler owns a FIFO queue and the slot free-list; the backend owns
    per-slot execution state (:class:`SlotBackend`).  Each :meth:`step`
    first fills every free slot from the queue (lowest slot index first),
    then advances the whole pool one backend step and retires the slots
    whose request finished.  :meth:`submit` may be called at any time,
    including between steps of a loop driven from outside.

    Queue wait is submit → admission into a slot; service is admission →
    the end of the step in which the request finished.
    """

    def __init__(self, backend: SlotBackend, num_slots: Optional[int] = None):
        self.backend = backend
        self.num_slots = int(num_slots if num_slots is not None
                             else backend.num_slots)
        if self.num_slots < 1:
            raise ValueError("num_slots must be ≥ 1")
        if self.num_slots > backend.num_slots:
            raise ValueError(f"num_slots {self.num_slots} exceeds the "
                             f"backend pool ({backend.num_slots})")
        self._queue: collections.deque = collections.deque()
        self._free: List[int] = list(range(self.num_slots))
        self._active: Dict[int, Dict] = {}
        self._step_idx = 0
        self._served = 0
        self._occupancy_sum = 0.0
        self.request_log: List[Dict] = []

    # ------------------------------------------------------------------ api
    def submit(self, request) -> None:
        self.backend.validate(request)
        self._queue.append((request, time.perf_counter()))

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return len(self._active)

    def _finish(self, entry: Dict, result, t_finish: float) -> None:
        self.request_log.append({
            "uid": getattr(entry["request"], "uid", None),
            "submit_t": entry["submit_t"], "admit_t": entry["admit_t"],
            "finish_t": t_finish,
            "queue_wait_s": entry["admit_t"] - entry["submit_t"],
            "service_s": t_finish - entry["admit_t"]})
        self._served += 1

    def _admit_free(self) -> List[Any]:
        """Fill free slots from the queue; returns admit-time completions."""
        done: List[Any] = []
        while self._free and self._queue:
            request, t_sub = self._queue.popleft()
            slot = min(self._free)
            t_adm = time.perf_counter()
            result = self.backend.admit(slot, request)
            entry = {"request": request, "submit_t": t_sub, "admit_t": t_adm}
            if result is not None:         # finished during admission
                self._finish(entry, result, time.perf_counter())
                done.append(result)
            else:
                self._free.remove(slot)
                self._active[slot] = entry
        return done

    def step(self) -> List[Any]:
        """Admit into free slots, advance the pool one step, retire.
        Returns the results completed this step (admission-time finishes
        first), possibly none."""
        results = self._admit_free()
        if self._active:
            self._step_idx += 1
            self._occupancy_sum += len(self._active) / self.num_slots
            finished = self.backend.step()
            t_fin = time.perf_counter()
            for slot, result in sorted(finished.items()):
                entry = self._active.pop(slot)
                self._free.append(slot)
                self._finish(entry, result, t_fin)
                results.append(result)
        return results

    def run(self) -> List[Any]:
        """Serve until queue and pool are empty; results in completion
        order."""
        results: List[Any] = []
        while self._queue or self._active:
            results.extend(self.step())
        return results

    def stats(self) -> Dict:
        s = {"steps": self._step_idx, "queued": len(self._queue),
             "active": len(self._active), "served": self._served,
             "num_slots": self.num_slots,
             "occupancy_mean": (self._occupancy_sum / self._step_idx
                                if self._step_idx else 0.0),
             "queue_wait_s": _time_summary(
                 [r["queue_wait_s"] for r in self.request_log]),
             "service_s": _time_summary(
                 [r["service_s"] for r in self.request_log])}
        s.update(self.backend.stats())
        return s
