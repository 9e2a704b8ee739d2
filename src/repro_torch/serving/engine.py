"""Autoregressive LM serving backend over the model's prefill/decode paths.

One *backend* of the wave scheduler in :mod:`repro_torch.serving.core`.  The
bucket key is the prompt length (every request in a wave shares positions,
so no pad token enters a request's state), a wave runs one prefill and up
to N decode steps, and per-request generation stops are tracked host-side.
On the card the prefill runs each RWKV6 layer's time-mix scan and each
Mamba2 layer's SSD scan through the hand-written scan kernel; decode is the
one-token recurrence.  Attention caches are sized at prefill (``max_seq``
slots for full attention, a ring of ``min(window, max_seq)`` for sliding
windows), and the decode step at wave position ``prefix + plen + step``
writes its slot.  A vision config's prefill takes zero ``patches`` for its
``prefix`` of ``num_prefix_tokens`` rows, as the JAX package's backends
pass, and every position counts them; a request whose ``prefix + prompt +
new tokens`` overflow ``max_seq`` is refused at submit (the JAX package
counts only ``prompt + new`` and lets the cache clamp).

Sampling is greedy or temperature.  Temperature draws Gumbel noise from a
CPU generator seeded per ``(request uid, decode step)``
(:func:`repro_torch.serving.core.request_generator`), so a request's
sampled continuation never depends on what shared its wave, and the card
and the CPU sample with the same noise.  The draws differ from the JAX
package's ``jax.random`` folds.  Latency is reported per request: the wall
time from wave start to the decode step in which THAT request finished (EOS
or token budget), stamped after the step's device work is forced.

:class:`LMSlotBackend` is the continuous-batching path behind
:class:`~repro_torch.serving.core.SlotScheduler`: a persistent pool of
per-slot decode states, requests ``prefill → insert(slot) → step``-ped,
admitted into free slots and retired individually the step they finish.
Each slot decodes at its own position (an MoE routing each slot's token
alone, as the JAX package's ``vmap`` of batch-1 steps).  Prompts are
right-padded to a power-of-two bucket where padding is exact
(:func:`padded_prefill_safe`).
Sampling draws from the same per-``(uid, own token index)`` generators,
so a request's continuation is independent of its co-residents, their
slots and the admission order.

:class:`ServingEngine` binds a backend to a scheduler: ``scheduler="wave"``
(default) or ``"slot"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.manager import TraceCounter, trace_signature
from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.model import LM, per_row_positions
from repro_torch.serving.core import (ServingBackend, SlotBackend,
                                      SlotScheduler, WaveScheduler,
                                      request_generator)
from repro_torch.utils.pytree import flatten_with_paths, map_with_paths


def _temperature_sample(row: torch.Tensor, temperature: float, seed: int,
                        uid: int, step: int) -> torch.Tensor:
    """A categorical draw from ``row / temperature``: the argmax plus Gumbel
    noise from the request's ``(seed, uid, step)`` CPU generator."""
    gen = request_generator(seed, uid, step)
    u = torch.rand(row.shape[-1], generator=gen).clamp_min(
        torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u)).to(row.device)
    return (row.float() / max(temperature, 1e-4) + gumbel).argmax()


def _prefix(cfg: ModelConfig) -> int:
    """Rows the frontend puts before the prompt: a vision config's patch
    tokens, else none."""
    return cfg.num_prefix_tokens if cfg.frontend == "vision" else 0


def _prompt_batch(model: LM, toks: np.ndarray, device) -> Dict:
    """A prefill batch of right-padded prompt rows; a vision config's
    gets zero patches for its prefix."""
    cfg = model.cfg
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.zeros(
            (toks.shape[0], cfg.num_prefix_tokens, cfg.frontend_dim),
            dtype=model.dtype, device=device)
    return batch


def _validate(req: "Request", cfg: ModelConfig, max_seq: int) -> None:
    """Refuse a request that would overflow ``max_seq`` once the prefix
    is counted."""
    prefix = _prefix(cfg)
    if prefix + len(req.prompt) + req.max_new_tokens > max_seq:
        raise ValueError(f"request {req.uid} exceeds max_seq ({prefix} "
                         f"prefix + {len(req.prompt)} + "
                         f"{req.max_new_tokens} > {max_seq})")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: Optional[int] = None


@dataclasses.dataclass
class ServeResult:
    uid: int
    tokens: List[int]
    prompt_len: int
    latency_s: float
    wave: int


class LMBackend(ServingBackend):
    """Prefill/decode execution for one :class:`ModelConfig` on
    ``device`` (the GPU unless the caller passes another)."""

    def __init__(self, cfg: ModelConfig, params=None, batch_size: int = 4,
                 max_seq: int = 256, seed: int = 0, device="cuda"):
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} is encoder-only — cannot serve")
        self.cfg = cfg
        self.model = LM(cfg)
        self.max_seq = max_seq
        self.batch_size = batch_size  # device batch: waves must fit in it
        self.device = torch.device(device)
        self.params = params if params is not None else \
            self.model.init(seed, self.device)
        self._sample_seed = seed + 1
        #: one record per wave: requests, prompt length, time to first
        #: token, decode steps and their wall time (seconds)
        self.wave_log: List[Dict] = []

    # ------------------------------------------------------------- protocol
    def validate(self, req: Request) -> None:
        _validate(req, self.cfg, self.max_seq)

    def bucket_key(self, req: Request) -> int:
        return len(req.prompt)

    def run_wave(self, wave: Sequence[Request], wave_index: int
                 ) -> List[ServeResult]:
        t0 = time.perf_counter()
        bsz = self.batch_size
        if len(wave) > bsz:
            raise ValueError(f"wave of {len(wave)} exceeds backend "
                             f"batch_size {bsz}")
        plen = len(wave[0].prompt)           # bucketed: all equal
        toks = np.zeros((bsz, plen), np.int64)
        for i, r in enumerate(wave):
            toks[i] = r.prompt
        batch = _prompt_batch(self.model, toks, self.device)
        start = _prefix(self.cfg) + plen

        with torch.no_grad():
            logits, states = self.model.prefill(self.params, batch,
                                                max_seq=self.max_seq)
        n_steps = max(r.max_new_tokens for r in wave)
        generated: List[List[int]] = [[] for _ in wave]
        done = [False] * len(wave)
        latency = [0.0] * len(wave)

        def ingest(tok_row: List[int]) -> None:
            """Fold one step's sampled tokens into the per-request streams.

            A sampled EOS ends the request WITHOUT being emitted — including
            on the very first (post-prefill) token.  ``tok_row`` is already
            on the host, so the step's device work is counted.
            """
            now = time.perf_counter()
            for i, r in enumerate(wave):
                if done[i]:
                    continue
                if len(generated[i]) >= r.max_new_tokens:  # max_new_tokens=0
                    done[i], latency[i] = True, now - t0
                    continue
                t = tok_row[i]
                if r.eos_id is not None and t == r.eos_id:
                    done[i], latency[i] = True, now - t0
                    continue
                generated[i].append(t)
                if len(generated[i]) >= r.max_new_tokens:
                    done[i], latency[i] = True, now - t0

        tok = self._sample(logits, wave, step=0)
        ingest(tok.tolist())
        ttft = time.perf_counter() - t0
        steps = 0
        for step in range(n_steps - 1):
            if all(done):
                break
            steps += 1
            with torch.no_grad():
                logits, states = self.model.decode_step(
                    self.params, states, tok, start + step,
                    max_seq=self.max_seq)
            tok = self._sample(logits, wave, step=step + 1)
            ingest(tok.tolist())
        wave_s = time.perf_counter() - t0
        self.wave_log.append({"wave": wave_index, "requests": len(wave),
                              "prompt_len": plen, "ttft_s": ttft,
                              "decode_steps": steps,
                              "decode_s": wave_s - ttft})
        return [ServeResult(uid=r.uid, tokens=generated[i],
                            prompt_len=len(r.prompt),
                            latency_s=latency[i] if done[i] else wave_s,
                            wave=wave_index)
                for i, r in enumerate(wave)]

    # ------------------------------------------------------------- sampling
    def _sample(self, logits: torch.Tensor, wave: Sequence[Request],
                step: int) -> torch.Tensor:
        """Greedy rows take the argmax; a row with ``temperature > 0`` the
        argmax of ``logits / T`` plus Gumbel noise from its request's
        generator — a categorical draw.  Rows past the wave stay greedy."""
        tok = logits.argmax(-1)
        for i, r in enumerate(wave):
            if r.temperature > 0:
                tok[i] = _temperature_sample(logits[i], r.temperature,
                                             self._sample_seed, r.uid, step)
        return tok

    def stats(self) -> Dict:
        return {"max_seq": self.max_seq, "wave_log": list(self.wave_log)}


def padded_prefill_safe(cfg: ModelConfig, max_seq: int) -> bool:
    """Can prompts be right-padded to a length bucket without changing the
    request's own logits?

    Exact for dense attention stacks (causal masking keeps pad rows out of
    every real row).  NOT exact for (a) recurrent kinds (mamba2/rwkv6 — the
    prefill scan folds pad tokens into the state), (b) windowed attention
    with ``sliding_window < max_seq`` (the ring cache wraps, so pad rows
    evict in-window prompt entries) and (c) the MoE kinds: the expert
    capacity grows with the padded length, which changes which of the real
    tokens' assignments are dropped.  The JAX package's version says MoE
    pads exactly (ROADMAP.md Queue 3).
    """
    kinds = [k for k, _ in list(cfg.pattern) + list(cfg.remainder)]
    for kind in kinds:
        if kind in ("mamba2", "rwkv6", "moe", "moe_swa"):
            return False
        if kind in ("swa", "moe_swa") and cfg.sliding_window < max_seq:
            return False
    return True


class LMSlotBackend(SlotBackend):
    """Continuous-batching LM execution: a per-slot decode-state pool.

    Pool layout: the model's batch-``num_slots`` decode state in the
    per-row layout (:func:`~repro_torch.models.transformer.model.
    per_row_positions`: each attention cache holds its slots' positions
    per row), each leaf's batch axis split into (slot, rows per request)
    and moved to the front, so ``pool[slot]`` is one request's batch-1
    state (a view: the step decodes the whole pool in the model's batch
    layout with no copy).  ``admit`` runs a batch-1 prefill per prompt
    bucket — on the card every RWKV6 and Mamba2 layer's scan through the
    scan kernel — samples the first token and copies the prefill's state
    into the slot, a full overwrite, so slot reuse leaks nothing between
    requests.  ``step`` advances ALL slots with one batched decode, each
    at its own position (the JAX package's ``vmap`` over slots; an MoE
    routes each slot's token alone); free slots decode garbage at position
    0 that is never read, so occupancy never changes the step's shapes.

    :attr:`prefill_bucket`: ``"pow2"`` where :func:`padded_prefill_safe`
    says padding is exact — each prompt right-padded to ``min(max(8, next
    power of two), max_seq − prefix)`` (the JAX package clamps at
    ``max_seq``), the logits read at its last real token (the
    cache's pad entries carry positions past the prompt, so decode's
    validity mask hides them until the decode stream overwrites them) —
    else ``"exact"``, each prompt prefilled at its length.  Sampling:
    :class:`LMBackend`'s per-``(uid, step)`` generators, ``step`` the
    request's OWN token index.
    """

    def __init__(self, cfg: ModelConfig, params=None, num_slots: int = 4,
                 max_seq: int = 256, seed: int = 0, device="cuda"):
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} is encoder-only — cannot serve")
        if num_slots < 1:
            raise ValueError("num_slots must be ≥ 1")
        self.cfg = cfg
        self.model = LM(cfg)
        self.max_seq = max_seq
        self.device = torch.device(device)
        self._num_slots = int(num_slots)
        self.params = params if params is not None else \
            self.model.init(seed, self.device)
        self._sample_seed = seed + 1         # LMBackend's generators
        # distinct prefill / step input signatures: the programs a compiled
        # path would build (one per prompt bucket, one step)
        self._prefill_traces = TraceCounter()
        self._step_traces = TraceCounter()
        self._prefill_lens: set = set()
        self._pool = None          # slot-leading views of _pool_batch
        self._pool_batch = None    # the batch-num_slots decode state
        S = self._num_slots
        self._tokens = np.zeros(S, np.int64)
        self._positions = np.zeros(S, np.int64)
        self._steps = np.zeros(S, np.int64)
        self._slots: List[Optional[Dict]] = [None] * S
        self._generate_steps = 0

    # ------------------------------------------------------------- the pool
    def _batch_axes(self) -> Dict[str, tuple]:
        """Per state leaf: (batch axis, rows per request), read off the
        per-row zero states of batch 1 and 2."""
        one, two = (dict(flatten_with_paths(per_row_positions(
            self.model.init_states(self.params, b, self.max_seq), b)))
            for b in (1, 2))
        axes = {}
        for key, a in one.items():
            diff = [i for i, (x, y) in enumerate(zip(a.shape, two[key].shape))
                    if x != y]
            axes[key] = (diff[0], a.shape[diff[0]])
        return axes

    def _views(self, batch_state: Dict) -> Dict:
        """Slot-leading views of a batch-layout state tree."""
        S = self._num_slots
        return map_with_paths(
            lambda k, x: x.unflatten(self._axes[k][0],
                                     (S, self._axes[k][1]))
            .movedim(self._axes[k][0], 0), batch_state)

    def _alloc_pool(self, state: Dict) -> None:
        """Zero pool shaped by a batch-1 prefill state."""
        self._axes = self._batch_axes()
        S = self._num_slots

        def zeros(k, x):
            shape = list(x.shape)
            shape[self._axes[k][0]] *= S
            return torch.zeros(shape, dtype=x.dtype, device=x.device)
        self._pool_batch = map_with_paths(zeros, state)
        self._pool = self._views(self._pool_batch)

    # ------------------------------------------------------------- protocol
    @property
    def num_slots(self) -> int:
        return self._num_slots

    @property
    def prefill_bucket(self) -> str:
        return ("pow2" if padded_prefill_safe(self.cfg, self.max_seq)
                else "exact")

    @property
    def prefill_retraces(self) -> int:
        return self._prefill_traces.count_value

    @property
    def step_retraces(self) -> int:
        return self._step_traces.count_value

    def validate(self, req: Request) -> None:
        _validate(req, self.cfg, self.max_seq)
        if not req.prompt:
            raise ValueError(f"request {req.uid} has an empty prompt")

    def bucket_key(self, req: Request) -> int:
        plen = len(req.prompt)
        if self.prefill_bucket == "exact":
            return plen
        return min(max(8, 1 << (plen - 1).bit_length()),
                   self.max_seq - _prefix(self.cfg))

    def _sample(self, row: torch.Tensor, temperature: float, uid: int,
                step: int) -> int:
        if temperature > 0:
            return int(_temperature_sample(row, temperature,
                                           self._sample_seed, uid, step))
        return int(row.argmax())

    def _result(self, entry: Dict, now: float) -> ServeResult:
        return ServeResult(uid=entry["req"].uid, tokens=entry["tokens"],
                           prompt_len=len(entry["req"].prompt),
                           latency_s=now - entry["t0"],
                           wave=self._generate_steps)

    def admit(self, slot: int, req: Request) -> Optional[ServeResult]:
        """Batch-1 prefill of the request's bucket (the prompt right-padded
        with token 0), first-token sample at its last real token and the
        copy of its state into ``slot``; returns the finished result
        instead when the request completes at admission (zero token
        budget, or EOS as the first sampled token — the slot's state is
        then simply never read)."""
        t0 = time.perf_counter()
        plen = len(req.prompt)
        bucket = self.bucket_key(req)
        start = _prefix(self.cfg) + plen
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = req.prompt
        batch = _prompt_batch(self.model, toks, self.device)
        self._prefill_traces.count(trace_signature(batch))
        with torch.no_grad():
            logits, state = self.model.prefill(self.params, batch,
                                               max_seq=self.max_seq,
                                               last_index=start - 1)
            state = per_row_positions(state, 1)
            if self._pool is None:
                self._alloc_pool(state)
            map_with_paths(lambda k, x: self._pool_at(k, slot).copy_(x),
                           state)
        self._prefill_lens.add(bucket)
        entry = {"req": req, "tokens": [], "t0": t0}
        if req.max_new_tokens == 0:
            return self._result(entry, time.perf_counter())
        tok0 = self._sample(logits[0], req.temperature, req.uid, 0)
        if req.eos_id is not None and tok0 == req.eos_id:
            return self._result(entry, time.perf_counter())
        entry["tokens"].append(tok0)
        if req.max_new_tokens == 1:
            return self._result(entry, time.perf_counter())
        self._slots[slot] = entry
        self._tokens[slot] = tok0
        self._positions[slot] = start
        self._steps[slot] = 1
        return None

    def _pool_at(self, key: str, slot: int) -> torch.Tensor:
        node = self._pool
        for part in key.split("/"):
            node = node[part]
        return node[slot]

    def step(self) -> Dict[int, ServeResult]:
        """One decode step of the whole pool, each slot at its own
        position; returns the slots that finished."""
        tokens = torch.from_numpy(self._tokens).to(self.device)
        positions = torch.from_numpy(self._positions).to(self.device)
        self._step_traces.count(trace_signature((tokens, positions,
                                                 self._pool_batch)))
        with torch.no_grad():
            logits, new = self.model.decode_step(
                self.params, self._pool_batch, tokens, positions,
                max_seq=self.max_seq)
        self._pool_batch = new
        self._pool = self._views(new)
        greedy = logits.argmax(-1).cpu().numpy()   # forces the step's work
        self._generate_steps += 1
        now = time.perf_counter()
        finished: Dict[int, ServeResult] = {}
        for slot, entry in enumerate(self._slots):
            if entry is None:
                continue
            req = entry["req"]
            t = (self._sample(logits[slot], req.temperature, req.uid,
                              int(self._steps[slot]))
                 if req.temperature > 0 else int(greedy[slot]))
            self._tokens[slot] = t
            self._positions[slot] += 1
            self._steps[slot] += 1
            if req.eos_id is not None and t == req.eos_id:
                finished[slot] = self._result(entry, now)
            else:
                entry["tokens"].append(t)
                if len(entry["tokens"]) >= req.max_new_tokens:
                    finished[slot] = self._result(entry, now)
        for slot in finished:
            self._slots[slot] = None
            self._positions[slot] = 0    # retired slots decode junk at 0
            self._steps[slot] = 0
        return finished

    def stats(self) -> Dict:
        return {"max_seq": self.max_seq,
                "prefill_bucket": self.prefill_bucket,
                "prefill_lens_compiled": sorted(self._prefill_lens),
                "prefill_retraces": self.prefill_retraces,
                "step_retraces": self.step_retraces,
                "generate_steps": self._generate_steps}


class ServingEngine:
    """LM serving facade: an LM backend behind a scheduler, on ``device``
    (the GPU unless the caller passes another).  ``scheduler="wave"``
    (default) runs :class:`LMBackend` behind the wave scheduler;
    ``"slot"`` runs :class:`LMSlotBackend` behind the slot scheduler, with
    ``batch_size`` sizing the slot pool."""

    def __init__(self, cfg: ModelConfig, params=None, batch_size: int = 4,
                 max_seq: int = 256, seed: int = 0,
                 scheduler: str = "wave", device="cuda"):
        if scheduler == "wave":
            self.backend = LMBackend(cfg, params=params,
                                     batch_size=batch_size, max_seq=max_seq,
                                     seed=seed, device=device)
            self.scheduler = WaveScheduler(self.backend,
                                           batch_size=batch_size)
        elif scheduler == "slot":
            self.backend = LMSlotBackend(cfg, params=params,
                                         num_slots=batch_size,
                                         max_seq=max_seq, seed=seed,
                                         device=device)
            self.scheduler = SlotScheduler(self.backend)
        else:
            raise ValueError(f"unknown scheduler {scheduler!r}; choose "
                             "'wave' or 'slot'")
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_seq = max_seq

    @property
    def params(self):
        return self.backend.params

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    def run(self) -> List[ServeResult]:
        return self.scheduler.run()

    def stats(self) -> Dict:
        return self.scheduler.stats()
