"""Autoregressive LM serving backend over the model's prefill/decode paths.

One *backend* of the wave scheduler in :mod:`repro_torch.serving.core`.  The
bucket key is the prompt length (every request in a wave shares positions,
so no pad token enters a request's state), a wave runs one prefill and up
to N decode steps, and per-request generation stops are tracked host-side.
On the card the prefill runs each RWKV6 layer's time-mix scan through the
hand-written scan kernel; decode is the one-token recurrence.

Sampling is greedy or temperature.  Temperature draws Gumbel noise from a
CPU generator seeded per ``(request uid, decode step)``
(:func:`repro_torch.serving.core.request_generator`), so a request's
sampled continuation never depends on what shared its wave, and the card
and the CPU sample with the same noise.  The draws differ from the JAX
package's ``jax.random`` folds.  Latency is reported per request: the wall
time from wave start to the decode step in which THAT request finished (EOS
or token budget), stamped after the step's device work is forced.

:class:`ServingEngine` binds the backend to the wave scheduler; the slot
(continuous-batching) scheduler is ROADMAP.md Queue 1 item 11's work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.model import LM
from repro_torch.serving.core import (ServingBackend, WaveScheduler,
                                      request_generator)


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
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(f"request {req.uid} exceeds max_seq "
                             f"({len(req.prompt)}+{req.max_new_tokens} > "
                             f"{self.max_seq})")

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
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}

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
                    self.params, states, tok, plen + step,
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
                gen = request_generator(self._sample_seed, r.uid, step)
                u = torch.rand(logits.shape[-1], generator=gen).clamp_min(
                    torch.finfo(torch.float32).tiny)
                gumbel = -torch.log(-torch.log(u)).to(logits.device)
                scaled = logits[i].float() / max(r.temperature, 1e-4)
                tok[i] = (scaled + gumbel).argmax()
        return tok

    def stats(self) -> Dict:
        return {"max_seq": self.max_seq, "wave_log": list(self.wave_log)}


def padded_prefill_safe(cfg: ModelConfig, max_seq: int) -> bool:
    """Can prompts be right-padded to a length bucket without changing the
    request's own logits?

    Exact for attention stacks (causal masking keeps pad rows out of every
    real row).  NOT exact for (a) recurrent kinds (mamba2/rwkv6 — the
    prefill scan folds pad tokens into the state) and (b) windowed attention
    with ``sliding_window < max_seq`` (the ring cache wraps, so pad rows
    evict in-window prompt entries).
    """
    kinds = [k for k, _ in list(cfg.pattern) + list(cfg.remainder)]
    for kind in kinds:
        if kind in ("mamba2", "rwkv6"):
            return False
        if kind in ("swa", "moe_swa") and cfg.sliding_window < max_seq:
            return False
    return True


class ServingEngine:
    """LM serving facade: an :class:`LMBackend` behind a
    :class:`~repro_torch.serving.core.WaveScheduler`, on ``device`` (the
    GPU unless the caller passes another)."""

    def __init__(self, cfg: ModelConfig, params=None, batch_size: int = 4,
                 max_seq: int = 256, seed: int = 0,
                 scheduler: str = "wave", device="cuda"):
        if scheduler == "slot":
            raise ValueError("scheduler='slot' (continuous batching) is not "
                             "ported yet (ROADMAP.md Queue 1 item 11)")
        if scheduler != "wave":
            raise ValueError(f"unknown scheduler {scheduler!r}; choose "
                             "'wave' or 'slot'")
        self.backend = LMBackend(cfg, params=params, batch_size=batch_size,
                                 max_seq=max_seq, seed=seed, device=device)
        self.scheduler = WaveScheduler(self.backend, batch_size=batch_size)
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
