"""Synthetic token corpora + batch iterators for the LM architectures — the
port's copy of the JAX package's ``data/tokens.py`` (numpy, so its outputs
equal the JAX package's bit for bit for the same arguments).

No real corpora: deterministic synthetic token streams with enough
structure that the loss decreases in training, a mixture of per-shard
Markov chains.  The mixture weights differ per shard, a controllable
heterogeneity knob — the paper's κ²_X transplanted to i.i.d.-token models
(Section 4.1: κ²_X = 0 iff shards are i.i.d.).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenDataset:
    tokens: np.ndarray          # (num_shards, tokens_per_shard) int32
    vocab_size: int
    heterogeneity: float        # 0 = i.i.d. shards, 1 = fully disjoint chains

    @property
    def num_shards(self) -> int:
        return int(self.tokens.shape[0])


def synthetic_corpus(vocab_size: int, num_shards: int, tokens_per_shard: int,
                     heterogeneity: float = 0.5, order: int = 1,
                     num_chains: int = 8, seed: int = 0) -> TokenDataset:
    """Markov-mixture corpus.

    ``num_chains`` latent Markov chains over a reduced alphabet are blended
    per shard; ``heterogeneity`` interpolates between a shared mixture
    (i.i.d. shards) and one chain per shard (maximally non-i.i.d.).
    ``order`` is kept for the JAX signature (first-order chains).
    """
    rng = np.random.default_rng(seed)
    alphabet = min(vocab_size, 256)
    # sparse-ish transition matrices per chain
    trans = rng.dirichlet(np.full(alphabet, 0.05), size=(num_chains, alphabet))
    shared_mix = rng.dirichlet(np.full(num_chains, 1.0))
    out = np.zeros((num_shards, tokens_per_shard), dtype=np.int32)
    for s in range(num_shards):
        own = np.zeros(num_chains)
        own[s % num_chains] = 1.0
        mix = (1 - heterogeneity) * shared_mix + heterogeneity * own
        chain_ids = rng.choice(num_chains, size=tokens_per_shard // 64 + 1,
                               p=mix)
        toks = np.empty(tokens_per_shard, dtype=np.int32)
        state = int(rng.integers(alphabet))
        for i in range(tokens_per_shard):
            chain = chain_ids[i // 64]
            state = int(rng.choice(alphabet, p=trans[chain, state]))
            toks[i] = state
        # spread the reduced alphabet across the real vocab deterministically
        out[s] = (toks * (vocab_size // alphabet)) % vocab_size
    return TokenDataset(tokens=out, vocab_size=vocab_size,
                        heterogeneity=heterogeneity)


@dataclasses.dataclass
class BatchIterator:
    """Per-shard (= per LLCG machine) batch stream of (tokens, labels)."""

    dataset: TokenDataset
    shard: int
    batch_size: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed + 7919 * self.shard)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        stream = self.dataset.tokens[self.shard]
        max_start = stream.size - self.seq_len - 1
        starts = self._rng.integers(0, max_start, size=self.batch_size)
        toks = np.stack([stream[s:s + self.seq_len] for s in starts])
        labels = np.stack([stream[s + 1:s + self.seq_len + 1]
                           for s in starts])
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def global_batch(self, num_shards: Optional[int] = None) -> dict:
        """Uniformly mixed batch across shards — the server-correction ξ."""
        ns = num_shards or self.dataset.num_shards
        per = -(-self.batch_size // ns)  # ceil: always fills the batch
        toks, labels = [], []
        for s in range(ns):
            stream = self.dataset.tokens[s]
            max_start = stream.size - self.seq_len - 1
            starts = self._rng.integers(0, max_start, size=per)
            toks += [stream[t:t + self.seq_len] for t in starts]
            labels += [stream[t + 1:t + self.seq_len + 1] for t in starts]
        toks = np.stack(toks[:self.batch_size])
        labels = np.stack(labels[:self.batch_size])
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}


def shard_batch(batch: dict, num_shards: int, shard: int) -> dict:
    """Slice a global batch along axis 0 for one shard."""
    def slc(x):
        per = x.shape[0] // num_shards
        return x[shard * per:(shard + 1) * per]
    return {k: slc(v) for k, v in batch.items()}
