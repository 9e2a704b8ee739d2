"""The port's token corpora and LM batch helpers against the JAX package's.

``data/tokens.py`` is numpy in both packages: the corpus, the batch
iterators and the trainer's local and correction batches are equal bit for
bit for the same arguments and generator.  The trainer's K schedule (with
its power-of-two buckets) and its byte accounting equal the JAX package's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro.core.schedules import local_epoch_schedule as jschedule
from repro.data import tokens as jtokens
from repro.launch import train as jtrain
from repro.models.transformer.model import LM as JLM
from repro.utils.pytree import tree_bytes as jtree_bytes
from repro_torch.data import tokens
from repro_torch.launch import train as ttrain

CORPORA = [(512, 2, 0.6, 0), (100, 3, 0.0, 1), (65536, 2, 1.0, 2),
           (300, 1, 0.5, 3)]


def _corpora(vocab, shards, het, seed, n=700):
    return (tokens.synthetic_corpus(vocab, shards, n, heterogeneity=het,
                                    seed=seed),
            jtokens.synthetic_corpus(vocab, shards, n, heterogeneity=het,
                                     seed=seed))


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("vocab,shards,het,seed", CORPORA)
def test_synthetic_corpus_equals_jax(vocab, shards, het, seed):
    got, want = _corpora(vocab, shards, het, seed)
    assert got.tokens.dtype == want.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert (got.vocab_size, got.heterogeneity, got.num_shards) == \
        (want.vocab_size, want.heterogeneity, want.num_shards)


@pytest.mark.parametrize("vocab,shards,het,seed", CORPORA)
def test_batch_iterator_and_global_batch_equal_jax(vocab, shards, het, seed):
    got_c, want_c = _corpora(vocab, shards, het, seed)
    for shard in range(shards):
        got = tokens.BatchIterator(got_c, shard, batch_size=5, seq_len=16,
                                   seed=seed)
        want = jtokens.BatchIterator(want_c, shard, batch_size=5, seq_len=16,
                                     seed=seed)
        assert iter(got) is got
        for _ in range(3):
            _equal(next(got), next(want))
        _equal(got.global_batch(), want.global_batch())
        _equal(got.global_batch(num_shards=1), want.global_batch(num_shards=1))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_shard_batch_equals_jax(shards):
    rng = np.random.default_rng(shards)
    batch = {"tokens": rng.integers(0, 50, (8, 6)).astype(np.int32),
             "labels": rng.integers(0, 50, (8, 6)).astype(np.int32)}
    for s in range(shards):
        _equal(tokens.shard_batch(batch, shards, s),
               jtokens.shard_batch(batch, shards, s))


@pytest.mark.parametrize("g,k,s_steps,bpg", [(1, 4, 1, 4), (3, 2, 2, 2)])
def test_local_and_correction_batches_equal_jax(g, k, s_steps, bpg):
    corpus, jcorpus = _corpora(512, g, 0.6, 5, n=2000)
    cfg = ttrain.TrainConfig(batch_per_group=bpg, seq_len=32,
                             correction_steps=s_steps)
    jcfg = jtrain.TrainConfig(**{k: v for k, v in dataclasses.asdict(cfg)
                                 .items() if k != "remat"})
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):                    # the generator carries across rounds
        local = ttrain._local_batches(corpus, g, k, cfg, rng)
        assert local["tokens"].shape == (g, k, bpg, 32)
        assert local["tokens"].dtype == torch.int32
        _equal({n: x.numpy() for n, x in local.items()},
               jtrain._local_batches(jcorpus, g, k, jcfg, jrng))
        corr = ttrain._corr_batches(corpus, cfg, rng)
        assert corr["tokens"].shape == (s_steps, 2 * bpg, 32)
        _equal({n: x.numpy() for n, x in corr.items()},
               jtrain._corr_batches(jcorpus, jcfg, jrng))


def test_train_config_fields_equal_jax():
    """The JAX package's fields and defaults, in its order, and the port's
    one more: ``remat`` (per-block recomputation, off by default)."""
    got = [(f.name, f.default) for f in dataclasses.fields(ttrain.TrainConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jtrain.TrainConfig)]
    assert got == want + [("remat", False)]


@pytest.mark.parametrize("base_k,rho,rounds", [(2, 1.3, 3), (1, 1.0, 4),
                                               (2, 1.3, 8), (3, 1.7, 6)])
def test_k_schedule_and_buckets_equal_jax(base_k, rho, rounds):
    """The rounds ``train`` runs: K·ρ^r bucketed up to a power of two."""
    from repro_torch.core.schedules import local_epoch_schedule
    bucket = lambda k: 1 << (k - 1).bit_length()
    assert [bucket(k) for k in local_epoch_schedule(base_k, rho, rounds)] \
        == [bucket(k) for k in jschedule(base_k, rho, rounds)]


def test_train_rounds_and_comm_equal_jax():
    """``train`` on the CPU runs the JAX package's K buckets and sums its
    bytes: 2·G·``tree_bytes`` of the JAX ``LM.init`` tree a round."""
    base_k, rho, rounds = 1, 1.5, 3     # K 2, 2, 3: the last bucketed
    want_k = [1 << (k - 1).bit_length()
              for k in jschedule(base_k, rho, rounds)]
    assert want_k == [2, 2, 4]
    shapes = jax.eval_shape(JLM(jconfigs.get_smoke_config("gemma3-1b")).init,
                            jax.random.PRNGKey(0))
    mb = jtree_bytes(shapes) / 1e6
    cfg = ttrain.TrainConfig(arch="gemma3-1b", smoke=True, rounds=rounds,
                             base_k=base_k, rho=rho, seq_len=8,
                             batch_per_group=1)
    _, metrics = ttrain.train(cfg, device="cpu")
    hist = metrics["history"]
    assert [h["k"] for h in hist] == want_k
    np.testing.assert_allclose([h["comm_mb"] for h in hist],
                               np.cumsum([2 * 1 * mb] * rounds), rtol=1e-12)
