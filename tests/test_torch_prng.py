"""The port's replay of ``jax.random`` (``repro_torch.utils.threefry``)
against JAX itself, bit for bit.

JAX's default PRNG here is Threefry-2x32 with ``jax_threefry_partitionable``
on (checked below: the replay is of that stream).  Keys, ``fold_in``,
``bits`` and ``randint`` must equal JAX's exactly: seeds 0 through
2³¹−1, fold data up to 2³²−1, a 3-D shape (so the flat counter's
row-major order is checked), and ``randint`` spans 1 through 2³¹−1 —
including spans above 2¹⁶, where JAX's multiplier wraps in uint32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.utils import threefry as T

SEEDS = (0, 1, 42, 2 ** 31 - 1)
SPANS = (1, 2, 7, 100, 12345, 2 ** 16, 2 ** 16 + 1, 70000, 2 ** 20,
         10 ** 9 + 7, 2 ** 30, 2 ** 31 - 1)


def _words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


def test_stream_is_threefry_partitionable():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    assert _words(key) == T.prng_key(seed)
    for d in (0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1):
        assert _words(jax.random.fold_in(key, d)) == T.fold_in(
            T.prng_key(seed), d), d
    # chained folds, as the device sampler's key tree makes them
    k, kk = key, T.prng_key(seed)
    for d in (3, 0, 11, 2):
        k, kk = jax.random.fold_in(k, d), T.fold_in(kk, d)
    assert _words(k) == kk


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 5), (4, 1, 129)])
def test_random_bits(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    want = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32))
    got = T.random_bits(T.fold_in(T.prng_key(seed), 9), shape, "cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_spans(seed):
    key, kk = jax.random.PRNGKey(seed), T.prng_key(seed)
    for span in SPANS:
        want = np.asarray(jax.random.randint(key, (4, 9), 0, span))
        got = T.randint(kk, (4, 9), 0, span, "cpu")
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=f"span {span}")
    for lo, hi in ((5, 17), (-3, 40), (10, 2), (7, 7)):
        want = np.asarray(jax.random.randint(key, (2, 3, 4), lo, hi))
        got = T.randint(kk, (2, 3, 4), lo, hi, "cpu")
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=f"[{lo}, {hi})")


def test_many_keys_at_once_equal_one_at_a_time():
    keys = [T.fold_in(T.prng_key(5), i) for i in range(6)]
    bits = T.random_bits_many(keys, (3, 4), "cpu")
    hi = torch.tensor([1, 5, 100, 70000, 2 ** 31 - 1, 3])[:, None]
    ints = T.randint_many(keys, (8,), 0, hi, "cpu")
    for i, k in enumerate(keys):
        assert torch.equal(bits[i], T.random_bits(k, (3, 4), "cpu"))
        assert torch.equal(ints[i], T.randint(k, (8,), 0, int(hi[i]), "cpu"))
