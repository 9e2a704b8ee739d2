"""The JAX package's ``jax.random`` stream, replayed with integer tensor ops.

JAX's default PRNG is Threefry-2x32 (20 rounds) with
``jax_threefry_partitionable``: a key is two uint32 words, and every draw is
a counter-based hash, so the stream can be rebuilt exactly from its
definition:

* ``prng_key(seed) = (seed >> 32, seed & 0xffffffff)`` (``(0, seed)`` for
  the 32-bit seeds the JAX package uses);
* ``fold_in(key, d) = threefry2x32(key, (0, d))``;
* ``random_bits(key, shape)``: for each element, with ``i`` its row-major
  flat index, the xor of the two output words of
  ``threefry2x32(key, (i >> 32, i & 0xffffffff))``;
* ``randint(key, shape, lo, hi)``: two ``random_bits`` draws under
  ``fold_in(key, 0)`` and ``fold_in(key, 1)``, combined with uint32
  wrapping arithmetic (``jax.random.randint`` for int32).

Keys and ``fold_in`` are host Python integers (a few hashes per round).  The
bulk draws are ``int64`` tensor ops on any device, each add, rotate and
multiply masked back to 32 bits (PyTorch has no complete ``uint32``
arithmetic on either device), so the card and the CPU draw the same bits.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _threefry_int(key: Key, x0: int, x1: int) -> Key:
    """Threefry-2x32 of one counter pair on host integers."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as two uint32 words."""
    seed = int(seed)
    if seed < 0:                    # int32 seeds, as JAX converts them
        seed &= _M32
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    return _threefry_int(key, 0, int(data) & _M32)


def _threefry_tensor(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                     x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 elementwise on int64 tensors holding uint32 values;
    ``k0``/``k1`` broadcast against the counters."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_bits_many(keys: Sequence[Key], shape: Sequence[int],
                     device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for every key at once:
    an ``int64`` tensor ``(len(keys), *shape)`` of values in [0, 2³²)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    kt = torch.tensor([list(k) for k in keys], dtype=torch.int64,
                      device=device).reshape(len(keys), 1, 2)
    idx = torch.arange(n, dtype=torch.int64, device=device)[None]
    b0, b1 = _threefry_tensor(kt[..., 0], kt[..., 1], idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape((len(keys),) + shape)


def random_bits(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as ``int64`` values."""
    return random_bits_many([key], shape, device)[0]


def randint_many(keys: Sequence[Key], shape: Sequence[int], lo, hi,
                 device) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` (int32 draws) for every
    key at once, as ``int64`` ``(len(keys), *shape)``.  ``lo``/``hi`` are
    ints or ``int64`` tensors broadcasting against ``(len(keys), 1, …)``;
    a span ``hi - lo ≤ 0`` returns ``lo``, as JAX does."""
    hi_bits = random_bits_many([fold_in(k, 0) for k in keys], shape, device)
    lo_bits = random_bits_many([fold_in(k, 1) for k in keys], shape, device)
    lo_t = torch.as_tensor(lo, dtype=torch.int64, device=device)
    hi_t = torch.as_tensor(hi, dtype=torch.int64, device=device)
    span = torch.where(hi_t <= lo_t, torch.ones_like(hi_t),
                       (hi_t - lo_t) & _M32)
    # JAX's multiplier, (2¹⁶ mod span)² mod span, squared in uint32: it
    # wraps when 2¹⁶ mod span is 2¹⁶; the product and the sum below are
    # each masked to 32 bits too
    m = 65536 % span
    mult = ((m * m) & _M32) % span
    off = (((hi_bits % span) * mult) & _M32) + (lo_bits % span)
    off = (off & _M32) % span
    return lo_t + off


def randint(key: Key, shape: Sequence[int], lo, hi, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` as ``int64`` values."""
    return randint_many([key], shape, lo, hi, device)[0]
