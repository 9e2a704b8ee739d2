"""The JAX package's documented ``jax.random`` stream (Threefry-2x32, 20
rounds, partitionable) and the round draw of neighbor tables and batches
that the device sampler makes from it, written from the definitions.

* ``prng_key(seed) = (seed >> 32, seed & 0xffffffff)``;
  ``fold_in(key, d) = threefry(key, (0, d))``;
* ``bits(key, shape)``: element i (row-major) is the xor of the two words of
  ``threefry(key, (i >> 32, i & 0xffffffff))``;
* ``randint(key, shape, lo, hi)``: JAX's two-draw construction.

A round r of machine p, step s uses ``k = fold_in(fold_in(fold_in(
PRNGKey(seed), r), p), s)``: ``fold_in(k, 0)`` keys the neighbor slots,
``fold_in(k, 1)`` the without-replacement batch, ``fold_in(k, 2)`` the
with-replacement batch (pools smaller than the batch).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
PAIRWISE_MAX = 128          # widest key row ranked by the pairwise rule

Key = Tuple[int, int]


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32 on host ints or int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int) -> Key:
    seed = int(seed)
    if seed < 0:
        seed &= M32
    return (seed >> 32) & M32, seed & M32


def fold_in(key: Key, data: int) -> Key:
    return _threefry(key[0], key[1], 0, int(data) & M32)


def bits(keys: Sequence[Key], shape: Sequence[int], device) -> torch.Tensor:
    """``(len(keys), *shape)`` int64 tensor of uint32 draws."""
    n = int(np.prod(shape))
    kt = torch.tensor([list(k) for k in keys], dtype=torch.int64,
                      device=device).reshape(len(keys), 1, 2)
    idx = torch.arange(n, dtype=torch.int64, device=device)[None]
    b0, b1 = _threefry(kt[..., 0], kt[..., 1], idx >> 32, idx & M32)
    return (b0 ^ b1).reshape((len(keys),) + tuple(shape))


def randint(keys: Sequence[Key], shape: Sequence[int], lo, hi,
            device) -> torch.Tensor:
    hb = bits([fold_in(k, 0) for k in keys], shape, device)
    lb = bits([fold_in(k, 1) for k in keys], shape, device)
    lo = torch.as_tensor(lo, dtype=torch.int64, device=device)
    hi = torch.as_tensor(hi, dtype=torch.int64, device=device)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & M32)
    m = 65536 % span
    mult = ((m * m) & M32) % span
    off = (((hb % span) * mult) & M32) + (lb % span)
    return lo + (off & M32) % span


def smallest(keys_bits: torch.Tensor, valid: torch.Tensor,
             width: int) -> torch.Tensor:
    """Indices of the ``width`` smallest keys per row without replacement,
    in JAX's order: rows up to ``PAIRWISE_MAX`` wide rank valid slots by
    ``((b >> (1+ib)) << ib) | i`` and invalid ones by ``2^31 | i``; wider
    rows take a stable top-k of ``b >> 1`` (invalid ``2^32 - 1``)."""
    dmax = keys_bits.shape[-1]
    w = min(width, dmax)
    ib = max(int(dmax - 1).bit_length(), 1)
    idx = torch.arange(dmax, dtype=torch.int64, device=keys_bits.device)
    if dmax <= PAIRWISE_MAX:
        key = torch.where(valid, ((keys_bits >> (1 + ib)) << ib) | idx,
                          (1 << 31) | idx)
    else:
        key = (torch.where(valid, keys_bits >> 1, M32) << ib) | idx
    sel = torch.sort(key, dim=-1).indices[..., :w]
    if w < width:
        sel = torch.nn.functional.pad(sel, (0, width - w))
    return sel


def round_draw(graphs, pools, n_pad: int, dmax: int, fanout: int,
               batch: int, seed: int, r: int, steps: int, device):
    """Every machine's ``steps`` neighbor tables (P, K, n_pad, fanout),
    masks, and batches (P, K, batch) of round ``r``.  ``graphs`` are the
    machines' ``(indptr, indices)`` host arrays, ``pools`` their train
    nodes (local ids)."""
    P = len(graphs)
    key = fold_in(prng_key(seed), r)
    ks = [fold_in(fold_in(key, p), s) for p in range(P) for s in range(steps)]
    t_pad = max(max(len(x) for x in pools), batch, 1)
    e_pad = max(max(g[1].size for g in graphs), 1)
    ind = torch.zeros((P, e_pad), dtype=torch.int64)
    st = torch.zeros((P, n_pad), dtype=torch.int64)
    dg = torch.zeros((P, n_pad), dtype=torch.int64)
    tn = torch.zeros((P, t_pad), dtype=torch.int64)
    for p, (ip, ix) in enumerate(graphs):
        n = ip.size - 1
        ind[p, :ix.size] = torch.from_numpy(ix.astype(np.int64))
        st[p, :n] = torch.from_numpy(ip[:-1].astype(np.int64))
        dg[p, :n] = torch.from_numpy(np.diff(ip).astype(np.int64))
        tn[p, :len(pools[p])] = torch.from_numpy(
            np.asarray(pools[p], np.int64))
    ind, st, dg, tn = (x.to(device) for x in (ind, st, dg, tn))
    cnt = torch.tensor([len(x) for x in pools], dtype=torch.int64,
                       device=device)[:, None, None]
    b = bits([fold_in(k, 0) for k in ks], (n_pad, dmax), device
             ).reshape(P, steps, n_pad, dmax)
    col = torch.arange(dmax, device=device)
    sel = smallest(b, col < dg[:, None, :, None], fanout)
    del b
    valid = (torch.arange(fanout, device=device)
             < torch.clamp(dg, max=fanout)[:, None, :, None])
    at = (st[:, None, :, None] + sel).clamp(0, e_pad - 1)
    vals = torch.gather(ind, 1, at.reshape(P, -1)).reshape(at.shape)
    tables = torch.where(valid, vals, 0)
    masks = valid.expand(tables.shape).float()
    bb = bits([fold_in(k, 1) for k in ks], (t_pad,), device
              ).reshape(P, steps, t_pad)
    wor = smallest(bb, torch.arange(t_pad, device=device) < cnt, batch)
    rep = randint([fold_in(k, 2) for k in ks], (batch,), 0,
                  cnt.clamp_min(1).repeat_interleave(steps, 0)
                  .reshape(P * steps, 1), device).reshape(P, steps, batch)
    pick = torch.where(cnt >= batch, wor[..., :batch], rep)
    batches = torch.gather(tn, 1, pick.reshape(P, -1)).reshape(
        P, steps, batch)
    return tables, masks, batches
