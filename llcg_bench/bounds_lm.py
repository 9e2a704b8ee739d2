"""Operation and byte counts of an LM training round, from shapes, by
``bounds.py``'s convention: every input byte read once and every output
byte written once, nothing saved for a backward counted, a multiply-add as
two operations.  A later implementation of the same work is held to the
same counts, so these functions never change.
"""
from __future__ import annotations

from typing import Tuple


# --------------------------------------------------------------------------
# the strict gated linear scan (RWKV6's time mix) and its gradient
# --------------------------------------------------------------------------
def _chunks(t: int, chunk: int):
    for c0 in range(0, t, chunk):
        ln = min(chunk, t - c0)
        yield c0, ln, ln * (ln - 1) // 2       # strict: pairs s < t


def scan_work(bh: int, t: int, chunk: int, dk: int, dv: int
              ) -> Tuple[float, float]:
    """``(bytes, operations)`` of one strict scan with the bonus u and no
    initial state: q, k, log w (bh, t, dk), v (bh, t, dv) and u (bh, dk)
    read, y (bh, t, dv) and h_T (bh, dk, dv) written.  Per head and chunk
    of l steps: the masked products q~k~^T and A V over the l(l-1)/2 kept
    pairs, the inter-chunk read q~ h_in (none in the first chunk), the
    state update, three exponentials or scalings per (step, key) and the
    bonus."""
    nbytes = 4 * (bh * t * (3 * dk + dv) + bh * dk
                  + bh * t * dv + bh * dk * dv)
    ops = 0.0
    for c0, ln, pairs in _chunks(t, chunk):
        ops += 2.0 * pairs * (dk + dv) + 2.0 * ln * dk * dv
        if c0:
            ops += 2.0 * ln * dk * dv
        ops += 3.0 * ln * dk + 2.0 * ln * (dk + dv)
    return float(nbytes), bh * ops


def scan_bwd_work(bh: int, t: int, chunk: int, dk: int, dv: int
                  ) -> Tuple[float, float]:
    """``(bytes, operations)`` of the gradient of :func:`scan_work`'s scan
    for a cotangent of y alone: q, k, log w, v, dy and u read, dq, dk,
    d log w, dv and du written (the forward's saved chunk-start states are
    not counted).  Per head and chunk: A and dA over the kept pairs, A^T dY,
    dA K~ and dA^T Q~, the four (l, dk, dv) products of dV, dQ~, dK~ and
    dh_in, the exponentials, the reverse sum of d log w and the bonus's
    terms."""
    nbytes = 4 * (bh * t * (3 * dk + 2 * dv) + bh * dk
                  + bh * t * (3 * dk + dv) + bh * dk)
    ops = 0.0
    for _, ln, pairs in _chunks(t, chunk):
        ops += 2.0 * pairs * (2 * dk + 2 * dv) + 2.0 * pairs * dk
        ops += 4 * 2.0 * ln * dk * dv
        ops += 3.0 * ln * dk + 4.0 * ln * dk
        ops += 6.0 * ln * dk + 2.0 * ln * dv
    return float(nbytes), bh * ops


# --------------------------------------------------------------------------
# whole-round model FLOPs
# --------------------------------------------------------------------------
def lm_train_flops(non_embedding_params: int, tokens: int) -> float:
    """A forward and a backward over ``tokens`` tokens: 6 operations per
    parameter that multiplies an activation (the embedding's lookup is
    none) and token."""
    return 6.0 * non_embedding_params * tokens
