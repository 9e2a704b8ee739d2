"""The port's chunked gated linear scan against the JAX package's.

On the CPU the port's ``ops.linear_scan`` runs the plain chunked form
(``kernels.ref.chunked_scan_ref``); the JAX op reaches the Pallas kernel
``linear_scan_chunked`` in interpret mode.  Inputs come from numpy seeds;
``log_w = −0.15·U(0,1)`` as in ``tests/test_kernels.py``.  Tolerance 2e-4:
the scan's f32 sums in another order (the ROADMAP's parity rule).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.transformer import norms as jnorms
from repro.models.transformer import scan_common as jscan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.linear_scan import linear_scan_chunked
from repro_torch.models.transformer import norms
from repro_torch.models.transformer import scan_common

TOL = 2e-4


def _inputs(bh, t, dk, dv, seed, decay=0.15, h0=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, t, dk)).astype(np.float32)
    k = rng.standard_normal((bh, t, dk)).astype(np.float32)
    v = rng.standard_normal((bh, t, dv)).astype(np.float32)
    lw = (-decay * rng.random((bh, t, dk))).astype(np.float32)
    u = (rng.standard_normal((bh, dk)) * 0.3).astype(np.float32)
    h = rng.standard_normal((bh, dk, dv)).astype(np.float32) if h0 else None
    return q, k, v, lw, h, u


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (2, 64, 8, 16, 16), (3, 128, 16, 24, 32), (1, 96, 32, 32, 32),
    (4, 256, 64, 64, 64),
])
def test_linear_scan_matches_jax_pallas_kernel(bh, t, dk, dv, chunk, strict,
                                               with_h0):
    q, k, v, lw, h0, u = _inputs(bh, t, dk, dv, bh + t, h0=with_h0)
    u = u if strict else None
    y_j, h_j = jops.linear_scan(_j(q), _j(k), _j(v), _j(lw), _j(h0),
                                chunk=chunk, strict=strict, u=_j(u))
    y_t, h_t = ops.linear_scan(_t(q), _t(k), _t(v), _t(lw), _t(h0),
                               chunk=chunk, strict=strict, u=_t(u))
    assert y_t.dtype == h_t.dtype == torch.float32
    _close(y_t, y_j)
    _close(h_t, h_j)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
@pytest.mark.parametrize("t,chunk", [(77, 64), (50, 16), (5, 8)])
def test_ragged_plain_scan_matches_sequential_oracle(t, chunk, with_h0):
    """A T that is not a multiple of the chunk is padded, and y cut back:
    against the JAX package's sequential oracle."""
    q, k, v, lw, h0, _ = _inputs(3, t, 16, 24, t, h0=with_h0)
    y_j, h_j = jref.linear_scan_batched_ref(_j(q), _j(k), _j(v), _j(lw),
                                            _j(h0))
    y_t, h_t = ops.linear_scan(_t(q), _t(k), _t(v), _t(lw), _t(h0),
                               chunk=chunk)
    assert y_t.shape == (3, t, 24)
    _close(y_t, y_j)
    _close(h_t, h_j)
    y_s, h_s = ref.linear_scan_batched_ref(_t(q), _t(k), _t(v), _t(lw),
                                           _t(h0))
    _close(y_s, y_j)
    _close(h_s, h_j)
    y_1, h_1 = ref.linear_scan_ref(_t(q[1]), _t(k[1]), _t(v[1]), _t(lw[1]),
                                   None if h0 is None else _t(h0[1]))
    _close(y_1, y_j[1])
    _close(h_1, h_j[1])


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
@pytest.mark.parametrize("t,chunk", [(77, 64), (192, 64), (50, 16)])
def test_ragged_strict_scan_matches_jax_chunked_scan(t, chunk, with_h0):
    q, k, v, lw, h0, u = _inputs(4, t, 64, 64, 100 + t, h0=with_h0)
    y_j, h_j = jscan.chunked_scan(_j(q), _j(k), _j(v), _j(lw), _j(h0),
                                  chunk=chunk, strict=True, u=_j(u))
    y_t, h_t = scan_common.chunked_scan(_t(q), _t(k), _t(v), _t(lw), _t(h0),
                                        chunk=chunk, strict=True, u=_t(u))
    _close(y_t, y_j)
    _close(h_t, h_j)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("t,chunk", [(77, 64), (50, 16)])
def test_ragged_kernel_wrapper_matches_jax_op(t, chunk, strict):
    """The kernel wrapper's ragged mode (the kernel masks the last chunk;
    on the CPU the wrapper pads for the plain version) against the JAX
    op, which leaves its Pallas kernel for the oracle at a ragged T; and
    without ``ragged`` the wrapper still takes whole chunks only."""
    q, k, v, lw, h0, u = _inputs(3, t, 32, 48, 7 + t, h0=True)
    u = u if strict else None
    y_j, h_j = jops.linear_scan(_j(q), _j(k), _j(v), _j(lw), _j(h0),
                                chunk=chunk, strict=strict, u=_j(u))
    y_t, h_t = linear_scan_chunked(_t(q), _t(k), _t(v), _t(lw), _t(h0),
                                   u=_t(u), chunk=chunk, strict=strict,
                                   ragged=True)
    assert y_t.shape == (3, t, 48)
    _close(y_t, y_j)
    _close(h_t, h_j)
    with pytest.raises(ValueError, match="chunk"):
        linear_scan_chunked(_t(q), _t(k), _t(v), _t(lw), chunk=chunk)


def test_decode_step_continues_the_scan():
    """Prefill T−1 steps with the chunked scan, then one decode step: the
    same y_T and h_T as the whole scan, in both conventions."""
    q, k, v, lw, h0, u = _inputs(2, 33, 64, 64, 5, h0=True)
    for strict in (False, True):
        uu = _t(u) if strict else None
        y, h = ops.linear_scan(_t(q), _t(k), _t(v), _t(lw), _t(h0),
                               chunk=16, strict=strict, u=uu)
        _, h_p = ops.linear_scan(_t(q[:, :-1]), _t(k[:, :-1]), _t(v[:, :-1]),
                                 _t(lw[:, :-1]), _t(h0), chunk=16,
                                 strict=strict, u=uu)
        y_d, h_d = scan_common.scan_decode_step(
            _t(q[:, -1]), _t(k[:, -1]), _t(v[:, -1]), _t(lw[:, -1]), h_p,
            strict=strict, u=uu)
        _close(y_d, y[:, -1])
        _close(h_d, h)
        y_j, h_j = jscan.scan_decode_step(
            _j(q[:, -1]), _j(k[:, -1]), _j(v[:, -1]), _j(lw[:, -1]),
            jnp.asarray(h_p.numpy()), strict=strict, u=_j(u) if strict
            else None)
        _close(y_d, y_j)
        _close(h_d, h_j)


def test_wrapper_checks_operands():
    q, k, v, lw, _, _ = _inputs(2, 64, 8, 8, 0)
    with pytest.raises(ValueError, match="chunk"):
        linear_scan_chunked(_t(q), _t(k), _t(v), _t(lw), chunk=48)
    with pytest.raises(ValueError, match="chunk"):
        linear_scan_chunked(_t(q), _t(k), _t(v), _t(lw), chunk=128)
    with pytest.raises(ValueError, match="h0"):
        linear_scan_chunked(_t(q), _t(k), _t(v), _t(lw),
                            h0=torch.zeros(2, 8, 9))
    with pytest.raises(ValueError, match="BH, T, dk"):
        linear_scan_chunked(_t(q), _t(k[:, :32]), _t(v), _t(lw))
    before = linear_scan_chunked.launches
    linear_scan_chunked(_t(q), _t(k), _t(v), _t(lw), chunk=32)
    assert linear_scan_chunked.launches == before      # CPU: no launch


def test_ragged_t_is_padded_in_one_place():
    """``ops.linear_scan`` pads a ragged T; the plain chunked form takes
    whole chunks only, as the kernel does."""
    q, k, v, lw, _, _ = _inputs(2, 50, 8, 8, 0)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.chunked_scan_ref(_t(q), _t(k), _t(v), _t(lw), chunk=16)
    y, h = ops.linear_scan(_t(q), _t(k), _t(v), _t(lw), chunk=16)
    assert tuple(y.shape) == (2, 50, 8) and tuple(h.shape) == (2, 8, 8)


@pytest.mark.parametrize("decay,finite", [(1.0, True), (1.5, False)])
def test_factored_form_overflow_follows_reference(decay, finite):
    """Quirk of the reference (ROADMAP Queue 3): the factored chunk form
    computes P⁻¹ = exp(−cumsum log_w), which overflows f32 once a chunk's
    summed |log_w| passes ~88.7.  At −1.0 per step over a 64-step chunk both
    packages are finite and agree; at −1.5 both overflow alike."""
    q, k, v, _, _, u = _inputs(2, 128, 64, 64, 3)
    lw = np.full(q.shape, -decay, np.float32)
    y_j, h_j = jscan.chunked_scan(_j(q), _j(k), _j(v), _j(lw), chunk=64,
                                  strict=True, u=_j(u))
    y_t, h_t = scan_common.chunked_scan(_t(q), _t(k), _t(v), _t(lw),
                                        chunk=64, strict=True, u=_t(u))
    assert bool(np.isfinite(np.asarray(y_j)).all()) is finite
    assert bool(torch.isfinite(y_t).all()) is finite
    if finite:
        _close(y_t, y_j)
        _close(h_t, h_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 256)) * 2).astype(np.float32)
    scale = (rng.standard_normal(256) * 0.1).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x).astype(dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for got, want in (
            (norms.rms_norm(xt, torch.from_numpy(scale)),
             jnorms.rms_norm(xj, jnp.asarray(scale))),
            (norms.group_norm(xt, torch.from_numpy(scale), 4),
             jnorms.group_norm(xj, jnp.asarray(scale), 4)),
            (norms.layer_norm(xt, torch.from_numpy(scale),
                              torch.from_numpy(scale)),
             jnorms.layer_norm(xj, jnp.asarray(scale), jnp.asarray(scale)))):
        assert got.dtype == tdt
        _close(got.float(), np.asarray(want, np.float32), tol)
