"""LM training in the port against the JAX package's, on the CPU.

* The scan op's gradients (``ops.linear_scan`` through its autograd
  Function, whose CPU backward is the plain version) against ``jax.vjp`` of
  the JAX package's ``chunked_scan``: strict with ``u``, plain with ``h0``,
  a ragged T, and the scalar-decay mode against the JAX form with the decay
  broadcast over dk (its d log_w summed over dk), at a decay where that
  form is finite.  Tolerance 2e-4 × max(1, max|reference|).
* ``LM.loss`` and its gradient against ``jax.value_and_grad(lm.loss)`` for
  the ten smoke configs, ``efficient_ce`` on and off: the loss within 1e-5
  (relative), every leaf's gradient within 2e-4 of that leaf's max; hubert
  with ``mask_positions`` in bfloat16 at 2e-2.  Weights carried over with
  ``convert.lm_params_from_jax``.  Where the JAX gradient has a non-finite
  entry (the reference's scan overflows at zamba2's SSM widths, ROADMAP.md
  Queue 3 item 3) only its finite entries are compared, and the port's must
  all be finite.
* RWKV6's chunk of 8 finite where the JAX package's chunk of 64
  overflows.
* ``LM.forward`` takes each stack's layers with one ``unbind``: on
  models whose stacks hold several layers (rwkv6, gemma3's units and
  remainder, zamba2 with its shared block), ``LM.loss``'s gradients equal
  those through per-layer ``x[idx]`` views (``tests/lm_indexed.py``) bit
  for bit, with and without per-block recomputation, and the backward runs
  no ``select_backward`` and one ``stack`` per stacked leaf (the plain
  scan gradient, the CPU's stand-in for the card's kernel, is autograd of
  its own and not counted).

The LLCG round step and the trainer: ``tests/test_torch_llcg_steps.py``.
"""
import collections
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models.transformer import scan_common as jscan
from repro.models.transformer.model import LM as JLM
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.distributed import steps
from repro_torch.kernels import ops
from repro_torch.models.transformer.model import LM
from repro_torch.utils.pytree import (flatten_with_paths, tree_leaves,
                                      tree_unflatten)

SCAN_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
BF16_TOL = 2e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jleaves(tree) -> dict:
    """``{"units/0/w_k": array}`` of a JAX tree, keyed as the port's paths."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree) -> dict:
    return {k: x.detach().float().numpy() for k, x in flatten_with_paths(tree)}


def _close_leaves(got: dict, want: dict, tol: float, what: str):
    assert set(got) == set(want), what
    for k in want:
        w, g = want[k].astype(np.float64), got[k].astype(np.float64)
        assert g.shape == w.shape, (what, k)
        assert np.isfinite(g).all(), (what, k)
        fin = np.isfinite(w)
        scale = max(np.abs(w[fin]).max(initial=0.0), 1e-30)
        err = np.abs(g[fin] - w[fin]).max(initial=0.0)
        assert err <= tol * scale, f"{what} {k}: {err:.3e} > {tol} × {scale:.3e}"


# --------------------------------------------------------------------------
# The scan's gradient
# --------------------------------------------------------------------------
SCAN_CASES = {
    # name: (bh, t, dk, dv, chunk, strict, with_h0, with_u, scalar)
    "strict u": (4, 128, 16, 16, 64, True, False, True, False),
    "strict u ragged": (3, 77, 16, 12, 32, True, True, True, False),
    "plain h0": (3, 96, 16, 8, 32, False, True, False, False),
    "plain h0 ragged": (2, 50, 8, 8, 16, False, True, False, False),
    "scalar": (4, 128, 16, 16, 64, False, False, False, True),
    "scalar h0 ragged": (3, 77, 16, 8, 32, False, True, False, True),
}


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scan_gradients_match_jax_vjp(name):
    bh, t, dk, dv, chunk, strict, with_h0, with_u, scalar = SCAN_CASES[name]
    rng = np.random.default_rng(list(SCAN_CASES).index(name))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f32(bh, t, dk), f32(bh, t, dk), f32(bh, t, dv)
    lw = -(rng.random((bh, t) if scalar else (bh, t, dk)) * 0.5
           ).astype(np.float32)
    h0 = f32(bh, dk, dv) if with_h0 else None
    u = f32(bh, dk) if with_u else None
    dy, dh = f32(bh, t, dv), f32(bh, dk, dv)

    names = ["q", "k", "v", "log_w"] + (["h0"] if with_h0 else []) + \
        (["u"] if with_u else [])
    vals = dict(q=q, k=k, v=v, log_w=lw, h0=h0, u=u)

    def jfn(*xs):
        a = dict(zip(names, xs))
        jlw = a["log_w"]
        if scalar:                        # the JAX form: broadcast over dk
            jlw = jnp.broadcast_to(jlw[..., None], (bh, t, dk))
        return jscan.chunked_scan(a["q"], a["k"], a["v"], jlw, h0=a.get("h0"),
                                  chunk=chunk, strict=strict, u=a.get("u"))

    _, vjp = jax.vjp(jfn, *(jnp.asarray(vals[n]) for n in names))
    want = dict(zip(names, (np.asarray(g) for g in
                            vjp((jnp.asarray(dy), jnp.asarray(dh))))))

    tin = {n: torch.from_numpy(vals[n]).requires_grad_(True) for n in names}
    y, h_t = ops.linear_scan(tin["q"], tin["k"], tin["v"], tin["log_w"],
                             tin.get("h0"), chunk=chunk, strict=strict,
                             u=tin.get("u"))
    got = torch.autograd.grad((y, h_t), [tin[n] for n in names],
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    for n, g in zip(names, got):
        w = want[n]
        assert np.isfinite(w).all(), (name, n)
        assert g.shape == tin[n].shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= SCAN_TOL * max(1.0, float(np.abs(w).max())), (n, err)


def test_scan_goes_through_the_function_only_when_recording():
    q = torch.randn(2, 10, 4, requires_grad=True)
    k, v, lw = torch.randn(2, 10, 4), torch.randn(2, 10, 4), \
        -torch.rand(2, 10, 4)
    y, _ = ops.linear_scan(q, k, v, lw, chunk=8, strict=True)
    assert type(y.grad_fn).__name__ == "_LinearScanBackward"
    with torch.no_grad():
        y, _ = ops.linear_scan(q, k, v, lw, chunk=8, strict=True)
    assert y.grad_fn is None
    y, _ = ops.linear_scan(q.detach(), k, v, lw, chunk=8, strict=True)
    assert y.grad_fn is None


# --------------------------------------------------------------------------
# LM.loss and its gradient
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _loss_setup(arch: str, **overrides):
    """Both packages' models, the JAX weights, a batch, and the JAX
    package's ``value_and_grad`` of its loss, jitted (``efficient_ce``
    static); shared by the tests of one arch."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **overrides)
    jlm, lm = JLM(jcfg), LM(cfg)
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    b, s = 2, 24
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
        batch["mask_positions"] = rng.random((b, s)) < 0.3
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)
                                       ).astype(np.int32)
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    jvg = jax.jit(jax.value_and_grad(jlm.loss), static_argnums=2)
    return jlm, lm, jp, batch, jvg


@pytest.mark.parametrize("efficient_ce", [True, False])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_grad_match_jax(arch, efficient_ce):
    bf16 = arch == "hubert-xlarge"
    jlm, lm, jp, batch, jvg = _loss_setup(
        arch, **({"dtype": "bfloat16"} if bf16 else {}))
    if bf16:
        assert "mask_positions" in batch and lm.cfg.encoder_only
    jloss, jgrads = jvg(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        efficient_ce)
    params = lm_params_from_jax(_np(jp), device="cpu")
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, grads = steps.value_and_grad(
        lambda p, b: lm.loss(p, b, efficient_ce=efficient_ce), params, tbatch)
    tol = BF16_TOL if bf16 else LOSS_RTOL
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
    _close_leaves(_tleaves(grads), _jleaves(jgrads),
                  BF16_TOL if bf16 else GRAD_TOL, arch)


def test_loss_without_mask_positions_averages_every_frame():
    jlm, lm, jp, batch, _ = _loss_setup("hubert-xlarge")
    batch = {k: v for k, v in batch.items() if k != "mask_positions"}
    jloss = jlm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = lm.loss(lm_params_from_jax(_np(jp), device="cpu"),
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def test_rwkv6_scan_stays_finite_where_the_jax_form_overflows():
    """At −2 a step (a 64-step chunk sums to −128, past f32's ~88.7) the
    JAX package's chunk-64 form overflows; the port's RWKV6 chunk of 8
    (``rwkv6._CHUNK``) stays finite and equals the one-token recurrence
    replayed, gradients included; the decay's clamp bounds a step at e²,
    so 8 steps never overflow."""
    from repro_torch.models.transformer import rwkv6
    from repro_torch.models.transformer.scan_common import scan_decode_step
    assert rwkv6._CHUNK * np.exp(2.0) < 88.7
    rng = np.random.default_rng(3)
    bh, t, d = 2, 128, 16
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, u = f32(bh, t, d), f32(bh, t, d), f32(bh, t, d), f32(bh, d)
    lw = np.full((bh, t, d), -2.0, np.float32)
    y_j, _ = jscan.chunked_scan(*(jnp.asarray(x) for x in (q, k, v, lw)),
                                chunk=64, strict=True, u=jnp.asarray(u))
    assert not np.isfinite(np.asarray(y_j)).all()
    tq, tk, tv, tu = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v, u))
    y, h_t = ops.linear_scan(tq, tk, tv, torch.from_numpy(lw),
                             chunk=rwkv6._CHUNK, strict=True, u=tu)
    h = torch.zeros(bh, d, d)
    ys = []
    for i in range(t):
        y_i, h = scan_decode_step(tq[:, i], tk[:, i], tv[:, i],
                                  torch.from_numpy(lw[:, i]), h, strict=True,
                                  u=tu)
        ys.append(y_i)
    want = torch.stack(ys, dim=1)
    tol = SCAN_TOL * max(1.0, float(want.detach().abs().max()))
    torch.testing.assert_close(y, want, rtol=0, atol=tol)
    torch.testing.assert_close(h_t, h, rtol=0, atol=tol)
    grads = torch.autograd.grad(y.square().sum(), (tq, tk, tv, tu))
    want_g = torch.autograd.grad(want.square().sum(), (tq, tk, tv, tu))
    for g, w in zip(grads, want_g):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(
            g, w, rtol=0, atol=SCAN_TOL * max(1.0, float(w.abs().max())))


# --------------------------------------------------------------------------
# Each stack's layers taken by one unbind
# --------------------------------------------------------------------------
DEEP = {
    # arch: overrides giving stacks of several layers
    "rwkv6-1.6b": dict(pattern=(("rwkv6", 1),), remainder=(), n_units=3,
                       num_layers=3),
    "gemma3-1b": dict(pattern=(("swa", 2), ("full", 1)),
                      remainder=(("swa", 2),), n_units=2, num_layers=8),
    "zamba2-7b": dict(pattern=(("shared_attn", 1), ("mamba2", 2)),
                      remainder=(("mamba2", 1),), n_units=2, num_layers=7),
}


def _deep_setting(arch, seq=21, seed=5):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **DEEP[arch])
    lm = LM(cfg)
    params = lm.init(seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, seq), generator=gen)
             for k in ("tokens", "labels")}
    return lm, params, batch


def _loss_and_leaves(lm, params, batch, remat):
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    return lm.loss(tree_unflatten(params, leaves), batch, remat=remat), leaves


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", sorted(DEEP))
def test_unbound_layers_give_the_indexed_gradients(arch, remat):
    from lm_indexed import IndexedLM
    lm, params, batch = _deep_setting(arch)
    assert any(math.prod(d) > 1 for _, _, _, d in lm._entries())
    loss, leaves = _loss_and_leaves(lm, params, batch, remat)
    grads = torch.autograd.grad(loss, leaves)
    loss_i, leaves_i = _loss_and_leaves(IndexedLM(lm.cfg), params, batch,
                                        remat)
    grads_i = torch.autograd.grad(loss_i, leaves_i)
    assert torch.equal(loss, loss_i)
    paths = [k for k, _ in flatten_with_paths(params)]
    for k, g, w in zip(paths, grads, grads_i):
        assert torch.equal(g, w), k


@pytest.mark.parametrize("remat", [False, True])
def test_backward_writes_each_stack_once(remat):
    lm, params, batch = _deep_setting("rwkv6-1.6b")
    stacked = len(tree_leaves(params["units"])) + len(
        tree_leaves(params["rem"]))
    loss, leaves = _loss_and_leaves(lm, params, batch, remat)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(loss, leaves)

    def in_scan_grad(e):
        while e is not None:
            if e.name == "_LinearScanBackward":
                return True
            e = e.cpu_parent
        return False

    ops_run = collections.Counter(e.name for e in prof.events()
                                  if not in_scan_grad(e))
    assert ops_run["aten::select_backward"] == 0
    assert 0 < ops_run["aten::stack"] <= stacked
