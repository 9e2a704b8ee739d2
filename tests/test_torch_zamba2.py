"""The port's zamba2 hybrid — Mamba2 blocks and the shared attention block
with RoPE, the GLU MLP and a KV cache — against the JAX package's, on the
CPU.

Weights are the JAX ``init`` trees carried over bit for bit
(``convert.lm_params_from_jax``); inputs come from numpy seeds.  RoPE, the
MLP and attention agree within 1e-5 (einsums and a softmax in f32 in
another order); the Mamba2 block and the LM within 2e-4 (the scan's f32
sums in another order, the ROADMAP's parity rule); greedy serving gives
the same tokens.  Two configs: the smoke zamba2 (one shared application)
and the same with ``n_units=2`` (one shared set, two applications, two
caches).

The reference's fault (ROADMAP.md Queue 3): its chunked scan factors the
decay as ``exp(−cumsum log_w)``, which overflows f32 once a chunk's summed
|log_w| passes ~88.7, and Mamba2 clamps nothing.  At zamba2's SSM widths
(state 64, head 64, chunk 64) on the width-256 model, seed 0, the JAX
forward is NaN; the port's scalar-decay scan is finite and equals the JAX
package's own token-by-token recurrence.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models.transformer import attention as JA
from repro.models.transformer import blocks as JB
from repro.models.transformer import mamba2 as JM2
from repro.models.transformer import mlp as JFF
from repro.models.transformer import rope as JR
from repro.models.transformer import scan_common as jscan
from repro.models.transformer.model import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import mamba2 as M2
from repro_torch.models.transformer import mlp as FF
from repro_torch.models.transformer import rope as R
from repro_torch.models.transformer import scan_common
from repro_torch.models.transformer.model import LM
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.utils.pytree import flatten_with_paths

ARCH = "zamba2-7b"
OP_TOL = 1e-5
TOL = 2e-4
FAULT_TOL = 1e-4


def _variant(pkg, name):
    """``smoke``: the smoke config (shared_attn, mamba2); ``two_units``:
    the same pattern twice; ``real_ssm``: the smoke width with zamba2's
    own SSM widths (state 64, head 64, chunk 64: 8 heads)."""
    cfg = pkg.get_smoke_config(ARCH)
    if name == "two_units":
        return dataclasses.replace(cfg, n_units=2, num_layers=4)
    if name == "real_ssm":
        return dataclasses.replace(cfg, ssm=pkg.get_config(ARCH).ssm)
    return cfg


@functools.lru_cache(maxsize=None)
def _models(name, seed=0):
    """(JAX LM, JAX params, port LM, port params) of a variant."""
    jm = JLM(_variant(jconfigs, name))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    return jm, jp, LM(_variant(configs, name)), tp


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _leaves(tree):
    """``{path: numpy array}`` of a JAX or a port tree."""
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor)
                          and v.dtype == torch.bfloat16 else v)
            for k, v in flatten_with_paths(tree)}


def _dtypes(tree):
    return {k: str(v.dtype).replace("torch.", "")
            for k, v in flatten_with_paths(tree)}


def _tokens(b, t, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --------------------------------------------------------------------------
# the modules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("head_dim", [64, 112])
def test_rope_matches_jax(head_dim):
    """zamba2's head of 112 rotates halves of 56."""
    pos = np.arange(0, 300, 7)
    cj, sj = JR.rope_angles(jnp.asarray(pos), head_dim, 10_000.0)
    ct, st = R.rope_angles(_t(pos), head_dim, 10_000.0)
    assert tuple(ct.shape) == (len(pos), head_dim // 2)
    _close(ct, cj, OP_TOL)
    _close(st, sj, OP_TOL)
    x = _normal((2, len(pos), 3, head_dim), 1)
    _close(R.apply_rope(_t(x), ct, st), JR.apply_rope(jnp.asarray(x), cj, sj),
           OP_TOL)


def test_glu_mlp_matches_jax():
    cfg = configs.get_smoke_config(ARCH)
    p = JFF.init_mlp_params(jconfigs.get_smoke_config(ARCH),
                            np.random.default_rng(0))
    x = _normal((2, 9, cfg.d_model), 1)
    _close(FF.mlp_forward(lm_params_from_jax(p, "cpu"), _t(x), cfg),
           JFF.mlp_forward(p, jnp.asarray(x),
                           jconfigs.get_smoke_config(ARCH)), OP_TOL)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_attention_matches_jax(kv_heads):
    """Forward, prefill (output and cache) and decode against the full
    cache, with the shared block's 2·d_model input; MHA as zamba2 and GQA
    (two query heads per KV head)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               num_kv_heads=kv_heads)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              num_kv_heads=kv_heads)
    d_in = 2 * cfg.d_model
    jp = JA.init_attn_params(jcfg, np.random.default_rng(3), d_model=d_in)
    tp = lm_params_from_jax(jp, "cpu")
    assert tuple(tp["wq"].shape) == (d_in, cfg.num_heads * 64)
    x = _normal((2, 11, d_in), 4)
    _close(A.attn_forward(tp, _t(x), cfg),
           JA.attn_forward(jp, jnp.asarray(x), jcfg), OP_TOL)
    spec = A.CacheSpec("full", 16)
    out_t, cache_t = A.attn_prefill(tp, _t(x), cfg, spec)
    out_j, cache_j = JA.attn_prefill(jp, jnp.asarray(x), jcfg,
                                     JA.CacheSpec("full", 16))
    _close(out_t, out_j, OP_TOL)
    for name in ("k", "v", "pos"):
        assert cache_t[name].shape == cache_j[name].shape
        _close(cache_t[name], cache_j[name], OP_TOL)
    assert cache_t["pos"].dtype == torch.int32
    for pos in (11, 12, 13):
        step = _normal((2, 1, d_in), 10 + pos)
        old, snap = cache_t, {k: v.clone() for k, v in cache_t.items()}
        out_t, cache_t = A.attn_decode(tp, _t(step), cfg, cache_t, pos, spec)
        out_j, cache_j = JA.attn_decode(jp, jnp.asarray(step), jcfg, cache_j,
                                        jnp.int32(pos),
                                        JA.CacheSpec("full", 16))
        assert all(torch.equal(old[k], snap[k]) for k in snap)  # a copy
        _close(out_t, out_j, OP_TOL)
        for name in ("k", "v", "pos"):
            _close(cache_t[name], cache_j[name], OP_TOL)


def test_unported_attention_options_raise():
    """``qk_norm``, ``logit_softcap``, the int8 KV cache and the ring cache
    are ported (``tests/test_torch_dense.py``); what attention refuses is
    a cache kind it does not have and a prefill longer than a full
    cache."""
    cfg = configs.get_smoke_config(ARCH)
    for field, value in (("qk_norm", True), ("logit_softcap", 30.0),
                         ("kv_cache_dtype", "int8")):
        A.init_attn_params(dataclasses.replace(cfg, **{field: value}),
                           np.random.default_rng(0))
    A.init_cache(cfg, 1, A.CacheSpec("ring", 8), torch.float32, "cpu")
    with pytest.raises(ValueError, match="unknown KV cache kind"):
        A.CacheSpec("paged", 8)
    tp = lm_params_from_jax(JA.init_attn_params(
        jconfigs.get_smoke_config(ARCH), np.random.default_rng(0)), "cpu")
    with pytest.raises(ValueError, match="exceeds the cache's 8 slots"):
        A.attn_prefill(tp, torch.zeros(1, 9, cfg.d_model), cfg,
                       A.CacheSpec("full", 8))


def test_repeated_shared_entry_is_refused():
    """The JAX forward applies a ``("shared_attn", n)`` entry n times per
    unit; the port applies it once, so it refuses n != 1."""
    cfg = configs.get_smoke_config(ARCH)
    cfg = dataclasses.replace(cfg, pattern=(("shared_attn", 2),
                                            ("mamba2", 1)), num_layers=3)
    with pytest.raises(ValueError, match="shared_attn entry of count 2"):
        LM(cfg).init(0, "cpu")


@pytest.mark.parametrize("t", [37, 48, 2])
def test_mamba2_matches_jax(t):
    """``mamba2_forward``, the prefill's state (conv tail, final h) and
    ``mamba2_decode`` steps, at a ragged T, whole chunks and a prompt
    shorter than the conv."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jp = JM2.init_mamba2_params(jcfg, np.random.default_rng(5))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = _normal((2, t, cfg.d_model), 6, scale=0.5)
    _close(M2.mamba2_forward(tp, _t(x), cfg),
           JM2.mamba2_forward(jp, jnp.asarray(x), jcfg))
    out_t, st_t = M2.mamba2_prefill(tp, _t(x), cfg)
    assert tuple(st_t["conv"].shape) == (2, 3, 2 * cfg.d_model + 32)
    if t < 3:      # the JAX state's tail is only T rows: the port's pads
        return     # zeros in front, the conv's own padding
    out_j, st_j = JB._mamba2_prefill(jp, jnp.asarray(x), jcfg)
    _close(out_t, out_j)
    for name in ("conv", "h"):
        assert st_t[name].shape == st_j[name].shape
        _close(st_t[name], st_j[name])
    for step in range(3):
        xs = _normal((2, 1, cfg.d_model), 20 + step, scale=0.5)
        out_t, st_t = M2.mamba2_decode(tp, _t(xs), cfg, st_t)
        out_j, st_j = JM2.mamba2_decode(jp, jnp.asarray(xs), jcfg, st_j)
        _close(out_t, out_j)
        _close(st_t["h"], st_j["h"])
        _close(st_t["conv"], st_j["conv"])


def test_mamba2_short_prompt_state_continues_the_conv():
    """A prompt shorter than the conv: its state, zeros in front, then
    decode steps, equals the longer prefill."""
    cfg = configs.get_smoke_config(ARCH)
    tp = lm_params_from_jax(jax.tree_util.tree_map(
        np.asarray, JM2.init_mamba2_params(jconfigs.get_smoke_config(ARCH),
                                           np.random.default_rng(5))), "cpu")
    x = _t(_normal((1, 5, cfg.d_model), 7, scale=0.5))
    _, st = M2.mamba2_prefill(tp, x[:, :2], cfg)
    for i in range(2, 5):
        out, st = M2.mamba2_decode(tp, x[:, i:i + 1], cfg, st)
    want, st_w = M2.mamba2_prefill(tp, x, cfg)
    _close(out[:, 0], want[:, -1])
    _close(st["h"], st_w["h"])


# --------------------------------------------------------------------------
# the scan's scalar-decay route
# --------------------------------------------------------------------------
def _replay(q, k, v, lw, h0):
    """The JAX package's one-token recurrence, step by step, the decay
    broadcast over dk."""
    bh, t, dk = q.shape
    h = jnp.zeros((bh, dk, v.shape[-1]), jnp.float32) if h0 is None \
        else jnp.asarray(h0)
    ys = []
    for i in range(t):
        y, h = jscan.scan_decode_step(
            jnp.asarray(q[:, i]), jnp.asarray(k[:, i]), jnp.asarray(v[:, i]),
            jnp.broadcast_to(jnp.asarray(lw[:, i])[:, None], (bh, dk)), h)
        ys.append(y)
    return jnp.stack(ys, axis=1), h


@pytest.mark.parametrize("decay", ["mild", "strong"])
@pytest.mark.parametrize("t,chunk,with_h0", [
    (64, 16, False), (77, 64, True), (50, 16, True), (128, 64, False)])
def test_scalar_decay_scan_matches_jax(t, chunk, with_h0, decay):
    """The scalar-decay route against the JAX package's chunked scan on the
    broadcast decay, where that is finite, and against its one-token
    recurrence replayed, always.  ``strong``: −3 per step, so a 64-step
    chunk sums to 192, past the factored form's overflow; a 16-step one to
    48, short of it."""
    bh, dk, dv = 3, 16, 24
    q, k = _normal((bh, t, dk), 1), _normal((bh, t, dk), 2)
    v = _normal((bh, t, dv), 3)
    lw = (np.full((bh, t), -3.0, np.float32) if decay == "strong" else
          (-0.15 * np.random.default_rng(4).random((bh, t))).astype(
              np.float32))
    h0 = _normal((bh, dk, dv), 5) if with_h0 else None
    y, h = scan_common.chunked_scan(_t(q), _t(k), _t(v), _t(lw),
                                    None if h0 is None else _t(h0),
                                    chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_r, h_r = _replay(q, k, v, lw, h0)
    _close(y, y_r)
    _close(h, h_r)
    y_j, h_j = jscan.chunked_scan(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.broadcast_to(jnp.asarray(lw)[..., None], (bh, t, dk)),
        None if h0 is None else jnp.asarray(h0), chunk=chunk)
    finite = bool(np.isfinite(np.asarray(y_j)).all())
    assert finite is (decay == "mild" or 3.0 * chunk < 88.7)
    if finite:
        _close(y, y_j)
        _close(h, h_j)


# --------------------------------------------------------------------------
# the LM
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["smoke", "two_units"])
def test_params_carry_over_bit_for_bit_with_the_shared_set(name):
    jm, jp, tm, tp = _models(name)
    ref, got = _leaves(jp), _leaves(tp)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k],
                                                               ref[k]), k
    assert "shared/attn/wq" in got and not any(
        k.startswith("units/s") for k in got)
    n_units = tm.cfg.resolved_units()
    assert got["units/1/mamba/w_in"].shape[:2] == (n_units, 1)
    assert got["shared/attn/wq"].shape == (2 * tm.cfg.d_model,
                                           tm.cfg.num_heads * 64)


@pytest.mark.parametrize("name", ["smoke", "two_units"])
def test_init_keeps_the_jax_layout_and_is_seeded(name):
    jm, _, tm, _ = _models(name)
    a, b, c = tm.init(3, "cpu"), tm.init(3, "cpu"), tm.init(4, "cpu")
    shapes = {k: v.shape for k, v in flatten_with_paths(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))}
    la, lb, lc = (dict(flatten_with_paths(x)) for x in (a, b, c))
    assert {k: tuple(v.shape) for k, v in la.items()} == shapes
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all(v.dtype == torch.float32 for v in la.values())
    assert not torch.equal(la["shared/attn/wq"], lc["shared/attn/wq"])
    # the stacked layers are distinct draws
    w = la["units/1/mamba/w_in"].flatten(0, 1)
    assert not torch.equal(w[0], w[-1]) or w.shape[0] == 1


@pytest.mark.parametrize("name", ["smoke", "two_units"])
def test_forward_matches_jax(name):
    jm, jp, tm, tp = _models(name)
    toks = _tokens(2, 45, 0)
    lj, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, aux = tm.forward(tp, {"tokens": _t(toks)})
    assert lt.shape == (2, 45, tm.cfg.vocab_size) and float(aux) == 0.0
    _close(lt, lj)


@pytest.mark.parametrize("name", ["smoke", "two_units"])
def test_prefill_states_and_teacher_forced_decode_match_jax(name):
    """Prefill logits and every state leaf (the conv tails, the scan
    states, each shared application's K/V cache and positions) in the JAX
    layout, key for key, shape and dtype; then teacher-forced decode
    steps, logits and states."""
    jm, jp, tm, tp = _models(name)
    toks = _tokens(2, 40, 1)
    lj, sj = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=64))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, st = tm.prefill(tp, {"tokens": _t(toks)}, max_seq=64)
    _close(lt, lj)
    ref, got = _leaves(sj), _leaves(st)
    assert got.keys() == ref.keys()
    assert _dtypes(st) == _dtypes(sj)
    n_units = tm.cfg.resolved_units()
    assert got["units/s0/k"].shape == (n_units, 2, 64, 4, 64)
    assert got["units/s0/pos"].shape == (n_units, 64)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        _close(got[k], ref[k])
    dec_j = jax.jit(lambda p, s, t, pos: jm.decode_step(p, s, t, pos,
                                                        max_seq=64))
    feed = _tokens(4, 2, 2)
    for step in range(4):
        lj, sj = dec_j(jp, sj, jnp.asarray(feed[step], jnp.int32),
                       jnp.int32(40 + step))
        lt, st = tm.decode_step(tp, st, _t(feed[step]), 40 + step,
                                max_seq=64)
        _close(lt, lj)
        ref, got = _leaves(sj), _leaves(st)
        for k in ref:
            _close(got[k], ref[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["smoke", "two_units"])
def test_init_states_match_jax_layout(name, dtype):
    jm, jp, tm, tp = _models(name)
    jm = JLM(dataclasses.replace(jm.cfg, dtype=dtype))
    tm = LM(dataclasses.replace(tm.cfg, dtype=dtype))
    sj, st = jm.init_states(jp, 3, 32), tm.init_states(tp, 3, 32)
    ref, got = _leaves(sj), _leaves(st)
    assert got.keys() == ref.keys()
    assert _dtypes(st) == _dtypes(sj)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k     # zeros; pos −10⁹


def test_prefill_then_decode_equals_the_longer_prefill():
    """The shared caches, the conv tails and the scan states together:
    ``prefill(x[:T])`` then ``decode_step(x[T])`` gives the last logits of
    ``prefill(x[:T+1])``."""
    _, _, tm, tp = _models("two_units")
    toks = _t(_tokens(2, 30, 3))
    _, st = tm.prefill(tp, {"tokens": toks[:, :29]}, max_seq=48)
    got, _ = tm.decode_step(tp, st, toks[:, 29], 29, max_seq=48)
    want, _ = tm.prefill(tp, {"tokens": toks}, max_seq=48)
    _close(got, want)


def _queue(seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, 6 + 5 * (i % 3)).tolist())
            for i in range(7)]


@pytest.mark.parametrize("name", ["smoke", "two_units"])
def test_greedy_serving_matches_jax_engine(name):
    jm, jp, tm, tp = _models(name)
    jeng = JServingEngine(jm.cfg, params=jp, batch_size=3, max_seq=64)
    eng = ServingEngine(tm.cfg, params=tp, batch_size=3, max_seq=64,
                        device="cpu")
    for uid, prompt in _queue(4):
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=6))
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
    want = {r.uid: r.tokens for r in jeng.run()}
    got = {r.uid: r.tokens for r in eng.run()}
    assert got == want
    assert all(len(t) == 6 for t in got.values())
    assert eng.stats()["waves"] >= 3


# --------------------------------------------------------------------------
# the reference's fault
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_real_ssm_dims_finite_where_the_reference_overflows(seed):
    """At zamba2's SSM widths on the width-256 model: for seed 0 the JAX
    forward is NaN (a chunk's summed |log_w| passes ~88.7), for seed 1 it
    is finite.  Either way the port's prefill is finite and within 1e-4 of
    the JAX package's own token-by-token ``decode_step``; where the JAX
    chunked form is finite the port's forward matches it too."""
    jm, jp, tm, tp = _models("real_ssm", seed)
    toks = _tokens(1, 128, seed)
    lj, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    jax_finite = bool(np.isfinite(np.asarray(lj)).all())
    assert jax_finite is (seed != 0)
    lt, _ = tm.prefill(tp, {"tokens": _t(toks)}, max_seq=160)
    assert bool(torch.isfinite(lt).all())
    dec = jax.jit(lambda p, s, t, pos: jm.decode_step(p, s, t, pos,
                                                      max_seq=160))
    sj = jm.init_states(jp, 1, 160)
    for i in range(toks.shape[1]):
        ld, sj = dec(jp, sj, jnp.asarray(toks[:, i], jnp.int32), jnp.int32(i))
    _close(lt, ld, FAULT_TOL)
    if jax_finite:
        lf, _ = tm.forward(tp, {"tokens": _t(toks)})
        _close(lf, lj)
