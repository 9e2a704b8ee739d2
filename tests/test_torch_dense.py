"""The port's dense attention stacks — the ``full`` and ``swa`` kinds with
their append and ring KV caches, ``qk_norm``, ``logit_softcap``, the int8
KV cache and the GELU MLP — and the slot pool's per-slot positions,
against the JAX package's, on the CPU.

Four configs at smoke size (2 layers, d_model 256, window 64, f32):
gemma3-1b (``swa`` then ``full``, MQA, ``qk_norm``), h2o-danube-3-4b
(``swa``), stablelm-12b (``full``) and starcoder2-15b (``full``, GELU).
Weights are the JAX ``init`` trees carried over bit for bit
(``convert.lm_params_from_jax``); prompts of 80 tokens against a window of
64 and ``max_seq`` 96, so every ring wraps in prefill and again in decode.
Logits and states agree within 1e-4 (f32 einsums and softmaxes in another
order), positions exactly; the GELU MLP within 1e-6; int8 cache codes
exactly but where the f32 value lies within 1e-5 of a rounding boundary.
Greedy serving gives the JAX engine's tokens: the wave scheduler, and the
slot scheduler under ``exact`` and ``pow2`` prefill buckets, zamba2's
shared-attention caches and gemma3's long-context variant included.
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
from repro.models.transformer import mlp as JFF
from repro.models.transformer.model import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import mlp as FF
from repro_torch.models.transformer.model import LM, per_row_positions
from repro_torch.serving.engine import (Request, ServingEngine,
                                       padded_prefill_safe)
from repro_torch.utils.pytree import flatten_with_paths, map_with_paths

DENSE = ["gemma3-1b", "h2o-danube-3-4b", "stablelm-12b", "starcoder2-15b"]
TOL = 1e-4
GELU_TOL = 1e-6
# int8 codes: an f32 value this close to a rounding boundary may round
# either way when the two packages' k differ in the last bits
BOUNDARY = 1e-5
PLEN, MAX_SEQ, STEPS = 80, 96, 8


def _cfgs(arch, **overrides):
    """(JAX, port) smoke configs of ``arch`` (``"gemma3-1b-long"``: the
    long-context variant's), with ``overrides``."""
    if arch == "gemma3-1b-long":
        pair = (jconfigs.reduced_variant(
                    jconfigs.get_long_context_config("gemma3-1b")),
                configs.reduced_variant(
                    configs.get_long_context_config("gemma3-1b")))
    else:
        pair = (jconfigs.get_smoke_config(arch),
                configs.get_smoke_config(arch))
    return tuple(dataclasses.replace(c, **overrides) for c in pair)


@functools.lru_cache(maxsize=None)
def _models(arch, **overrides):
    """(JAX LM, JAX params, port LM, port params) of a smoke config."""
    jcfg, cfg = _cfgs(arch, **overrides)
    jm = JLM(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    return jm, jp, LM(cfg), tp


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _leaves(tree):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor)
                          and v.dtype == torch.bfloat16 else v)
            for k, v in flatten_with_paths(tree)}


def _dtypes(tree):
    return {k: str(v.dtype).replace("torch.", "")
            for k, v in flatten_with_paths(tree)}


def _tokens(b, t, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _codes_alike(got_q, want_q, x, scale):
    """int8 codes equal, but where ``x / scale`` (the f32 values and
    scales of the reference) lies within BOUNDARY of a rounding boundary,
    where they may differ by one."""
    got_q, want_q = np.asarray(got_q, np.int32), np.asarray(want_q, np.int32)
    r = np.asarray(x, np.float64) / np.asarray(scale, np.float64)[..., None]
    near = np.abs(np.abs(r - np.floor(r)) - 0.5) < BOUNDARY
    diff = got_q != want_q
    assert not (diff & ~near).any()
    assert (np.abs(got_q - want_q) <= 1).all()


# --------------------------------------------------------------------------
# configs and the modules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_long_context_config_matches_jax(arch):
    got = configs.get_long_context_config(arch)
    want = jconfigs.get_long_context_config(arch)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if arch == "gemma3-1b":
        assert got.name == "gemma3-1b-long" and all(
            k == "swa" for k in got.layer_plan())


def test_gelu_matches_jax_nn_gelu():
    """The GELU is ``jax.nn.gelu``'s default, the tanh approximation;
    torch's default, erf, differs by up to ~1e-3 where the GELU bends."""
    z = np.concatenate([np.linspace(-8, 8, 4097), _normal(4096, 0) * 3]
                       ).astype(np.float32)
    got = torch.nn.functional.gelu(_t(z), approximate="tanh")
    _close(got, jax.nn.gelu(jnp.asarray(z)), GELU_TOL)
    erf = torch.nn.functional.gelu(_t(z))
    assert float((erf - got).abs().max()) > 1e-4


def test_gelu_mlp_matches_jax():
    """starcoder2's non-gated MLP: ``w_up`` then ``w_down``, no gate."""
    jcfg, cfg = _cfgs("starcoder2-15b")
    p = JFF.init_mlp_params(jcfg, np.random.default_rng(0))
    assert list(p) == ["w_up", "w_down"]
    x = _normal((2, 9, cfg.d_model), 1)
    got = FF.mlp_forward(lm_params_from_jax(p, "cpu"), _t(x), cfg)
    _close(got, JFF.mlp_forward(p, jnp.asarray(x), jcfg), GELU_TOL)


def _attn_pair(options):
    overrides = {"qk_norm": "qk_norm" in options,
                 "logit_softcap": 50.0 if "softcap" in options else 0.0,
                 "kv_cache_dtype": "int8" if "int8" in options else None}
    jcfg, cfg = _cfgs("h2o-danube-3-4b", **overrides)
    jp = JA.init_attn_params(jcfg, np.random.default_rng(3))
    return jcfg, cfg, jp, lm_params_from_jax(jp, "cpu")


@pytest.mark.parametrize("options", [(), ("qk_norm", "softcap"), ("int8",)],
                         ids=["plain", "qk_norm-softcap", "int8"])
@pytest.mark.parametrize("window,length", [(16, 16), (None, 16), (24, 32)])
def test_ring_cache_matches_jax(options, window, length):
    """Windowed attention's forward, a 40-token prefill into a ring of
    ``length`` slots (wrapping) and decode steps that wrap it again: the
    output, the k/v cache (int8 codes and scales) and the positions; the
    window shorter than the ring, equal to it, or only the ring's."""
    jcfg, cfg, jp, tp = _attn_pair(options)
    assert sorted(tp) == sorted(jp) and ("q_norm" in tp) == cfg.qk_norm
    x = _normal((2, 40, cfg.d_model), 4)
    _close(A.attn_forward(tp, _t(x), cfg, window=window),
           JA.attn_forward(jp, jnp.asarray(x), jcfg, window=window))
    spec, jspec = A.CacheSpec("ring", length), JA.CacheSpec("ring", length)
    out_t, ct = A.attn_prefill(tp, _t(x), cfg, spec, window=window)
    out_j, cj = JA.attn_prefill(jp, jnp.asarray(x), jcfg, jspec,
                                window=window)
    _close(out_t, out_j)
    for step in range(length + 3):
        pos = 40 + step
        xs = _normal((2, 1, cfg.d_model), 100 + step)
        out_t, ct = A.attn_decode(tp, _t(xs), cfg, ct, pos, spec,
                                  window=window)
        out_j, cj = JA.attn_decode(jp, jnp.asarray(xs), jcfg, cj,
                                   jnp.int32(pos), jspec, window=window)
        _close(out_t, out_j)
        assert ct.keys() == cj.keys()
        assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
        if "int8" in options:
            _, k, v = JA._project_qkv(jp, jnp.asarray(xs), jcfg,
                                      jnp.int32(pos)[None])
            slot = pos % length
            for name, f32 in (("k", k), ("v", v)):
                _close(ct[f"{name}_scale"], cj[f"{name}_scale"], 1e-6)
                _codes_alike(ct[name][:, slot], cj[name][:, slot],
                             np.asarray(f32)[:, 0],
                             np.asarray(cj[f"{name}_scale"])[:, slot])
        else:
            _close(ct["k"], cj["k"])
            _close(ct["v"], cj["v"])
    assert sorted(ct["pos"].tolist()) == list(range(40 + length + 3 - length,
                                                    40 + length + 3))


def test_cache_quantize_rounds_half_to_even():
    """The int8 cache's rounding: ``jnp.round``'s half to even, the scale
    ``max|x| / 127`` floored at 1e-8 (a zero row stays zero)."""
    x = np.zeros((1, 3, 127), np.float32)
    x[0, 0] = np.arange(127) - 63.5          # ±63.5 → scale 0.5
    x[0, 1, :3] = [127.0, 0.5, 1.5]          # scale 1: halves to even
    q, s = A._quantize(_t(x))
    qj, sj = JA._quantize(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    assert q[0, 1, :3].tolist() == [127, 0, 2] and float(s[0, 2]) == np.float32(1e-8)


# --------------------------------------------------------------------------
# the LM
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_params_carry_over_bit_for_bit(arch):
    jm, jp, tm, tp = _models(arch)
    ref, got = _leaves(jp), _leaves(tp)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(
            got[k], ref[k]), k
    # the port's own init: the JAX layout, seeded
    shapes = {k: v.shape for k, v in flatten_with_paths(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))}
    a, b = (dict(flatten_with_paths(tm.init(3, "cpu"))) for _ in range(2))
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    assert all(torch.equal(a[k], b[k]) for k in a)
    mlp = {k.rsplit("/", 1)[-1] for k in a if "/mlp/" in k}
    assert mlp == ({"w_up", "w_down"} if tm.cfg.act == "gelu"
                   else {"w_gate", "w_up", "w_down"})
    assert any(k.endswith("attn/q_norm") for k in a) == tm.cfg.qk_norm


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jm, jp, tm, tp = _models(arch)
    toks = _tokens(2, PLEN, 0)
    lj, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, aux = tm.forward(tp, {"tokens": _t(toks)})
    assert float(aux) == 0.0
    _close(lt, lj)


def _prefill_and_decode(arch, steps=STEPS, **overrides):
    """Prefill of 80 tokens (``max_seq`` 96) and ``steps`` teacher-forced
    decode steps in both packages, every state leaf held each time; the
    last (port, JAX) states."""
    jm, jp, tm, tp = _models(arch, **overrides)
    toks = _tokens(2, PLEN, 1)
    lj, sj = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=MAX_SEQ))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, st = tm.prefill(tp, {"tokens": _t(toks)}, max_seq=MAX_SEQ)
    _close(lt, lj)
    assert _dtypes(st) == _dtypes(sj)
    dec = jax.jit(lambda p, s, t, pos: jm.decode_step(p, s, t, pos,
                                                      max_seq=MAX_SEQ))
    feed = _tokens(steps, 2, 2)
    for step in range(steps + 1):
        ref, got = _leaves(sj), _leaves(st)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            if k.endswith("pos") or got[k].dtype == np.int8:
                continue
            _close(got[k], ref[k])
        for k in ref:
            if k.endswith("pos"):
                assert np.array_equal(got[k], ref[k]), k
        if step == steps:
            return st, sj
        lj, sj = dec(jp, sj, jnp.asarray(feed[step], jnp.int32),
                     jnp.int32(PLEN + step))
        lt, st = tm.decode_step(tp, st, _t(feed[step]), PLEN + step,
                                max_seq=MAX_SEQ)
        _close(lt, lj)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_teacher_forced_decode_match_jax(arch):
    """Logits and every state leaf, key for key, shape and dtype, the
    positions exactly; the windowed layers' rings (64 slots) wrap in
    prefill and again in decode, the full layers' caches hold 96."""
    st, _ = _prefill_and_decode(arch)
    cfg = _models(arch)[2].cfg
    end = PLEN + STEPS
    for i, (kind, _) in enumerate(cfg.pattern):
        pos = st["units"][str(i)]["pos"].flatten().tolist()
        if kind == "swa":
            assert len(pos) == 64 and sorted(pos) == list(range(end - 64,
                                                                 end))
        else:
            assert pos == list(range(end)) + [-(10 ** 9)] * (MAX_SEQ - end)


def test_int8_cache_and_softcap_match_jax():
    """gemma3's smoke config with ``kv_cache_dtype="int8"`` and
    ``logit_softcap=50``: logits within 1e-4 through the prefill and 8
    decode steps; each int8 cache's dequantized values within one
    quantization step of the JAX package's, its scales within 1e-4."""
    st, sj = _prefill_and_decode("gemma3-1b", kv_cache_dtype="int8",
                                 logit_softcap=50.0)
    got, ref = dict(flatten_with_paths(st)), _leaves(sj)
    codes = [k for k in ref if ref[k].dtype == np.int8]
    assert sorted(codes) == ["units/0/k", "units/0/v", "units/1/k",
                             "units/1/v"]
    for k in codes:
        assert got[k].dtype == torch.int8
        scale = ref[k + "_scale"][..., None]
        step = np.abs(got[k].numpy().astype(np.float32)
                      * got[k + "_scale"].numpy()[..., None]
                      - ref[k].astype(np.float32) * scale)
        assert (step <= scale * (1 + 1e-5) + 1e-7).all(), k
        assert (got[k].numpy() == ref[k]).mean() > 0.999, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_init_states_match_jax_layout(arch, dtype):
    jm, jp, tm, tp = _models(arch)
    jm = JLM(dataclasses.replace(jm.cfg, dtype=dtype))
    tm = LM(dataclasses.replace(tm.cfg, dtype=dtype))
    sj, st = jm.init_states(jp, 3, 32), tm.init_states(tp, 3, 32)
    ref, got = _leaves(sj), _leaves(st)
    assert got.keys() == ref.keys()
    assert _dtypes(st) == _dtypes(sj)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k     # zeros; pos −10⁹


def test_per_row_positions_decode_each_row_at_its_own():
    """Two prompts of 70 and 80 tokens prefilled alone, their states
    joined in the per-row layout and decoded together at positions (70,
    80): each row equals its own batch-1 decode (the rings of 64 slots
    wrap at different slots)."""
    _, _, tm, tp = _models("gemma3-1b")
    toks = _t(_tokens(2, PLEN + 1, 3))
    lens = (70, 80)
    alone, states = [], []
    for row, n in enumerate(lens):
        _, s = tm.prefill(tp, {"tokens": toks[row:row + 1, :n]},
                          max_seq=MAX_SEQ)
        alone.append(tm.decode_step(tp, s, toks[row:row + 1, n], n,
                                    max_seq=MAX_SEQ))
        states.append(per_row_positions(s, 1))
    joined = map_with_paths(lambda k, a: torch.cat(
        [a, dict(flatten_with_paths(states[1]))[k]],
        dim=0 if k == "emb0_last" else 2), states[0])
    got, new = tm.decode_step(tp, joined, toks[[0, 1], list(lens)],
                              torch.tensor(lens), max_seq=MAX_SEQ)
    flat = dict(flatten_with_paths(new))
    for row in range(2):
        _close(got[row:row + 1], alone[row][0], 1e-5)
        for k, want in flatten_with_paths(alone[row][1]):
            if k == "emb0_last":
                have = flat[k][row:row + 1]
            elif k.endswith("pos"):                  # (1, 1, L) alone
                have = flat[k][:, :, row]
            else:                                    # batch axis 2
                have, want = flat[k][:, :, row], want[:, :, 0]
            if k.endswith("pos"):
                assert torch.equal(have, want), k
            else:
                _close(have, want, 1e-5)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def _queue(lengths, seed, new=5):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, n).tolist(), new)
            for i, n in enumerate(lengths)]


def _serve(engine, queue, request):
    for uid, prompt, new in queue:
        engine.submit(request(uid=uid, prompt=prompt, max_new_tokens=new))
    return {r.uid: r.tokens for r in engine.run()}


@pytest.mark.parametrize("arch,bucket,max_seq,lengths", [
    ("gemma3-1b", "exact", MAX_SEQ, (80, 70, 80, 9)),
    ("h2o-danube-3-4b", "exact", MAX_SEQ, (80, 70, 80, 9)),
    ("stablelm-12b", "pow2", MAX_SEQ, (80, 20, 37, 9)),
    ("starcoder2-15b", "pow2", MAX_SEQ, (80, 20, 37, 9)),
    ("gemma3-1b", "pow2", 64, (50, 20, 37, 9)),
    ("gemma3-1b-long", "exact", MAX_SEQ, (80, 70, 80, 9)),
])
def test_wave_and_slot_serving_match_jax(arch, bucket, max_seq, lengths):
    """Greedy tokens of the port's wave and slot schedulers equal the JAX
    engine's, request for request.  ``auto`` resolves to the bucket
    named: ``exact`` where a ring shorter than ``max_seq`` would wrap
    pad tokens in, ``pow2`` elsewhere (gemma3 at ``max_seq`` 64, its
    window); a pow2 prompt of 80 pads to ``max_seq`` 96.  The slot pool
    (2 slots) decodes its requests at their own positions."""
    jm, jp, tm, tp = _models(arch)
    queue = _queue(lengths, 7)
    want = _serve(JServingEngine(jm.cfg, params=jp, batch_size=2,
                                 max_seq=max_seq), queue, JRequest)
    wave = _serve(ServingEngine(tm.cfg, params=tp, batch_size=2,
                                max_seq=max_seq, device="cpu"),
                  queue, Request)
    slot = ServingEngine(tm.cfg, params=tp, batch_size=2, max_seq=max_seq,
                         scheduler="slot", device="cpu")
    got = _serve(slot, queue, Request)
    assert wave == want and got == want
    s = slot.stats()
    assert s["prefill_bucket"] == bucket
    pads = {n: n if bucket == "exact" else
            min(max(8, 1 << (n - 1).bit_length()), max_seq) for n in lengths}
    assert s["prefill_lens_compiled"] == sorted(set(pads.values()))
    assert s["step_retraces"] == 1


def test_pow2_prefill_matches_jax_slot_engine():
    """The padded prefill against the JAX package's own slot path, which
    pads the same way (stablelm, buckets of 16, 32 and 96)."""
    jm, jp, tm, tp = _models("stablelm-12b")
    queue = _queue((11, 20, 80, 17), 8, new=4)
    jeng = JServingEngine(jm.cfg, params=jp, batch_size=2, max_seq=MAX_SEQ,
                          scheduler="slot", prefill_bucket="pow2")
    slot = ServingEngine(tm.cfg, params=tp, batch_size=2, max_seq=MAX_SEQ,
                         scheduler="slot", device="cpu")
    assert _serve(slot, queue, Request) == _serve(jeng, queue, JRequest)
    assert slot.stats()["prefill_lens_compiled"] == \
        jeng.stats()["prefill_lens_compiled"] == [16, 32, 96]


def test_zamba2_slot_serving_matches_jax_slot():
    """zamba2's shared-attention caches in the slot pool: per-slot
    positions, exact buckets (the Mamba2 scan folds pads in)."""
    jcfg, cfg = jconfigs.get_smoke_config("zamba2-7b"), \
        configs.get_smoke_config("zamba2-7b")
    jp = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    queue = _queue((12, 7, 12, 7, 12), 9)
    want = _serve(JServingEngine(jcfg, params=jp, batch_size=2, max_seq=48,
                                 scheduler="slot"), queue, JRequest)
    slot = ServingEngine(cfg, params=tp, batch_size=2, max_seq=48,
                         scheduler="slot", device="cpu")
    assert _serve(slot, queue, Request) == want
    assert slot.stats()["prefill_bucket"] == "exact"


@pytest.mark.parametrize("arch,max_seq,bucket", [
    ("gemma3-1b", MAX_SEQ, "exact"), ("zamba2-7b", 64, "exact"),
    ("rwkv6-1.6b", 64, "exact"), ("gemma3-1b", 64, "pow2"),
    ("stablelm-12b", MAX_SEQ, "pow2"), ("qwen2-moe-a2.7b", MAX_SEQ, "exact")])
def test_pow2_refused_where_padding_is_inexact(arch, max_seq, bucket):
    """The slot backend pads prompts only where ``padded_prefill_safe``
    says padding is exact: never for recurrent kinds, a ring shorter than
    ``max_seq`` or an MoE; the JAX package's ``"auto"`` picks the same,
    but pow2 for an MoE (its fault, ROADMAP.md Queue 3, shown by
    ``test_reference_pow2_prefill_changes_moe_logits`` in
    ``test_torch_moe.py``)."""
    cfg = configs.get_smoke_config(arch)
    eng = ServingEngine(cfg, params={}, scheduler="slot", max_seq=max_seq,
                        device="cpu")
    assert eng.stats()["prefill_bucket"] == bucket
    assert (bucket == "pow2") == padded_prefill_safe(cfg, max_seq)
    jeng = JServingEngine(jconfigs.get_smoke_config(arch), params={},
                          scheduler="slot", max_seq=max_seq)
    if cfg.moe is not None:
        assert jeng.backend.prefill_bucket == "pow2"
        return
    assert jeng.backend.prefill_bucket == bucket
    if bucket == "exact":
        with pytest.raises(ValueError, match="inexact"):
            JServingEngine(jconfigs.get_smoke_config(arch), params={},
                           scheduler="slot", max_seq=max_seq,
                           prefill_bucket="pow2")
