"""The port's RWKV6 language model and its serving path against the JAX
package's, on the smoke config (2 layers, d_model 256, f32).

Weights are the JAX ``LM.init`` tree carried over bit for bit
(``convert.lm_params_from_jax``); logits and decode states agree within
2e-4 (the scan's f32 sums in another order, over 2 layers), greedy serving
gives the same tokens.  The port's own serving checks follow
``tests/test_serving.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models.transformer.model import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import padded_prefill_safe as jpadded_prefill_safe
from repro.serving import wave_rng as jwave_rng
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.transformer.model import LM
from repro_torch.serving.core import wave_rng
from repro_torch.serving.engine import (Request, ServingEngine,
                                        padded_prefill_safe)

TOL = 2e-4
ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def cfg():
    return configs.get_smoke_config(ARCH)


@pytest.fixture(scope="module")
def jax_params(cfg):
    return jax.jit(JLM(jconfigs.get_smoke_config(ARCH)).init)(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                              device="cpu")


@pytest.fixture(scope="module")
def engine(cfg, params):
    return ServingEngine(cfg, params=params, batch_size=3, max_seq=64,
                         device="cpu")


def _leaves_t(tree, prefix=""):
    """``{"/units/0/h": leaf, ...}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves_t(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _leaves(tree):
    return {k: np.asarray(v) for k, v in _leaves_t(tree).items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_jax_field_for_field(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for port, ref in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.get_smoke_config(arch),
                       jconfigs.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.layer_plan() == ref.layer_plan()
        assert port.subquadratic() == ref.subquadratic()


@pytest.mark.parametrize("max_seq", [64, 8192])
def test_padded_prefill_safe_matches_jax(max_seq):
    """The same answer for every config but the MoE ones, which the JAX
    package calls exact to pad and the port does not (its capacity grows
    with the padded length: ROADMAP.md Queue 3)."""
    for arch in jconfigs.ARCH_IDS:
        cfg = configs.get_config(arch)
        want = jpadded_prefill_safe(jconfigs.get_config(arch), max_seq)
        if cfg.moe is not None:
            assert want and not padded_prefill_safe(cfg, max_seq), arch
        else:
            assert padded_prefill_safe(cfg, max_seq) == want, arch


def test_wave_rng_draws_as_jax_package():
    for uids in ([3, 1, 4], [7]):
        assert np.array_equal(wave_rng(5, uids).random(8),
                              jwave_rng(5, uids).random(8))
    assert not np.array_equal(wave_rng(5, [1]).random(4),
                              wave_rng(5, [2]).random(4))


def test_params_carry_over_bit_for_bit(jax_params, params):
    ref = _leaves(jax_params)
    got = {k: v.numpy() for k, v in _leaves_t(params).items()}
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k],
                                                               ref[k]), k
    assert got["/units/0/w_r"].shape == (1, 1, 256, 256)   # (n_units, count)


def test_init_is_the_same_on_every_device_and_seeded(cfg):
    a, b = LM(cfg).init(3, "cpu"), LM(cfg).init(3, "cpu")
    c = LM(cfg).init(4, "cpu")
    la, lb, lc = _leaves_t(a), _leaves_t(b), _leaves_t(c)
    assert la.keys() == _leaves(jax.eval_shape(
        JLM(jconfigs.get_smoke_config(ARCH)).init,
        jax.random.PRNGKey(0))).keys()
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(la["/units/0/w_r"], lc["/units/0/w_r"])
    assert all(v.dtype == torch.float32 for v in la.values())


def _tokens(b, t, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def test_forward_matches_jax(cfg, jax_params, params):
    toks = _tokens(2, 77, 0)
    lj, _ = jax.jit(JLM(jconfigs.get_smoke_config(ARCH)).forward)(
        jax_params, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, aux = LM(cfg).forward(params, {"tokens": torch.from_numpy(toks)})
    assert lt.shape == (2, 77, cfg.vocab_size) and float(aux) == 0.0
    _close(lt, lj)


@pytest.mark.parametrize("last_index", [None, 40])
def test_prefill_and_teacher_forced_decode_match_jax(cfg, jax_params, params,
                                                     last_index):
    jm, tm = JLM(jconfigs.get_smoke_config(ARCH)), LM(cfg)
    toks = _tokens(2, 70, 1)
    lj, sj = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=128,
                                             last_index=last_index))(
        jax_params, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, st = tm.prefill(params, {"tokens": torch.from_numpy(toks)},
                        max_seq=128, last_index=last_index)
    _close(lt, lj)
    ref, got = _leaves(sj), _leaves_t(st)
    assert got.keys() == ref.keys()
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        _close(got[k], ref[k])
    if last_index is not None:
        return
    dec_j = jax.jit(lambda p, s, t, pos: jm.decode_step(p, s, t, pos,
                                                        max_seq=128))
    feed = _tokens(4, 2, 2)                  # teacher-forced: same tokens
    for step in range(4):
        lj, sj = dec_j(jax_params, sj, jnp.asarray(feed[step], jnp.int32),
                       jnp.int32(70 + step))
        lt, st = tm.decode_step(params, st, torch.from_numpy(feed[step]),
                                70 + step, max_seq=128)
        _close(lt, lj)
        ref, got = _leaves(sj), _leaves_t(st)
        for k in ref:
            _close(got[k], ref[k])


def test_init_states_match_jax_layout(cfg, jax_params, params):
    sj = JLM(jconfigs.get_smoke_config(ARCH)).init_states(jax_params, 3, 64)
    st = LM(cfg).init_states(params, 3, 64)
    ref, got = _leaves(sj), _leaves_t(st)
    assert got.keys() == ref.keys()
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        assert not got[k].any()


def test_bfloat16_stream_keeps_cfg_dtype(cfg, jax_params, params):
    """Quirk of the reference (ROADMAP Queue 3): its embedding scale is a
    numpy float64, which promotes a bfloat16 stream to float32, so the JAX
    LM rounds the embedding rows to ``cfg.dtype`` and computes every layer
    in f32.  The port follows it: a bfloat16 config keeps ``cfg.dtype`` in
    the rounded embeddings and the zero decode states, and its prefill and
    decode agree with the JAX LM's as closely as in f32."""
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    jbf = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                              dtype="bfloat16")
    toks = _tokens(1, 20, 4)
    lj, sj = JLM(jbf).prefill(jax_params, {"tokens": jnp.asarray(toks)},
                              max_seq=64)
    lt, st = LM(bf).prefill(params, {"tokens": torch.from_numpy(toks)},
                            max_seq=64)
    assert lj.dtype == jnp.float32 and lt.dtype == torch.float32
    assert st["units"]["0"]["x_att"].dtype == torch.float32
    assert LM(bf).init_states(params, 1, 64)["units"]["0"]["x_att"].dtype \
        == torch.bfloat16
    _close(lt, lj)
    # the rounding is there: the bf16 config's logits differ from f32's
    lf, _ = LM(cfg).prefill(params, {"tokens": torch.from_numpy(toks)},
                            max_seq=64)
    assert not torch.equal(lf, lt)
    tok = torch.from_numpy(toks[:, -1])
    dj, _ = JLM(jbf).decode_step(jax_params, sj, jnp.asarray(toks[:, -1]),
                                 20, max_seq=64)
    dt, _ = LM(bf).decode_step(params, st, tok, 20, max_seq=64)
    _close(dt, dj)


def test_unported_kinds_and_schedulers_raise(cfg, params):
    """What the port still refuses: serving an encoder-only config (either
    scheduler), and a block kind no config has."""
    for scheduler in ("wave", "slot"):
        with pytest.raises(ValueError, match="encoder-only"):
            ServingEngine(dataclasses.replace(cfg, encoder_only=True),
                          params=params, scheduler=scheduler, device="cpu")
        with pytest.raises(ValueError, match="encoder-only"):
            ServingEngine(configs.get_smoke_config("hubert-xlarge"),
                          params={}, scheduler=scheduler, device="cpu")
    with pytest.raises(ValueError, match="unknown block kind"):
        LM(dataclasses.replace(cfg, pattern=(("conv", 2),))).init(0, "cpu")


def _queue(seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, 8 + 5 * (i % 3)).tolist())
            for i in range(7)]


def test_greedy_serving_matches_jax_engine(cfg, jax_params, engine):
    jeng = JServingEngine(jconfigs.get_smoke_config(ARCH), params=jax_params,
                          batch_size=3, max_seq=64)
    for uid, prompt in _queue(0):
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=6))
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
    want = {r.uid: r.tokens for r in jeng.run()}
    got = {r.uid: r for r in engine.run()}
    assert {u: r.tokens for u, r in got.items()} == want
    assert all(len(r.tokens) == 6 for r in got.values())
    s = engine.stats()
    assert s["waves"] >= 3 and s["queued"] == 0 and s["served"] >= 7


def test_wave_batching_matches_single(engine):
    """A request served alone == the same request served in a full wave."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    engine.submit(Request(uid=200, prompt=prompt, max_new_tokens=4))
    solo = engine.run()[0]
    for i in range(3):
        engine.submit(Request(uid=300 + i, prompt=prompt if i == 0 else
                              [2, 7, 1, 8, 2, 8, 1, 8], max_new_tokens=4))
    batched = {r.uid: r for r in engine.run()}
    assert batched[300].tokens == solo.tokens


def test_eos_as_first_token_not_emitted(engine):
    prompt = list(range(10, 18))
    engine.submit(Request(uid=600, prompt=prompt, max_new_tokens=4))
    ref = engine.run()[0]
    engine.submit(Request(uid=601, prompt=prompt, max_new_tokens=4,
                          eos_id=ref.tokens[0]))
    out = engine.run()[0]
    assert out.tokens == []
    assert out.latency_s > 0


def test_per_request_latency(engine):
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    engine.submit(Request(uid=700, prompt=prompt, max_new_tokens=2))
    engine.submit(Request(uid=701, prompt=prompt, max_new_tokens=6))
    by_uid = {r.uid: r for r in engine.run()}
    assert by_uid[700].wave == by_uid[701].wave
    assert 0 < by_uid[700].latency_s <= by_uid[701].latency_s


def test_temperature_continuation_ignores_wave_mates(engine):
    prompt = [9, 8, 7, 6, 5, 4, 3, 2]
    engine.submit(Request(uid=800, prompt=prompt, max_new_tokens=5,
                          temperature=0.8))
    solo = engine.run()[0]
    engine.submit(Request(uid=801, prompt=prompt, max_new_tokens=5,
                          temperature=1.1))
    engine.submit(Request(uid=800, prompt=prompt, max_new_tokens=5,
                          temperature=0.8))
    engine.submit(Request(uid=802, prompt=prompt, max_new_tokens=5))
    shared = {r.uid: r for r in engine.run()}
    assert shared[800].tokens == solo.tokens
    engine.submit(Request(uid=803, prompt=prompt, max_new_tokens=5,
                          temperature=0.8))
    assert engine.run()[0].tokens != solo.tokens       # another uid, draws


def test_temperature_to_zero_is_greedy(engine):
    prompt = [5, 5, 1, 2, 7, 3, 3, 0]
    engine.submit(Request(uid=900, prompt=prompt, max_new_tokens=6))
    engine.submit(Request(uid=901, prompt=prompt, max_new_tokens=6,
                          temperature=1e-6))
    by_uid = {r.uid: r for r in engine.run()}
    assert by_uid[901].tokens == by_uid[900].tokens


def test_rejects_oversized_request(engine):
    with pytest.raises(ValueError):
        engine.submit(Request(uid=500, prompt=[0] * 63, max_new_tokens=10))


# --------------------------------------------------------------------------
# the slot (continuous-batching) path
# --------------------------------------------------------------------------
def _slot_engine(cfg, params, slots=2):
    return ServingEngine(cfg, params=params, batch_size=slots, max_seq=64,
                         scheduler="slot", device="cpu")


def test_slot_serving_matches_jax_slot_and_port_wave(cfg, jax_params,
                                                     params, engine):
    """Greedy tokens of the port's ``LMSlotBackend`` equal the JAX
    package's ``LMSlotBackend``'s and the port's own wave path's, request
    for request (prompts of three lengths: three prefill buckets)."""
    jeng = JServingEngine(jconfigs.get_smoke_config(ARCH), params=jax_params,
                          batch_size=2, max_seq=64, scheduler="slot")
    slot = _slot_engine(cfg, params)
    for uid, prompt in _queue(1):
        n = 3 + uid % 3
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=n))
        slot.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    want = {r.uid: r.tokens for r in jeng.run()}
    got = {r.uid: r.tokens for r in slot.run()}
    wave = {r.uid: r.tokens for r in engine.run()}
    assert got == want == wave
    s = slot.stats()
    assert s["prefill_retraces"] == len(s["prefill_lens_compiled"]) == 3
    assert s["step_retraces"] == 1 and s["served"] == 7
    assert s["prefill_bucket"] == "exact"


def test_slot_reuse_and_admission_order_never_leak(cfg, params):
    """A request's tokens depend only on itself: served alone on a fresh
    pool, or after other requests used its slot, in any admission order,
    greedy or with temperature."""
    reqs = [Request(uid=u, prompt=p, max_new_tokens=4,
                    temperature=0.7 if u % 2 else 0.0)
            for u, p in _queue(2)[:5]]
    solo = {}
    for r in reqs:
        eng = _slot_engine(cfg, params, slots=1)
        eng.submit(r)
        solo[r.uid] = eng.run()[0].tokens
    for order, slots in (([0, 1, 2, 3, 4], 2), ([4, 2, 0, 3, 1], 3)):
        eng = _slot_engine(cfg, params, slots=slots)
        for i in order:
            eng.submit(dataclasses.replace(reqs[i]))
        assert {r.uid: r.tokens for r in eng.run()} == solo


def test_slot_admit_time_finishes(cfg, params):
    eng = _slot_engine(cfg, params)
    prompt = list(range(10, 18))
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=3))
    first = eng.run()[0].tokens[0]
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=3,
                       eos_id=first))
    eng.submit(Request(uid=2, prompt=prompt, max_new_tokens=1))
    eng.submit(Request(uid=3, prompt=prompt, max_new_tokens=0))
    out = {r.uid: r.tokens for r in eng.run()}
    assert out == {1: [], 2: [first], 3: []}
    assert eng.scheduler.active == 0


def test_slot_refusals(cfg, params):
    with pytest.raises(ValueError, match="empty prompt"):
        _slot_engine(cfg, params).submit(Request(uid=0, prompt=[]))
    with pytest.raises(ValueError, match="num_slots"):
        ServingEngine(cfg, params=params, scheduler="slot", batch_size=0,
                      device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        ServingEngine(cfg, params=params, scheduler="rr", device="cpu")
