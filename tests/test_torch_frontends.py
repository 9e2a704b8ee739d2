"""The port's vision and audio frontends against the JAX package's, on the
CPU.

internvl2-2b's smoke config (2 ``full`` layers, d_model 256, a prefix of 8
patch tokens of 64 values): the GELU projector's rows before the token
embeddings, ``forward`` dropping the prefix's logits, ``prefill`` and
decode at positions counting the prefix, within 1e-4; greedy wave and slot
serving (pow2 buckets) give the JAX engines' tokens.  hubert-xlarge's
smoke config (2 bidirectional ``full`` layers, the GELU MLP, 64-value
frames): ``forward`` within 1e-4 in f32 and within bf16's 2e-2 × max(1,
max|ref|) with ``dtype="bfloat16"`` (the audio stream has no √d scale, so
it computes in bfloat16), the ``mask_positions`` blend, and a later frame
moving an earlier output.  Weights are the JAX ``init`` trees carried over
bit for bit (``convert.lm_params_from_jax``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models.transformer.model import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.transformer.model import LM
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.utils.pytree import flatten_with_paths

TOL = 1e-4
BF16_TOL = 2e-2
VLM, AUDIO = "internvl2-2b", "hubert-xlarge"
PLEN, MAX_SEQ, STEPS = 40, 64, 8


@functools.lru_cache(maxsize=None)
def _models(arch, **overrides):
    """(JAX LM, JAX params, port LM, port params) of a smoke config."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **overrides)
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


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _vlm_batch(b, t, seed):
    """(JAX batch, port batch): random tokens and random patches."""
    cfg = configs.get_smoke_config(VLM)
    toks = np.random.default_rng(seed).integers(0, 512, (b, t))
    patches = _normal((b, cfg.num_prefix_tokens, cfg.frontend_dim), seed + 1)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "patches": jnp.asarray(patches)},
            {"tokens": _t(toks), "patches": _t(patches)})


def _audio_batch(b, t, seed, masked=True):
    cfg = configs.get_smoke_config(AUDIO)
    frames = _normal((b, t, cfg.frontend_dim), seed)
    mask = np.random.default_rng(seed + 1).random((b, t)) < 0.3
    jb, tb = {"frames": jnp.asarray(frames)}, {"frames": _t(frames)}
    if masked:
        jb["mask_positions"], tb["mask_positions"] = jnp.asarray(mask), \
            _t(mask)
    return jb, tb


# --------------------------------------------------------------------------
# vision
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_params_tree_matches_jax(arch):
    """``init`` draws the frontend's params beside the JAX package's:
    ``proj1`` / ``proj2`` (vision), ``proj`` / ``mask_emb`` (audio)."""
    jm, jp, tm, tp = _models(arch)
    mine = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flatten_with_paths(tm.init(0, "cpu"))}
    ref = {k: (tuple(v.shape), str(v.dtype)) for k, v in
           flatten_with_paths(jax.tree_util.tree_map(np.asarray, jp))}
    assert mine == ref
    assert sorted(k for k in mine if k.startswith("frontend")) == (
        ["frontend/proj1", "frontend/proj2"] if arch == VLM else
        ["frontend/mask_emb", "frontend/proj"])


def test_vision_forward_matches_jax_and_drops_the_prefix():
    jm, jp, tm, tp = _models(VLM)
    jb, tb = _vlm_batch(2, PLEN, 0)
    lj, _ = jax.jit(jm.forward)(jp, jb)
    lt, aux = tm.forward(tp, tb)
    assert lt.shape == (2, PLEN, tm.cfg.vocab_size) and float(aux) == 0.0
    _close(lt, lj)
    # the patches reach the token rows through attention
    tb2 = dict(tb, patches=tb["patches"] + 1.0)
    assert not torch.allclose(tm.forward(tp, tb2)[0], lt, atol=1e-3)


def test_vision_prefill_and_decode_match_jax():
    """Prefill (the cache holds prefix + prompt) and 8 teacher-forced
    decode steps at positions ``prefix + plen + step``."""
    jm, jp, tm, tp = _models(VLM)
    prefix = tm.cfg.num_prefix_tokens
    jb, tb = _vlm_batch(2, PLEN, 1)
    lj, sj = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=MAX_SEQ))(jp, jb)
    lt, st = tm.prefill(tp, tb, max_seq=MAX_SEQ)
    assert st["units"]["0"]["pos"].flatten().tolist()[:prefix + PLEN + 1] \
        == list(range(prefix + PLEN)) + [-(10 ** 9)]
    dec = jax.jit(lambda p, s, t, pos: jm.decode_step(p, s, t, pos,
                                                      max_seq=MAX_SEQ))
    feed = np.random.default_rng(2).integers(0, 512, (STEPS, 2))
    for step in range(STEPS + 1):
        _close(lt, lj)
        ref = dict(flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                             sj)))
        got = dict(flatten_with_paths(st))
        assert got.keys() == ref.keys()
        for k in ref:
            if k.endswith("pos"):
                np.testing.assert_array_equal(got[k], ref[k])
            else:
                _close(got[k], ref[k])
        if step == STEPS:
            break
        pos = prefix + PLEN + step
        lj, sj = dec(jp, sj, jnp.asarray(feed[step], jnp.int32),
                     jnp.int32(pos))
        lt, st = tm.decode_step(tp, st, _t(feed[step]), pos, max_seq=MAX_SEQ)


def _queue(lengths, seed, new=5):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, n).tolist(), new)
            for i, n in enumerate(lengths)]


def _serve(engine, queue, request):
    for uid, prompt, new in queue:
        engine.submit(request(uid=uid, prompt=prompt, max_new_tokens=new))
    return {r.uid: r.tokens for r in engine.run()}


def test_vision_wave_and_slot_serving_match_jax():
    """Greedy tokens of the port's wave and slot schedulers (zero patches,
    decode from ``prefix + plen``) equal the JAX engines'; the slot
    scheduler pads to pow2 buckets (9 → 16, 20 and 30 → 32) as the JAX
    slot engine's ``"auto"``."""
    jm, jp, tm, tp = _models(VLM)
    queue = _queue((20, 9, 30, 20, 9), 3)
    want = _serve(JServingEngine(jm.cfg, params=jp, batch_size=2,
                                 max_seq=MAX_SEQ), queue, JRequest)
    jslot = _serve(JServingEngine(jm.cfg, params=jp, batch_size=2,
                                  max_seq=MAX_SEQ, scheduler="slot"),
                   queue, JRequest)
    wave = _serve(ServingEngine(tm.cfg, params=tp, batch_size=2,
                                max_seq=MAX_SEQ, device="cpu"),
                  queue, Request)
    slot = ServingEngine(tm.cfg, params=tp, batch_size=2, max_seq=MAX_SEQ,
                         scheduler="slot", device="cpu")
    got = _serve(slot, queue, Request)
    assert wave == want == jslot == got
    s = slot.stats()
    assert s["prefill_bucket"] == "pow2"
    assert s["prefill_lens_compiled"] == [16, 32]


def test_validate_counts_the_prefix():
    """A request whose prefix + prompt + new tokens overflow ``max_seq``
    is refused at submit by both schedulers; the JAX package counts only
    prompt + new tokens and takes it."""
    jm, jp, tm, tp = _models(VLM)
    prefix = tm.cfg.num_prefix_tokens
    over = dict(uid=0, prompt=[1] * (MAX_SEQ - 5 - prefix + 1),
                max_new_tokens=5)
    for scheduler in ("wave", "slot"):
        eng = ServingEngine(tm.cfg, params=tp, max_seq=MAX_SEQ,
                            scheduler=scheduler, device="cpu")
        with pytest.raises(ValueError, match="prefix"):
            eng.submit(Request(**over))
        eng.submit(Request(**dict(over, prompt=over["prompt"][1:])))
    JServingEngine(jm.cfg, params=jp, max_seq=MAX_SEQ).submit(
        JRequest(**over))


# --------------------------------------------------------------------------
# audio
# --------------------------------------------------------------------------
def test_audio_forward_matches_jax_in_float32():
    jm, jp, tm, tp = _models(AUDIO)
    jb, tb = _audio_batch(2, 50, 0)
    lj, _ = jax.jit(jm.forward)(jp, jb)
    lt, aux = tm.forward(tp, tb)
    assert lt.dtype == torch.float32 and float(aux) == 0.0
    _close(lt, lj)


def test_audio_forward_matches_jax_in_bfloat16():
    """``dtype="bfloat16"`` (``reduced_variant`` forces f32): no √d
    scale promotes the stream, so projection, attention, norms and MLP run
    in bf16 with the JAX package's casts; within 2e-2 × max(1,
    max|ref|)."""
    jm, jp, tm, tp = _models(AUDIO, dtype="bfloat16")
    jb, tb = _audio_batch(2, 50, 1)
    lj, _ = jax.jit(jm.forward)(jp, jb)
    lt, _ = tm.forward(tp, tb)
    assert lt.dtype == torch.bfloat16 and lj.dtype == jnp.bfloat16
    ref = np.asarray(lj.astype(jnp.float32))
    err = np.abs(lt.float().numpy() - ref).max()
    assert err <= BF16_TOL * max(1.0, np.abs(ref).max())


def test_mask_positions_blend_in_the_mask_embedding():
    """Masked frames are replaced by ``mask_emb`` before the projection's
    output reaches the layers: the embedding rows equal
    ``frames @ proj`` where unmasked and ``mask_emb`` where masked."""
    _, _, tm, tp = _models(AUDIO)
    _, tb = _audio_batch(2, 30, 2)
    h = tm._embed(tp, tb)
    m = tb["mask_positions"]
    proj = tb["frames"] @ tp["frontend"]["proj"]
    assert m.any() and (~m).any()
    _close(h[~m], proj[~m], 1e-6)
    _close(h[m], tp["frontend"]["mask_emb"].expand(int(m.sum()), -1), 1e-6)


def test_audio_encoder_is_bidirectional():
    """Changing the last frame moves the first frame's logits (a causal
    stack would leave them)."""
    _, _, tm, tp = _models(AUDIO)
    _, tb = _audio_batch(1, 30, 3, masked=False)
    first = tm.forward(tp, tb)[0]
    frames = tb["frames"].clone()
    frames[:, -1] += 1.0
    moved = tm.forward(tp, {"frames": frames})[0]
    assert not torch.allclose(moved[:, 0], first[:, 0], atol=1e-4)
