"""The port's MoE block kinds (``moe``, ``moe_swa``) against the JAX
package's, on the CPU.

``moe_forward`` on its own: the routing, the capacity dropping (a config
where capacity binds, checked to drop), the batched expert GLU, the
combine, Qwen2's shared experts and the Switch aux loss, within 1e-4 (f32
einsums and sums in another order); the groups a slot pool routes alone
against the JAX package applied row by row.  The qwen2-moe and qwen3-moe
smoke LMs (2 layers, d_model 256, f32; weights carried over bit for bit
with ``convert.lm_params_from_jax``): the params tree, forward, prefill
and 8 teacher-forced decode steps within 1e-4; ``moe_swa`` with rings
that wrap.  Greedy serving gives the JAX engines' tokens: the wave
scheduler, and the slot scheduler with more slots than an expert's
capacity.  Last, the reference's fault: its pow2 prefill changes an MoE's
logits, so the port prefills MoE configs at their exact length.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models.transformer import moe as JMOE
from repro.models.transformer.model import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import padded_prefill_safe as jpadded_prefill_safe
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.transformer import moe as MOE
from repro_torch.models.transformer.model import LM
from repro_torch.serving.engine import (Request, ServingEngine,
                                        padded_prefill_safe)
from repro_torch.utils.pytree import flatten_with_paths

TOL = 1e-4
PLEN, MAX_SEQ, STEPS = 80, 96, 8
QWEN2, QWEN3 = "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"


def _cfgs(arch, moe=None, **overrides):
    """(JAX, port) smoke configs of ``arch``; ``moe``: fields of its
    MoEConfig to replace (the smoke config's is 4 experts, top-2)."""
    pair = (jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch))
    out = []
    for c in pair:
        if moe:
            overrides_c = dict(overrides,
                               moe=dataclasses.replace(c.moe, **dict(moe)))
        else:
            overrides_c = overrides
        out.append(dataclasses.replace(c, **overrides_c))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _models(arch, moe=None, **overrides):
    """(JAX LM, JAX params, port LM, port params); ``moe`` a tuple of
    (field, value) pairs."""
    jcfg, cfg = _cfgs(arch, moe, **overrides)
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
    return {k: np.asarray(v) for k, v in flatten_with_paths(tree)}


def _tokens(b, t, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


# qwen2's own routing at smoke width: 60 experts top-4, capacity 8 for 77
# tokens (⌈77·4/60·1.25⌉ = 7), so popular experts drop assignments
QWEN2_ROUTING = (("num_experts", 60), ("top_k", 4), ("expert_d_ff", 64))


def _moe_pair(arch, moe, seed=0):
    """(JAX cfg, port cfg, numpy params) of one MoE layer."""
    jcfg, cfg = _cfgs(arch, moe)
    p = JMOE.init_moe_params(jcfg, np.random.default_rng(seed))
    return jcfg, cfg, p


def _torch_tree(p):
    return lm_params_from_jax(p, device="cpu")


# --------------------------------------------------------------------------
# moe_forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [QWEN2, QWEN3], ids=["shared", "routed"])
def test_moe_forward_and_aux_match_jax_where_capacity_binds(arch):
    """77 tokens, 60 experts top-4: capacity 8 binds (asserted), and the
    output and aux loss agree within 1e-4; qwen2's config adds the shared
    experts and their sigmoid gate."""
    jcfg, cfg, p = _moe_pair(arch, QWEN2_ROUTING)
    x = np.random.default_rng(1).standard_normal((1, 77, 256)).astype(
        np.float32)
    yj, auxj = JMOE.moe_forward(jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(x), jcfg)
    tp = _torch_tree(p)
    y, aux = MOE.moe_forward(tp, _t(x), cfg)
    r = MOE.route(tp, _t(x), cfg)
    assert r.capacity == 8 and not bool(r.keep.all())
    assert ("shared" in tp) == (arch == QWEN2)
    _close(y, yj)
    _close(aux, auxj)


def test_capacity_is_the_reference_formula():
    cfg = _cfgs(QWEN2, QWEN2_ROUTING)[1]
    for t, want in ((1, 8), (4, 8), (77, 8), (96, 8), (97, 16), (768, 64)):
        assert MOE.capacity(t, cfg) == want


def test_groups_route_each_group_alone():
    """``groups=B`` on B one-token rows equals the JAX package's
    ``moe_forward`` applied to each row alone (the slot pool's ``vmap`` of
    batch-1 steps), and differs from one group of B tokens, whose shared
    capacity binds (12 rows, 8 experts top-2)."""
    jcfg, cfg, p = _moe_pair(QWEN3, (("num_experts", 8), ("top_k", 2)))
    # rows alike, so one group would send all 12 to the same two experts
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((1, 1, 256))
         + 0.01 * rng.standard_normal((12, 1, 256))).astype(np.float32)
    tp = _torch_tree(p)
    y, _ = MOE.moe_forward(tp, _t(x), cfg, groups=12)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    for row in range(12):
        yj, _ = JMOE.moe_forward(jp, jnp.asarray(x[row:row + 1]), jcfg)
        _close(y[row:row + 1], yj)
    one, _ = MOE.moe_forward(tp, _t(x), cfg)
    assert not bool(MOE.route(tp, _t(x), cfg).keep.all())
    assert not torch.allclose(one, y, atol=1e-3)


def test_dispatch_writes_each_kept_slot_once():
    """The routing's kept (expert, slot) rows are distinct, so the
    dispatch table is written once per row (no atomics on the card)."""
    cfg = _cfgs(QWEN2, QWEN2_ROUTING)[1]
    tp = _torch_tree(_moe_pair(QWEN2, QWEN2_ROUTING)[2])
    x = _t(np.random.default_rng(3).standard_normal((2, 77, 256)).astype(
        np.float32))
    r = MOE.route(tp, x, cfg)
    kept = r.slot[r.keep]
    assert kept.numel() == kept.unique().numel() > 0
    assert torch.equal(r.counts.sum(-1), torch.tensor([2 * 77 * 4]))


# --------------------------------------------------------------------------
# the smoke LMs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [QWEN2, QWEN3])
def test_params_tree_matches_jax(arch):
    """The port's ``init`` gives the JAX tree: keys, shapes, dtypes."""
    jm, jp, tm, tp = _models(arch)
    mine = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flatten_with_paths(tm.init(0, "cpu"))}
    ref = {k: (tuple(v.shape), str(v.dtype)) for k, v in
           flatten_with_paths(jax.tree_util.tree_map(np.asarray, jp))}
    assert mine == ref
    assert any(k.endswith("moe/shared/gate") for k in mine) == (arch == QWEN2)


@pytest.mark.parametrize("arch", [QWEN2, QWEN3])
def test_forward_matches_jax(arch):
    jm, jp, tm, tp = _models(arch)
    toks = _tokens(2, PLEN, 0)
    lj, auxj = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)})
    lt, aux = tm.forward(tp, {"tokens": _t(toks)})
    _close(lt, lj)
    _close(aux, auxj)
    assert float(aux) > 0


def _prefill_and_decode(arch, moe=None, **overrides):
    """Prefill of 80 tokens (``max_seq`` 96) and 8 teacher-forced decode
    steps in both packages, logits and every state leaf held each time."""
    jm, jp, tm, tp = _models(arch, moe, **overrides)
    toks = _tokens(2, PLEN, 1)
    lj, sj = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=MAX_SEQ))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, st = tm.prefill(tp, {"tokens": _t(toks)}, max_seq=MAX_SEQ)
    dec = jax.jit(lambda p, s, t, pos: jm.decode_step(p, s, t, pos,
                                                      max_seq=MAX_SEQ))
    feed = _tokens(STEPS, 2, 2)
    for step in range(STEPS + 1):
        _close(lt, lj)
        ref, got = _leaves(sj), _leaves(st)
        assert got.keys() == ref.keys()
        for k in ref:
            if k.endswith("pos"):
                assert np.array_equal(got[k], ref[k]), k
            else:
                _close(got[k], ref[k])
        if step == STEPS:
            return st
        lj, sj = dec(jp, sj, jnp.asarray(feed[step], jnp.int32),
                     jnp.int32(PLEN + step))
        lt, st = tm.decode_step(tp, st, _t(feed[step]), PLEN + step,
                                max_seq=MAX_SEQ)


@pytest.mark.parametrize("arch", [QWEN2, QWEN3])
def test_prefill_and_teacher_forced_decode_match_jax(arch):
    _prefill_and_decode(arch)


def test_moe_swa_matches_jax():
    """qwen3's smoke stack as ``moe_swa`` then ``moe`` with a window of
    64: the ring (64 slots) wraps in the 80-token prefill and again in
    decode; the full layer keeps 96."""
    st = _prefill_and_decode(QWEN3, pattern=(("moe_swa", 1), ("moe", 1)))
    pos = st["units"]["0"]["pos"].flatten().tolist()
    end = PLEN + STEPS
    assert sorted(pos) == list(range(end - 64, end))
    assert st["units"]["1"]["pos"].flatten().tolist() == \
        list(range(end)) + [-(10 ** 9)] * (MAX_SEQ - end)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def _serve(engine, queue, request):
    for uid, prompt, new in queue:
        engine.submit(request(uid=uid, prompt=prompt, max_new_tokens=new))
    return {r.uid: r.tokens for r in engine.run()}


def _queue(lengths, seed, new=5):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, n).tolist(), new)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", [QWEN2, QWEN3])
def test_wave_serving_matches_jax_engine(arch):
    """Greedy tokens of the port's wave scheduler equal the JAX engine's
    (waves of 2, the pad row of an odd wave routed with the rest)."""
    jm, jp, tm, tp = _models(arch)
    queue = _queue((40, 40, 17, 40, 17), 5)
    want = _serve(JServingEngine(jm.cfg, params=jp, batch_size=2,
                                 max_seq=64), queue, JRequest)
    got = _serve(ServingEngine(tm.cfg, params=tp, batch_size=2, max_seq=64,
                               device="cpu"), queue, Request)
    assert got == want


def test_slot_pool_larger_than_capacity_matches_jax_slot_engine():
    """12 slots over 8 experts top-4 (capacity 8 a group): each pool row
    routed alone gives the JAX slot engine's tokens (``exact`` buckets on
    both sides), the pool's first steps with all 12 rows busy.  Routed as
    one group of 12 tokens, the pool's steps would drop assignments past
    an expert's 8."""
    moe = (("num_experts", 8), ("top_k", 4))
    jm, jp, tm, tp = _models(QWEN3, moe)
    queue = _queue((9, 12, 7, 15, 9, 11, 8, 13, 10, 9, 14, 12, 7, 9), 6,
                   new=4)
    jeng = JServingEngine(jm.cfg, params=jp, batch_size=12, max_seq=32,
                          scheduler="slot", prefill_bucket="exact")
    slot = ServingEngine(tm.cfg, params=tp, batch_size=12, max_seq=32,
                         scheduler="slot", device="cpu")
    busy, step = [], slot.backend.step

    def counted():
        busy.append(sum(e is not None for e in slot.backend._slots))
        return step()
    slot.backend.step = counted
    assert _serve(slot, queue, Request) == _serve(jeng, queue, JRequest)
    assert slot.stats()["prefill_bucket"] == "exact" and max(busy) == 12


def test_reference_pow2_prefill_changes_moe_logits():
    """The reference's fault: it calls padding exact for MoE, but the
    capacity grows with the padded length.  qwen2's routing (60 experts,
    top-4), a 77-token prompt: the JAX package's prefill padded to 128
    gives other last-token logits than at 77, while ``"auto"`` picks pow2
    there; the port's ``padded_prefill_safe`` is False for MoE, its slot
    backend picks ``exact``, and its prefill equals the JAX exact one."""
    jm, jp, tm, tp = _models(QWEN2, QWEN2_ROUTING)
    toks = _tokens(1, 77, 4)
    pre = jax.jit(lambda p, b, i: jm.prefill(p, b, max_seq=MAX_SEQ * 2,
                                             last_index=i))
    exact, _ = pre(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, 76)
    padded = np.zeros((1, 128), np.int32)
    padded[:, :77] = toks
    pow2, _ = pre(jp, {"tokens": jnp.asarray(padded)}, 76)
    assert float(jnp.abs(pow2 - exact).max()) > 1e-2
    assert jpadded_prefill_safe(jm.cfg, MAX_SEQ * 2)
    assert JServingEngine(jm.cfg, params={}, scheduler="slot",
                          max_seq=MAX_SEQ * 2).backend.prefill_bucket == "pow2"
    assert not padded_prefill_safe(tm.cfg, MAX_SEQ * 2)
    assert ServingEngine(tm.cfg, params={}, scheduler="slot",
                         max_seq=MAX_SEQ * 2, device="cpu"
                         ).stats()["prefill_bucket"] == "exact"
    got, _ = tm.prefill(tp, {"tokens": _t(toks)}, max_seq=MAX_SEQ * 2)
    _close(got, exact)
