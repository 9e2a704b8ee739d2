"""The port's LLCG round step and LM trainer against the JAX package's, on
the CPU.

* ``build_llcg_round_step`` against the JAX package's on
  ``tests/test_distributed_steps.py``'s setting (G=3, K=2, S=2) at 2e-5 and
  on the rwkv6 smoke config at 2e-4, elementwise (relative and absolute,
  as that file holds the JAX step to its sequential reference; on rwkv6
  but for the few elements where Adam's first step takes the sign of a
  gradient within the packages' agreement of zero, ``SIGN_FLIP_SHARE``,
  ``GRAD_FLOOR``); the broadcast copies
  equal; bf16 averaging within 2e-2 of f32; ``remat`` equal to no remat;
  the sync step against the JAX package's.
* ``train(…, device="cpu")`` and its CLI, the example for one round.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.distributed import steps as jsteps
from repro.models.transformer.config import ModelConfig as JModelConfig
from repro.models.transformer.model import LM as JLM
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.checkpoint.store import restore_checkpoint
from repro_torch.convert import lm_params_from_jax
from repro_torch.distributed import steps
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.model import LM
from repro_torch.optim import adamw
from repro_torch.utils.pytree import flatten_with_paths, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
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
        scale = max(np.abs(w).max(initial=0.0), 1e-30)
        err = np.abs(g - w).max(initial=0.0)
        assert err <= tol * scale, f"{what} {k}: {err:.3e} > {tol} × {scale:.3e}"


_SETUP_CFG = dict(name="t", family="dense", num_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=43,
                  pattern=(("full", 1),), dtype="float32")


def _setup(G=3, K=2, S=2, arch=None):
    """``tests/test_distributed_steps.py``'s setting (or a smoke config),
    in both packages, the same weights and batches."""
    if arch is None:
        jcfg, cfg = JModelConfig(**_SETUP_CFG), ModelConfig(**_SETUP_CFG)
        seq, b_local, b_corr = 8, 2, 4
    else:
        jcfg, cfg = jconfigs.get_smoke_config(arch), \
            configs.get_smoke_config(arch)
        seq, b_local, b_corr = 16, 2, 2
    jlm, lm = JLM(jcfg), LM(cfg)
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    v = cfg.vocab_size
    rng = np.random.default_rng(0)
    local = {"tokens": rng.integers(0, v, (G, K, b_local, seq)),
             "labels": rng.integers(0, v, (G, K, b_local, seq))}
    corr = {"tokens": rng.integers(0, v, (S, b_corr, seq)),
            "labels": rng.integers(0, v, (S, b_corr, seq))}
    local = {k: x.astype(np.int32) for k, x in local.items()}
    corr = {k: x.astype(np.int32) for k, x in corr.items()}
    return jlm, lm, jp, local, corr


def _jax_round(jlm, jp, local, corr, G, K, S, lr=1e-3, slr=5e-4,
               avg_bf16=False):
    step = jsteps.build_llcg_round_step(
        jlm, jadamw(lr), jadamw(slr),
        jsteps.LLCGStepConfig(num_groups=G, local_steps=K,
                              correction_steps=S, avg_bf16=avg_bf16))
    params_G = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (G,) + x.shape), jp)
    opt_G = jax.vmap(jadamw(lr).init)(params_G)
    out_G, _, _, metrics = jax.jit(step)(
        params_G, opt_G, jadamw(slr).init(jp),
        {k: jnp.asarray(v) for k, v in local.items()},
        {k: jnp.asarray(v) for k, v in corr.items()})
    return out_G, metrics


def _port_round(lm, jp, local, corr, G, K, S, lr=1e-3, slr=5e-4, **kw):
    step = steps.build_llcg_round_step(
        lm, adamw(lr), adamw(slr),
        steps.LLCGStepConfig(num_groups=G, local_steps=K,
                             correction_steps=S, **kw))
    params = lm_params_from_jax(_np(jp), device="cpu")
    params_G = tree_map(lambda x: x.unsqueeze(0).expand(G, *x.shape).clone(),
                        params)
    out_G, opt_G, server, metrics = step(
        params_G, adamw(lr).init(params_G), adamw(slr).init(params),
        {k: torch.from_numpy(v) for k, v in local.items()},
        {k: torch.from_numpy(v) for k, v in corr.items()})
    assert opt_G.step == K and server.step == S
    return out_G, metrics


#: Adam's first step moves an element by ±lr whatever the size of its
#: gradient (m̂/√v̂ is its sign), so where a first step's gradient lies
#: within the two packages' agreement on gradients (GRAD_FLOOR of its leaf's
#: max, the rule ``tests/test_torch_lm_train.py`` holds them to) of zero,
#: its sign and so the element's move are not determined: the packages may
#: move it 2·lr apart (2·lr/G in the average, for one machine's step).  On
#: the rwkv6 smoke round a few elements differ so; the rest hold 2e-4.  Only
#: such elements may differ, at most SIGN_FLIP_SHARE of a leaf, each by at
#: most 2·(lr·K + slr·S).  The first steps are each machine's first local
#: step and the server's first step (at the JAX average).
SIGN_FLIP_SHARE = 1e-3
GRAD_FLOOR = 2e-4


def _first_step_grads(jlm, jp, local, corr, G, K):
    """The JAX package's gradient at each Adam first step of the round:
    machine g's at the initial parameters on its first batch, and the
    server's at the average (a round with no correction step) on the first
    correction batch."""
    grad = jax.jit(jax.grad(jlm.loss))
    at = lambda p, b: _jleaves(grad(p, {k: jnp.asarray(v)
                                        for k, v in b.items()}))
    out = [at(jp, {k: v[g, 0] for k, v in local.items()}) for g in range(G)]
    avg_G, _ = _jax_round(jlm, jp, local, {k: v[:0] for k, v in corr.items()},
                          G, K, 0)
    avg = jax.tree_util.tree_map(lambda x: x[0], avg_G)
    out.append(at(avg, {k: v[0] for k, v in corr.items()}))
    return out


@pytest.mark.parametrize("arch,G,K,S,tol", [(None, 3, 2, 2, 2e-5),
                                            ("rwkv6-1.6b", 2, 2, 1, 2e-4)])
def test_llcg_round_matches_jax(arch, G, K, S, tol):
    jlm, lm, jp, local, corr = _setup(G, K, S, arch)
    want_G, want_m = _jax_round(jlm, jp, local, corr, G, K, S)
    got_G, got_m = _port_round(lm, jp, local, corr, G, K, S)
    got, want = _tleaves(got_G), _jleaves(want_G)
    assert set(got) == set(want)
    firsts = None if arch is None else _first_step_grads(jlm, jp, local,
                                                          corr, G, K)
    for k in want:                        # tests/test_distributed_steps.py's
        if arch is None:                  # elementwise rule
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=k)
            continue
        diff = np.abs(got[k] - want[k])
        off = diff > tol + tol * np.abs(want[k])
        assert off.mean() <= SIGN_FLIP_SHARE, (k, int(off.sum()))
        assert diff.max() <= 2 * (1e-3 * K + 5e-4 * S), (k, float(diff.max()))
        undetermined = np.zeros(off.shape[1:], dtype=bool)
        for g in firsts:
            undetermined |= np.abs(g[k]) <= GRAD_FLOOR * np.abs(g[k]).max()
        assert undetermined[off.any(axis=0)].all(), (
            k, "an element differs whose first-step gradients are all "
               "above the floor")
    for key in ("local_loss", "corr_loss"):
        assert got_m[key].shape == ()
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=1e-5)


def test_llcg_round_broadcasts_identical_copies():
    G = 4
    _, lm, jp, local, corr = _setup(G=G)
    out_G, _ = _port_round(lm, jp, local, corr, G, 2, 2)
    for leaf in _tleaves(out_G).values():
        for g in range(1, G):
            np.testing.assert_array_equal(leaf[0], leaf[g])


def test_bf16_averaging_close_to_f32():
    G = 3
    jlm, lm, jp, local, corr = _setup(G=G)
    corr = {k: v[:1] for k, v in corr.items()}
    f32, _ = _port_round(lm, jp, local, corr, G, 2, 1)
    bf16, _ = _port_round(lm, jp, local, corr, G, 2, 1, avg_bf16=True)
    want, _ = _jax_round(jlm, jp, local, corr, G, 2, 1, avg_bf16=True)
    for a, b in zip(_tleaves(f32).values(), _tleaves(bf16).values()):
        np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL)
    _close_leaves(_tleaves(tree_map(lambda x: x[0], bf16)),
                  _jleaves(jax.tree_util.tree_map(lambda x: x[0], want)),
                  BF16_TOL, "avg_bf16 vs JAX")


def test_remat_equals_no_remat():
    G, K, S = 2, 1, 1
    _, lm, jp, local, corr = _setup(G=G, K=K, S=S, arch="rwkv6-1.6b")
    plain, pm = _port_round(lm, jp, local, corr, G, K, S)
    remat, rm = _port_round(lm, jp, local, corr, G, K, S, remat=True)
    for a, b in zip(_tleaves(plain).values(), _tleaves(remat).values()):
        np.testing.assert_array_equal(a, b)
    assert float(pm["corr_loss"]) == float(rm["corr_loss"])


def test_sync_step_matches_jax_and_reduces_loss():
    jlm, lm, jp, local, _ = _setup()
    batch = {k: v[0, 0] for k, v in local.items()}
    jstep = jax.jit(jsteps.build_sync_train_step(jlm, jadamw(1e-2)))
    step = steps.build_sync_train_step(lm, adamw(1e-2))
    jparams, jstate = jp, jadamw(1e-2).init(jp)
    params = lm_params_from_jax(_np(jp), device="cpu")
    state = adamw(1e-2).init(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(10):
        jparams, jstate, jloss = jstep(jparams, jstate,
                                       {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        params, state, loss = step(params, state, tbatch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    _close_leaves(_tleaves(params), _jleaves(jparams), 2e-5, "sync step")


# --------------------------------------------------------------------------
# The trainer
# --------------------------------------------------------------------------
def test_train_on_cpu_runs_rounds_and_checkpoints(tmp_path):
    cfg = ttrain.TrainConfig(arch="gemma3-1b", smoke=True, rounds=2,
                             base_k=1, rho=1.0, seq_len=32,
                             batch_per_group=2, heterogeneity=0.5,
                             correction_steps=1, ckpt_dir=str(tmp_path))
    params_G, metrics = ttrain.train(cfg, device="cpu")
    assert np.isfinite(float(metrics["local_loss"]))
    assert np.isfinite(float(metrics["corr_loss"]))
    hist = metrics["history"]
    assert [h["round"] for h in hist] == [1, 2]
    assert all(np.isfinite([h["local_loss"], h["corr_loss"]]).all()
               for h in hist)
    for leaf in _tleaves(params_G).values():
        np.testing.assert_array_equal(leaf[0], leaf[-1])
    first = tree_map(lambda x: x[0], params_G)
    restored, _, meta = restore_checkpoint(str(tmp_path), first)
    assert meta["step"] == 2
    assert meta["extra"] == {"round": 2, "comm_mb": hist[-1]["comm_mb"]}
    for k, x in _tleaves(restored).items():
        np.testing.assert_array_equal(x, _tleaves(first)[k])


def test_main_parses_every_train_config_field():
    argv = ["--arch", "rwkv6-1.6b", "--smoke", "false", "--rounds", "3",
            "--base-k", "5", "--rho", "1.7", "--correction-steps", "2",
            "--batch-per-group", "6", "--seq-len", "33", "--lr", "0.01",
            "--server-lr", "0.02", "--heterogeneity", "0.25", "--seed", "7",
            "--ckpt-dir", "/ck", "--mesh", "production",
            "--model-parallel", "2", "--remat", "true", "--device", "cpu"]
    cfg, device = ttrain.parse_args(argv)
    assert device == "cpu"
    assert dataclasses.asdict(cfg) == dict(
        arch="rwkv6-1.6b", smoke=False, rounds=3, base_k=5, rho=1.7,
        correction_steps=2, batch_per_group=6, seq_len=33, lr=0.01,
        server_lr=0.02, heterogeneity=0.25, seed=7, ckpt_dir="/ck",
        mesh="production", model_parallel=2, remat=True)
    assert ttrain.parse_args([])[0] == ttrain.TrainConfig()
    with pytest.raises(RuntimeError, match="256 ranks"):
        ttrain.main(argv)


@pytest.mark.parametrize("override,error,match", [
    ({"mesh": "production"}, RuntimeError, "256 ranks"),
    ({"mesh": "production-multipod"}, RuntimeError, "512 ranks"),
    ({"model_parallel": 2}, ValueError, "model_parallel=2")])
def test_unported_meshes_raise(override, error, match):
    """Without a process group the production meshes raise, naming the
    world size they need; one CPU does not split over model_parallel=2."""
    with pytest.raises(error, match=match):
        ttrain.make_mesh(ttrain.TrainConfig(**override), device="cpu")


def test_example_runs_one_round(capsys):
    sys.path.insert(0, str(ROOT))
    from examples.torch_distributed_lm_llcg import main
    assert main(["--rounds", "1", "--seq-len", "16", "--batch-per-group",
                 "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "round  1" in out and "done" in out
