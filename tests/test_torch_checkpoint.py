"""Checkpointing in the port: the params store against the JAX package's
(files cross-load both ways), full-state format parity, and exact resume.

The resume contract (``repro_torch.checkpoint.manager`` + ``CheckpointSpec``):
a run checkpointed at round r and resumed in a FRESH trainer completes
bit-identical to a run never interrupted — params, every History series,
byte/step accounting, retrace counts — with the ``int8_ef`` residual and
its stochastic-rounding uniform stream in play.  Invalid checkpoints fall
back (``step=None``) or fail hard (explicit step); plan or dataset digest
mismatches are refused.  The plan is the reference's own resume fixture
(``tests/test_resume.py``: 120-node SBM, ``GG`` hidden 16, 2 machines,
ρ = 1.5 with K-bucketing, int8_ef, adam), run on the CPU.

Tolerances: bit identity for every resume and every store round trip;
logits from cross-loaded params 1e-5 (the two packages' f32 forwards sum
in another order).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_params as ref_load_params
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.core import plan as R
from repro.graph.csr import build_neighbor_table as ref_table
from repro.graph.datasets import grid_graph as ref_grid
from repro.graph.datasets import sbm_graph as ref_sbm
from repro.models.gnn.model import build_model as ref_build_model
from repro.serving import GNNRequest as RefRequest
from repro.serving import GNNServingEngine as RefEngine

from repro_torch.checkpoint import (CheckpointManager, check_cast,
                                    load_params, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import plan as P
from repro_torch.graph.datasets import grid_graph, sbm_graph
from repro_torch.launch.train import resume, run_or_resume
from repro_torch.models.gnn.model import build_model
from repro_torch.serving.gnn import GNNRequest, GNNServingEngine
from repro_torch.utils.pytree import flatten_with_paths, tree_leaves

TOL = 1e-5
ROUNDS = 3


# --------------------------------------------------------------------------
# the params store: cross-loading
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def grid():
    kw = dict(side=16, num_classes=4, feature_dim=8, seed=0)
    return ref_grid(**kw), grid_graph(**kw)


def _trained_jax(model, seed=3):
    """A param tree that is not the init: init(0) plus noise."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) * 0.1),
        model.init(0))


def _jax_logits(model, params, data):
    table, mask = ref_table(data.graph)
    return np.asarray(model.apply(params, jnp.asarray(data.features),
                                  jnp.asarray(table), jnp.asarray(mask)))


def _port_logits(model, params, data):
    from repro_torch.graph.csr import build_neighbor_table
    table, mask = build_neighbor_table(data.graph)
    t = lambda a: torch.from_numpy(np.asarray(a))
    with torch.no_grad():
        return model.apply(params, t(data.features), t(table),
                           t(mask)).numpy()


@pytest.mark.parametrize("arch", ["SS", "GAT"])
def test_jax_checkpoint_loads_into_the_port(grid, tmp_path, arch):
    rdata, data = grid
    rmodel = ref_build_model(arch, 8, 4, hidden_dim=16)
    model = build_model(arch, 8, 4, hidden_dim=16)
    params = _trained_jax(rmodel)
    ref_save_checkpoint(str(tmp_path), 7, params, extra={"strategy": "x"})
    got, meta = load_params(str(tmp_path), model.init_numpy(0),
                            device="cpu")
    assert meta["step"] == 7 and meta["extra"]["strategy"] == "x"
    for (k, a), (_, b) in zip(flatten_with_paths(got),
                              flatten_with_paths(jax.tree_util.tree_map(
                                  np.asarray, params))):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu", k
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(_port_logits(model, got, data),
                               _jax_logits(rmodel, params, rdata),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ["SS", "GAT"])
def test_port_checkpoint_loads_into_jax(grid, tmp_path, arch):
    rdata, data = grid
    rmodel = ref_build_model(arch, 8, 4, hidden_dim=16)
    model = build_model(arch, 8, 4, hidden_dim=16)
    jparams = _trained_jax(rmodel, seed=5)
    params = jax.tree_util.tree_map(lambda x: torch.from_numpy(
        np.array(x)), jparams)
    save_checkpoint(str(tmp_path), 4, params, extra={"round": 4})
    back, meta = ref_load_params(str(tmp_path), rmodel.init(0))
    assert meta["step"] == 4
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(_jax_logits(rmodel, back, rdata),
                               _port_logits(model, params, data),
                               atol=TOL, rtol=TOL)


def test_bf16_leaves_cross_load_both_ways(tmp_path):
    """bfloat16 travels as npz void bytes under the name "bfloat16" in both
    packages; the port needs no ml_dtypes for it."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"a": {"w": jnp.asarray(f32, jnp.bfloat16)},
             "b": jnp.asarray(f32[0])}
    ref_save_checkpoint(str(tmp_path / "j"), 1, jtree)
    tmpl = {"a": {"w": torch.zeros((3, 5), dtype=torch.bfloat16)},
            "b": torch.zeros(5)}
    got, _, meta = restore_checkpoint(str(tmp_path / "j"), tmpl)
    assert meta["dtypes"]["params/a/w"] == "bfloat16"
    want = torch.from_numpy(f32).to(torch.bfloat16)
    assert got["a"]["w"].dtype is torch.bfloat16
    assert torch.equal(got["a"]["w"], want)
    # bf16 → f32 widens safely; the reverse is refused
    wide, _, _ = restore_checkpoint(str(tmp_path / "j"), {
        "a": {"w": torch.zeros((3, 5))}, "b": torch.zeros(5)})
    assert torch.equal(wide["a"]["w"], want.float())
    save_checkpoint(str(tmp_path / "p"), 2, {"a": {"w": want},
                                             "b": torch.from_numpy(f32[0])})
    back, _ = ref_load_params(str(tmp_path / "p"), jtree)
    assert back["a"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"]["w"], np.float32),
                                  want.float().numpy())


def test_lossy_casts_are_refused(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    with pytest.raises(TypeError, match="lossy"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(
            3, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="lossy"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(
            3, dtype=torch.int32)})
    got, _, _ = restore_checkpoint(str(tmp_path), {"w": torch.zeros(
        3, dtype=torch.bfloat16)}, allow_lossy_cast=True)
    assert got["w"].dtype is torch.bfloat16
    check_cast(np.dtype(np.float32), np.dtype(np.float64), "k")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(str(tmp_path), {"v": torch.zeros(3)})


def test_load_params_lands_on_the_requested_device(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    got, _ = load_params(str(tmp_path), {"w": np.zeros(3, np.float32)},
                         device="cpu")
    assert isinstance(got["w"], torch.Tensor)
    import inspect
    assert inspect.signature(load_params).parameters[
        "device"].default == "cuda"


def test_serving_engines_load_each_others_files(grid, tmp_path):
    """``GNNServingEngine.from_checkpoint`` of each package on the other's
    file: identical predictions at full width."""
    rdata, data = grid
    rmodel = ref_build_model("SS", 8, 4, hidden_dim=16)
    model = build_model("SS", 8, 4, hidden_dim=16)
    jparams = _trained_jax(rmodel, seed=9)
    ref_save_checkpoint(str(tmp_path / "j"), 3, jparams)
    save_checkpoint(str(tmp_path / "p"), 3, jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)), jparams))
    rng = np.random.default_rng(2)
    reqs = [dict(uid=i, nodes=rng.integers(0, data.num_nodes, 6).tolist())
            for i in range(5)]
    port = GNNServingEngine.from_checkpoint(str(tmp_path / "j"), model, data,
                                            num_machines=4, device="cpu")
    ref = RefEngine.from_checkpoint(str(tmp_path / "p"), rmodel, rdata,
                                    num_machines=4)
    for r in reqs:
        port.submit(GNNRequest(**r))
        ref.submit(RefRequest(**r))
    got = {r.uid: r.predictions for r in port.run()}
    want = {r.uid: r.predictions for r in ref.run()}
    assert got == want
    assert port.checkpoint_meta["step"] == 3


# --------------------------------------------------------------------------
# full-state checkpoints and exact resume
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    data = sbm_graph(num_nodes=120, num_classes=3, feature_dim=8, seed=0)
    model = build_model("GG", data.feature_dim, data.num_classes,
                        hidden_dim=16)
    return data, model


def _mk_plan(M, ckdir=None, compression="int8_ef", rounds=ROUNDS, lr=1e-2,
             every=1, keep=0, async_=True):
    ck = (M.CheckpointSpec(dir=str(ckdir), keep=keep, every=every,
                           async_=async_) if ckdir else None)
    return M.TrainPlan(
        phases=(M.local_steps(), M.averaging(), M.correction()),
        local=M.LocalSpec(local_k=2, batch_size=8, lr=lr),
        server=M.ServerSpec(correction_steps=1, server_batch_size=16),
        comm=M.CommSpec(num_machines=2, compression=compression),
        schedule=M.ScheduleSpec(rounds=rounds, rho=1.5),
        compile=M.CompileSpec(k_bucketing=True),
        name="resume-test", seed=0, checkpoint=ck)


def _run(data, model, plan, **kw):
    return P.build_trainer(data, model, plan, device="cpu").run(**kw)


def _assert_same(ref, got):
    """Bit identity of everything History carries (params included)."""
    assert got.rounds == ref.rounds
    assert got.steps_cum == ref.steps_cum
    assert got.val_score == ref.val_score
    assert got.train_loss == ref.train_loss
    assert got.bytes_cum == ref.bytes_cum
    for key in ("local_loss", "corr_loss", "corr_rounds", "num_retraces",
                "num_corr_retraces", "masked_steps"):
        assert got.meta[key] == ref.meta[key], key
    for a, b in zip(tree_leaves(ref.meta["final_params"]),
                    tree_leaves(got.meta["final_params"])):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def reference(tiny):
    return _run(*tiny, _mk_plan(P))


@pytest.mark.parametrize("compression", ["int8_ef", "none"])
@pytest.mark.parametrize("step", range(1, ROUNDS + 1))
def test_resume_every_round_boundary(tiny, reference, tmp_path, step,
                                     compression):
    data, model = tiny
    ref = (reference if compression == "int8_ef"
           else _run(data, model, _mk_plan(P, compression=compression)))
    full = _run(data, model, _mk_plan(P, tmp_path, compression=compression))
    _assert_same(ref, full)
    got = _run(data, model, _mk_plan(P, compression=compression),
               resume_from=str(tmp_path), resume_step=step)
    _assert_same(ref, got)


def test_uniform_stream_is_part_of_the_state(tiny, reference, tmp_path):
    """The one entry the port carries beyond the JAX package's: without the
    restored generator position a resumed int8_ef run draws round 1's
    uniforms again and leaves the uninterrupted trajectory."""
    data, model = tiny
    _run(data, model, _mk_plan(P, tmp_path))
    mgr = CheckpointManager(str(tmp_path), async_=False)
    manifest = mgr.read_manifest(1)
    assert manifest["dtypes"]["uniforms/local:True"] == "uint8"
    trainer = P.build_trainer(data, model, _mk_plan(P), device="cpu")
    orig = P._PlanProgram.restore_run_state

    def forget_stream(self, tree, aux):
        tree = dict(tree)
        tree.pop("uniforms")
        return orig(self, tree, aux)
    P._PlanProgram.restore_run_state = forget_stream
    try:
        got = trainer.run(resume_from=str(tmp_path), resume_step=1)
    finally:
        P._PlanProgram.restore_run_state = orig
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(reference.meta["final_params"]),
        tree_leaves(got.meta["final_params"])))


def test_resume_from_latest_and_run_or_resume(tiny, reference, tmp_path):
    data, model = tiny
    ck = tmp_path / "ck"
    h1 = run_or_resume(data, model, _mk_plan(P, ck), device="cpu")
    _assert_same(reference, h1)
    h2 = run_or_resume(data, model, _mk_plan(P, ck), device="cpu")
    _assert_same(reference, h2)
    h3 = resume(data, model, _mk_plan(P), ckpt_dir=str(ck), device="cpu")
    _assert_same(reference, h3)
    with pytest.raises(ValueError, match="CheckpointSpec"):
        run_or_resume(data, model, _mk_plan(P), device="cpu")
    with pytest.raises(ValueError, match="checkpoint directory"):
        resume(data, model, _mk_plan(P), device="cpu")


def test_checkpoint_every_and_retention(tiny, tmp_path):
    data, model = tiny
    _run(data, model, _mk_plan(P, tmp_path / "ck", rounds=4, every=2,
                               keep=1))
    mgr = CheckpointManager(str(tmp_path / "ck"), async_=False)
    assert mgr.steps() == [4]
    assert not [f for f in os.listdir(tmp_path / "ck")
                if f.endswith(".tmp")]


def _corrupt(path):
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))


@pytest.mark.parametrize("what", ["payload", "manifest"])
def test_corrupt_latest_falls_back_to_previous(tiny, reference, tmp_path,
                                               what):
    data, model = tiny
    _run(data, model, _mk_plan(P, tmp_path / "ck"))
    if what == "payload":
        _corrupt(tmp_path / "ck" / f"ckpt_{ROUNDS}.npz")
    else:
        (tmp_path / "ck" / f"ckpt_{ROUNDS}.json").write_text("{ not json")
    with pytest.warns(UserWarning, match="invalid"):
        got = _run(data, model, _mk_plan(P),
                   resume_from=str(tmp_path / "ck"))
    _assert_same(reference, got)


def test_corrupt_explicit_step_fails_hard(tiny, tmp_path):
    data, model = tiny
    _run(data, model, _mk_plan(P, tmp_path / "ck"))
    _corrupt(tmp_path / "ck" / "ckpt_2.npz")
    with pytest.raises(Exception):
        _run(data, model, _mk_plan(P), resume_from=str(tmp_path / "ck"),
             resume_step=2)


def test_tampered_leaf_hash_detected(tiny, tmp_path):
    data, model = tiny
    _run(data, model, _mk_plan(P, tmp_path / "ck", rounds=2))
    mpath = tmp_path / "ck" / "ckpt_2.json"
    manifest = json.loads(mpath.read_text())
    key = next(iter(manifest["leaf_hashes"]))
    manifest["leaf_hashes"][key] = "0" * 64
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="integrity"):
        _run(data, model, _mk_plan(P, rounds=2),
             resume_from=str(tmp_path / "ck"), resume_step=2)


def test_plan_and_data_digest_mismatches_refused(tiny, tmp_path):
    data, model = tiny
    _run(data, model, _mk_plan(P, tmp_path / "ck", rounds=2))
    for plan in (_mk_plan(P, rounds=2, lr=5e-3),
                 _mk_plan(P, rounds=2, compression="none")):
        with pytest.raises(ValueError, match="plan digest"):
            _run(data, model, plan, resume_from=str(tmp_path / "ck"))
    other = sbm_graph(num_nodes=120, num_classes=3, feature_dim=8, seed=9)
    with pytest.raises(ValueError, match="dataset digest"):
        _run(other, model, _mk_plan(P, rounds=2),
             resume_from=str(tmp_path / "ck"))


def test_checkpoint_spec_validation():
    for bad in (dict(dir=""), dict(dir="x", every=0), dict(dir="x", keep=-1),
                dict(dir="x", queue_size=0)):
        with pytest.raises(ValueError):
            P.CheckpointSpec(**bad)


@pytest.mark.parametrize("attempt", range(2))
def test_sync_and_async_checkpoints_identical(tiny, tmp_path, attempt):
    """The writer thread and inline writes put the same bytes on disk —
    the caller thread copies every leaf and the History before the next
    round touches them (the JAX package's writer does not; ROADMAP Queue
    3).  Run twice, so a race would have two chances to show."""
    data, model = tiny
    _run(data, model, _mk_plan(P, tmp_path / "a", async_=True))
    _run(data, model, _mk_plan(P, tmp_path / "b", async_=False))
    for step in range(1, ROUNDS + 1):
        wa = (tmp_path / "a" / f"ckpt_{step}.npz").read_bytes()
        wb = (tmp_path / "b" / f"ckpt_{step}.npz").read_bytes()
        assert wa == wb
        ma = json.loads((tmp_path / "a" / f"ckpt_{step}.json").read_text())
        mb = json.loads((tmp_path / "b" / f"ckpt_{step}.json").read_text())
        for m in (ma, mb):
            m["train"]["history"]["meta"]["plan"].pop("checkpoint")
        assert ma == mb
        assert len(ma["train"]["history"]["meta"]["local_loss"]) == step


def test_full_state_format_matches_jax(tiny, tmp_path):
    """One plan (llcg phases, int8_ef, adam): both packages' checkpoints
    carry the same leaf keys, shapes and dtypes and the same manifest
    fields; the port's one extra leaf is its uniform-stream state."""
    data, model = tiny
    rdata = ref_sbm(num_nodes=120, num_classes=3, feature_dim=8, seed=0)
    rmodel = ref_build_model("GG", 8, 3, hidden_dim=16)
    R.build_trainer(rdata, rmodel, _mk_plan(R, tmp_path / "j",
                                            async_=False)).run()
    _run(data, model, _mk_plan(P, tmp_path / "p"))
    for step in (1, ROUNDS):
        zj = np.load(tmp_path / "j" / f"ckpt_{step}.npz")
        zp = np.load(tmp_path / "p" / f"ckpt_{step}.npz")
        assert set(zp.files) - set(zj.files) == {"uniforms/local:True"}
        assert set(zj.files) <= set(zp.files)
        for k in zj.files:
            assert zj[k].shape == zp[k].shape, k
            assert zj[k].dtype == zp[k].dtype, k
        mj = json.loads((tmp_path / "j" / f"ckpt_{step}.json").read_text())
        mp = json.loads((tmp_path / "p" / f"ckpt_{step}.json").read_text())
        assert sorted(mj) == sorted(mp)
        assert sorted(mj["train"]) == sorted(mp["train"])
        assert mj["data_digest"] == mp["data_digest"]
        for key in ("rounds", "steps_cum", "bytes_cum"):
            assert mj["train"]["history"][key] == mp["train"]["history"][key]
        assert {k: v for k, v in mp["dtypes"].items()
                if k in mj["dtypes"]} == mj["dtypes"]


def test_params_export_serves_through_from_plan(tiny, tmp_path):
    """``TrainPlan.checkpoint_dir`` exports each round's params (newest 3
    kept); ``GNNServingEngine.from_plan`` serves the newest on the plan's
    partition, equal to serving the trained params from memory."""
    data, model = tiny
    cfg = P.DistConfig(num_machines=2, rounds=4, local_k=2, batch_size=8,
                       fanout=5, checkpoint_dir=str(tmp_path), seed=0)
    plan = P.llcg_plan(cfg)
    hist = P.build_trainer(data, model, plan, device="cpu").run()
    assert sorted(os.listdir(tmp_path)) == [f"step_{r}.npz"
                                            for r in (2, 3, 4)]
    eng = GNNServingEngine.from_plan(plan, model, data, device="cpu")
    assert eng.checkpoint_meta["extra"]["round"] == 4
    mem = GNNServingEngine(model, hist.meta["final_params"], data,
                           partition=eng.partition, seed=0, device="cpu")
    for e in (eng, mem):
        e.submit(GNNRequest(uid=0, nodes=[0, 5, 77, 119],
                            return_embeddings=True))
    a, b = eng.run()[0], mem.run()[0]
    np.testing.assert_array_equal(a.embeddings, b.embeddings)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        GNNServingEngine.from_plan(P.llcg_plan(P.DistConfig()), model, data,
                                   device="cpu")


def test_chaos_sigkill_trial_resumes_bit_identical():
    """One SIGKILL trial of the chaos harness: the child kills itself right
    after round 2's checkpoint is durable, is relaunched, resumes, and
    dumps results bit-identical to an uninterrupted child's."""
    from repro_torch.checkpoint.chaos import run_chaos
    run_chaos(kill_round=2, kill_mode="self", device="cpu")


def test_chaos_device_placement_trial_runs():
    """A device-placed trial, refused before the device sampler was ported,
    now runs: SIGKILLed after round 2, resumed bit-identical (the device
    stream is stateless per round).  The shard_map trial is in
    ``test_torch_sharded.py``."""
    from repro_torch.checkpoint.chaos import run_chaos
    run_chaos(placement="device", kill_round=2, kill_mode="self",
              device="cpu")


def test_quickstart_checkpoint_section_resumes_exactly():
    """``examples/torch_quickstart.py``'s checkpoint section: the resume
    from round 4 and ``run_or_resume`` reproduce the checkpointed run."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    quick = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quick)
    hist, mid, again = quick.checkpointed("cpu")
    for h in (mid, again):
        _assert_same(hist, h)
