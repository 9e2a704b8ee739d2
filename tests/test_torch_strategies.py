"""The paper's strategy shims and analysis in the port, against the JAX
package on the same seeds: ``run_psgd_pa`` / ``run_llcg`` / ``run_ggs`` /
``run_single_machine``, the sampling contexts and the one-machine step,
the LR schedules, the metrics, the Section-4 estimators
(``estimate_discrepancies``), the subgraph-approximation baseline and the
quickstart's byte accounting.

Tolerances: host draws, byte and step accounting exactly equal; 3-round
trajectories 1e-4 (single-forward f32 differences compound over the Adam
steps), F1 within one eval node; one step 1e-5 (f32 sums in another
order); schedules 1e-7 (float32 transcendental results within an ulp);
ROC-AUC 1e-6; the discrepancy estimates 1e-4 relative and 1e-7 absolute
(squared norms of differences of f32 gradients, which cancel).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R
from repro.core import metrics as ref_metrics
from repro.core.strategies import GGSContext as RefGGSContext
from repro.core.strategies import _Context as RefContext
from repro.core.subgraph_approx import build_approx_views as ref_views
from repro.core.subgraph_approx import run_subgraph_approx as ref_subgraph
from repro.graph import partition_graph as ref_partition
from repro.graph import sbm_graph as ref_sbm
from repro.models.gnn import build_model as ref_build_model
from repro.optim import schedules as ref_sched

import repro_torch.core as C
from repro_torch.convert import params_from_jax
from repro_torch.core import metrics
from repro_torch.core.strategies import GGSContext, _Context
from repro_torch.core.subgraph_approx import (build_approx_views,
                                              run_subgraph_approx)
from repro_torch.graph import partition_graph, sbm_graph
from repro_torch.models.gnn import build_model
from repro_torch.optim import (constant_lr, cosine_decay,
                               linear_warmup_cosine)
from repro_torch.utils.pytree import tree_leaves

LOSS_TOL = 1e-4
STEP_TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]

# the fig2 setting of benchmarks/paper_experiments.py at 3 rounds, and a
# smaller graph for the per-step and subgraph-approximation checks
_FIG2 = dict(num_nodes=480, num_classes=4, feature_dim=16, feature_snr=0.15,
             homophily=0.95, avg_degree=14, seed=0)
_CFG = dict(num_machines=4, rounds=3, local_k=4, batch_size=32,
            server_batch_size=64, fanout=8, lr=1e-2, correction_steps=2,
            partition_method="random", seed=0)
_SMALL = dict(num_nodes=200, num_classes=4, feature_dim=16, feature_snr=0.08,
              homophily=0.96, avg_degree=10, seed=6)


def _both(data_kw, arch="GG", hidden=32):
    r, p = ref_sbm(**data_kw), sbm_graph(**data_kw)
    args = (arch, r.feature_dim, r.num_classes)
    return (r, ref_build_model(*args, hidden_dim=hidden),
            p, build_model(*args, hidden_dim=hidden))


def _assert_trajectory(port, ref, one_node, losses=("train_loss",)):
    for key in losses:
        a = getattr(port, key, None)
        a = port.meta[key] if a is None else a
        b = getattr(ref, key, None)
        b = ref.meta[key] if b is None else b
        np.testing.assert_allclose(a, b, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(port.val_score, ref.val_score, rtol=0,
                               atol=one_node + 1e-9)
    assert port.bytes_cum == ref.bytes_cum
    assert port.steps_cum == ref.steps_cum


# --------------------------------------------------------------------------
# The run_* shims
# --------------------------------------------------------------------------
_SHIMS = ("psgd_pa", "llcg", "ggs", "single")


@pytest.fixture(scope="module")
def shim_hists():
    r, rm, p, pm = _both(_FIG2)
    hists = {}
    for name in _SHIMS:
        ref = getattr(R, f"run_{name}" if name != "single"
                      else "run_single_machine")
        port = getattr(C, f"run_{name}" if name != "single"
                       else "run_single_machine")
        hists[name] = (port(p, pm, C.DistConfig(**_CFG), device="cpu"),
                       ref(r, rm, R.DistConfig(**_CFG)))
    return hists, 1.0 / len(p.val_nodes)


@pytest.mark.parametrize("name", _SHIMS)
def test_run_shim_matches_jax(shim_hists, name):
    hists, one_node = shim_hists
    port, ref = hists[name]
    assert port.strategy == ref.strategy
    assert port.meta["cfg"] == ref.meta["cfg"]
    _assert_trajectory(port, ref, one_node,
                       ("train_loss", "local_loss", "corr_loss"))


def test_run_psgd_pa_forces_rho_one():
    _, _, p, pm = _both(_SMALL, hidden=8)
    cfg = C.DistConfig(**dict(_CFG, rounds=2, rho=2.0))
    hist = C.run_psgd_pa(p, pm, cfg, device="cpu")
    assert hist.meta["cfg"]["rho"] == 1.0
    per_round = cfg.num_machines * cfg.local_k
    assert hist.steps_cum == [per_round, 2 * per_round]


def test_shims_default_to_the_card():
    import inspect
    for fn in (C.run_psgd_pa, C.run_llcg, C.run_ggs, C.run_single_machine,
               run_subgraph_approx):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# --------------------------------------------------------------------------
# Sampling contexts and the one-machine step
# --------------------------------------------------------------------------
def test_contexts_draw_what_the_reference_draws():
    r, rm, p, pm = _both(_SMALL, hidden=8)
    cfg = dict(_CFG, num_machines=3)
    ref, port = RefContext(r, rm, R.DistConfig(**cfg)), _Context(
        p, pm, C.DistConfig(**cfg), device="cpu")
    for _ in range(2):
        for m in range(3):
            for a, b in zip(port.local_batch(m), ref.local_batch(m)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    for a, b in zip(port.sample_local_round(2), ref.sample_local_round(2)):
        np.testing.assert_array_equal(a, b)
    ref_g, port_g = RefGGSContext(r, rm, R.DistConfig(**cfg)), GGSContext(
        p, pm, C.DistConfig(**cfg), device="cpu")
    assert port_g.n_ext_max == ref_g.n_ext_max
    assert port_g.exchange_bytes_per_step == ref_g.exchange_bytes_per_step
    for a, b in zip(port_g.sample_round_arrays(2),
                    ref_g.sample_round_arrays(2)):
        np.testing.assert_array_equal(a, b)


def test_machine_step_matches_jax():
    r, rm, p, pm = _both(_SMALL, hidden=8)
    cfg = dict(_CFG, num_machines=2)
    ref, port = RefContext(r, rm, R.DistConfig(**cfg)), _Context(
        p, pm, C.DistConfig(**cfg), device="cpu")
    rp = rm.init(0)
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, rp),
                         device="cpu")
    tab, msk = ref.sample_local_round(1)[:2]
    batch, bmask = ref.local_batch(0)
    jargs = [jnp.asarray(a) for a in (ref.feats[0], tab[0, 0], msk[0, 0],
                                      batch, ref.labels[0], bmask)]
    targs = [torch.from_numpy(np.asarray(a)) for a in
             (ref.feats[0], tab[0, 0], msk[0, 0], batch, ref.labels[0],
              bmask)]
    jp, _, jl = ref.step.local_step(rp, ref.opt.init(rp), *jargs)
    tp, _, tl = port.step.local_step(pp, port.opt.init(pp), *targs)
    np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_TOL,
                               atol=STEP_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=STEP_TOL,
                                   atol=STEP_TOL)
    jl2, jg = ref.step.loss_and_grad(rp, *jargs)
    tl2, tg = port.step.loss_and_grad(pp, *targs)
    assert float(tl2) == pytest.approx(float(jl2), rel=STEP_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tree_leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=STEP_TOL,
                                   atol=STEP_TOL)


# --------------------------------------------------------------------------
# Schedules and metrics
# --------------------------------------------------------------------------
_SCHEDULES = {
    "constant": ((constant_lr, ref_sched.constant_lr), (3e-3,)),
    "cosine": ((cosine_decay, ref_sched.cosine_decay), (1e-2, 50, 1e-4)),
    "warmup_cosine": ((linear_warmup_cosine, ref_sched.linear_warmup_cosine),
                      (1e-2, 10, 50, 1e-4)),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedules_match_jax(name):
    (port, ref), args = _SCHEDULES[name]
    total = 50
    steps = np.arange(0, 2 * total + 1, dtype=np.int32)
    want = np.array([float(ref(*args)(jnp.asarray(s))) for s in steps])
    got = np.array([float(port(*args)(int(s))) for s in steps])
    got_t = port(*args)(torch.from_numpy(steps))
    assert port(*args)(3).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-7)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 64)
    scores = np.round(rng.standard_normal((64, 3)), 1)     # with ties
    truth = (rng.random((64, 3)) < 0.4).astype(np.float32)
    for conv in (np.asarray, torch.from_numpy):
        assert metrics.f1_micro_multiclass(conv(logits), conv(labels)) == \
            ref_metrics.f1_micro_multiclass(logits, labels)
        assert metrics.f1_micro_multilabel(conv(scores), conv(truth)) == \
            ref_metrics.f1_micro_multilabel(scores, truth)
        assert metrics.roc_auc(conv(scores[:, 0]), conv(truth[:, 0])) == \
            pytest.approx(ref_metrics.roc_auc(scores[:, 0], truth[:, 0]),
                          abs=1e-6)
        assert metrics.roc_auc_macro_multilabel(conv(scores), conv(truth)) \
            == pytest.approx(ref_metrics.roc_auc_macro_multilabel(
                scores, truth), abs=1e-6)
    assert np.isnan(metrics.roc_auc(np.zeros(4), np.zeros(4)))
    assert metrics.perplexity(torch.tensor(2.5)) == pytest.approx(
        ref_metrics.perplexity(2.5), rel=1e-7)


# --------------------------------------------------------------------------
# The Section-4 estimators (tests/test_theory.py's setting)
# --------------------------------------------------------------------------
_THEORY = dict(num_nodes=320, num_classes=4, feature_dim=12, feature_snr=0.2,
               homophily=0.95, seed=1)
# (parts, method, fanout, trials, seed)
_ESTIMATES = {
    "single_full": (1, "random", None, 2, 0),
    "random_fanout4": (4, "random", 4, 2, 0),
    "bfs_fanout2": (2, "bfs", 2, 3, 3),
}


@pytest.mark.parametrize("case", sorted(_ESTIMATES))
def test_estimate_discrepancies_matches_jax(case):
    parts, method, fanout, trials, seed = _ESTIMATES[case]
    r, rm, p, pm = _both(_THEORY, hidden=24)
    rparams = rm.init(0)
    ref = R.estimate_discrepancies(
        r, ref_partition(r.graph, parts, method=method), rm, rparams,
        fanout=fanout, num_sampling_trials=trials, seed=seed)
    est = C.estimate_discrepancies(
        p, partition_graph(p.graph, parts, method=method), pm,
        params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                        device="cpu"),
        fanout=fanout, num_sampling_trials=trials, seed=seed)
    for field in dataclasses.fields(ref):
        assert getattr(est, field.name) == pytest.approx(
            getattr(ref, field.name), rel=1e-4, abs=1e-7), field.name
    assert C.theorem1_residual(est) == pytest.approx(
        R.theorem1_residual(ref), rel=1e-4, abs=1e-7)


# --------------------------------------------------------------------------
# Subgraph approximation (App. A.5)
# --------------------------------------------------------------------------
def test_build_approx_views_equal_the_reference():
    r, _, p, _ = _both(_SMALL, hidden=8)
    for overhead, seed in ((0.10, 0), (0.3, 4)):
        ref = ref_views(r, ref_partition(r.graph, 4, method="random"),
                        overhead, seed)
        port = build_approx_views(p, partition_graph(p.graph, 4,
                                                     method="random"),
                                  overhead, seed)
        for (n1, g1, l1), (n2, g2, l2) in zip(port, ref):
            np.testing.assert_array_equal(n1, n2)
            np.testing.assert_array_equal(g1.indptr, g2.indptr)
            np.testing.assert_array_equal(g1.indices, g2.indices)
            assert l1 == l2


def test_run_subgraph_approx_matches_jax():
    r, rm, p, pm = _both(_SMALL, hidden=16)
    cfg = dict(_CFG, local_k=2, correction_steps=1, seed=6)
    ref = ref_subgraph(r, rm, R.DistConfig(**cfg))
    port = run_subgraph_approx(p, pm, C.DistConfig(**cfg), device="cpu")
    assert port.meta["storage_overhead_bytes"] == \
        ref.meta["storage_overhead_bytes"]
    assert port.meta["cfg"] == ref.meta["cfg"]
    _assert_trajectory(port, ref, 1.0 / len(p.val_nodes))


# --------------------------------------------------------------------------
# The quickstart and the exports
# --------------------------------------------------------------------------
def test_quickstart_bytes_equal_the_reference(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    quick = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quick)
    assert quick.main(["--device", "cpu"]) == 0
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        if line.split()[:1] in (["PSGD-PA"], ["LLCG"], ["GGS"]):
            rows.setdefault(line.split()[0], line.split())
    assert sorted(rows) == ["GGS", "LLCG", "PSGD-PA"]
    # the reference quickstart's plans, priced by its own accounting
    data, model, cfg = quick.setting()
    r = ref_sbm(num_nodes=600, num_classes=4, feature_dim=16,
                feature_snr=0.15, homophily=0.95, avg_degree=14, seed=0)
    rm = ref_build_model("GG", r.feature_dim, r.num_classes, hidden_dim=32)
    rcfg = R.DistConfig(**dataclasses.asdict(cfg))
    specs = rcfg.specs()
    ref_plans = (
        R.TrainPlan(phases=(R.local_steps(), R.averaging()),
                    name="PSGD-PA", seed=0, **specs),
        R.TrainPlan(phases=(R.local_steps(), R.averaging(), R.correction()),
                    name="LLCG", seed=0, **specs),
        R.TrainPlan(phases=(R.halo_exchange(),), name="GGS", seed=0,
                    **specs))
    for plan in ref_plans:
        want = sum(row["bytes"] for row in
                   R.build_trainer(r, rm, plan).accounting())
        assert float(rows[plan.name][3]) == want


def test_exports_are_the_references_ported_names():
    import repro.graph
    import repro.models.gnn
    import repro_torch.graph
    import repro_torch.models.gnn
    for ref, port in ((R, C), (repro.graph, repro_torch.graph),
                      (repro.models.gnn, repro_torch.models.gnn)):
        assert set(port.__all__) <= set(ref.__all__)
        assert all(hasattr(port, name) for name in port.__all__)
    for name in ("run_psgd_pa", "run_llcg", "run_ggs", "run_single_machine",
                 "DistConfig", "estimate_discrepancies", "theorem1_residual",
                 "build_trainer", "MachineStep", "make_machine_step",
                 "CheckpointSpec", "ResumePoint"):
        assert name in C.__all__
    for name in ("build_model", "sym_aggregate"):
        assert name in repro_torch.models.gnn.__all__
    for name in ("sbm_graph", "partition_graph", "cut_edge_stats",
                 # the device sampler, ported with the reference's names
                 "DeviceCSR", "build_device_csr", "sample_round_device",
                 "sample_serving_tables_device"):
        assert name in repro_torch.graph.__all__
