"""The whole slice: ``build_trainer(data, model, plan).run()`` in the port
against the JAX package, 3 rounds, same seeds.

Config A is the paper's ``reddit`` plan (arch SBSBS) with the server
correction through the BCSR SpMM (``server_agg_layout="bcsr_kernel"``);
config B is the same plan on a fused GAT, whose every aggregation goes
through the edge-softmax kernel.  The ``llcg_int8*`` / ``psgd_pa_bf16``
configs compress the averaging deltas (the int8 ones round with the JAX
package's uniforms, injected through ``build_trainer(uniforms=...)``), and
the ``ggs*`` configs run the GGS baseline: the executed halo exchange
(``mode="halo"``), its int8-compressed form, and the host-materialized
halo (``mode="sync"``).  All are scaled down (fewer nodes and machines,
hidden width 16) to keep the CPU run short.

Tolerances: losses and final parameters within 1e-4 — the f32
differences of single forwards (1e-5, see test_torch_model.py) compound
over 3 rounds of Adam steps; validation F1 within one eval node — a logit
tie broken the other way flips one argmax; byte and step accounting
exactly equal.

Under int8 averaging a delta that lands within f32 noise of a rounding
boundary (or a row whose scale is the JAX kernel's, 1 ulp off its oracle —
test_torch_comm.py) rounds one level apart: the JAX package's own ±1
tolerance on ``q``.  Such a flip moves the average by at most one level,
``max|delta|/127 ≤ K·lr/127`` (Adam moves a parameter by at most about
``lr`` per step), and later Adam steps can amplify it on the few elements
whose gradient is near zero.  So there, at most 1% of the final parameters
may lie beyond 1e-4 plus one level per round, and none beyond the
``2·rounds·(K+S)·lr`` that two Adam trajectories can drift apart.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core import plan as R
from repro.core.plan import DistConfig as RefDistConfig
from repro.core.plan import build_trainer as ref_build_trainer
from repro.core.plan import ggs_plan as ref_ggs_plan
from repro.core.plan import llcg_plan as ref_llcg_plan
from repro.core.plan import psgd_pa_plan as ref_psgd_pa_plan
from repro.core.plan import single_machine_plan as ref_single_plan
from repro.graph.datasets import sbm_graph as ref_sbm
from repro.models.gnn.model import build_model as ref_build_model

from repro_torch.configs.gnn_datasets import SETTINGS
from repro_torch.core import plan as P
from repro_torch.graph.datasets import sbm_graph
from repro_torch.models.gnn.model import build_model
from repro_torch.utils.pytree import tree_leaves
from test_torch_comm import JaxUniforms

LOSS_TOL = 1e-4


def _setting(arch_kw):
    s = SETTINGS["reddit"]
    data_kw = dict(num_nodes=240, num_classes=s.num_classes,
                   feature_dim=s.feature_dim, avg_degree=12,
                   homophily=s.homophily, feature_snr=s.feature_snr, seed=0)
    cfg_kw = dict(num_machines=4, rounds=3, local_k=s.local_k,
                  correction_steps=s.correction_steps, batch_size=16,
                  server_batch_size=32, fanout=10, lr=1e-2,
                  partition_method="random", seed=0)
    arch, model_kw = arch_kw
    model_args = (arch, s.feature_dim, s.num_classes)
    return data_kw, cfg_kw, model_args, {"hidden_dim": 16, **model_kw}


# name: ((arch, model kw), DistConfig overrides, canned plan, CommSpec codecs)
CONFIGS = {
    "A": (("SBSBS", {}), {"server_agg_layout": "bcsr_kernel"}, "llcg", {}),
    "B": (("GAT", {"fused_gat": True}), {"server_agg_layout": "bcsr_kernel"},
          "llcg", {}),
    "psgd_pa": (("GG", {}), {}, "psgd_pa", {}),
    "llcg_bucketed": (("SBSBS", {}), {"rho": 1.5, "k_bucketing": True},
                      "llcg", {}),
    # full-graph sampling on one machine, optimizer state kept across rounds
    "single": (("GG", {}), {}, "single", {}),
    "llcg_int8": (("SBSBS", {}), {}, "llcg", {"compression": "int8"}),
    "llcg_int8_ef": (("SBSBS", {"hidden_dim": 24}),
                     {"server_agg_layout": "bcsr_kernel"}, "llcg",
                     {"compression": "int8_ef"}),
    "psgd_pa_bf16": (("GG", {}), {}, "psgd_pa", {"compression": "bf16"}),
    "ggs": (("SBSBS", {}), {}, "ggs", {}),
    "ggs_host_halo": (("GG", {}), {"ggs_host_halo": True}, "ggs", {}),
    "ggs_int8": (("SBSBS", {}), {}, "ggs", {"halo_compression": "int8"}),
    # one GGS round, then LLCG rounds: two engine programs in one plan
    "hybrid": (("SBSBS", {}), {}, "hybrid", {}),
}


def _hybrid(pkg):
    def plan(cfg):
        return pkg.TrainPlan(
            phases=(pkg.halo_exchange(first=1), pkg.local_steps(after=1),
                    pkg.averaging(after=1), pkg.correction(after=1)),
            name="hybrid", seed=cfg.seed, **cfg.specs())
    return plan


def _with_comm(plan, comm):
    return dataclasses.replace(plan,
                               comm=dataclasses.replace(plan.comm, **comm))


def _run_both(name):
    arch_kw, cfg_over, plan_name, comm = CONFIGS[name]
    data_kw, cfg_kw, model_args, model_kw = _setting(arch_kw)
    cfg_kw.update(cfg_over)
    ref_plan = {"llcg": ref_llcg_plan, "psgd_pa": ref_psgd_pa_plan,
                "ggs": ref_ggs_plan, "single": ref_single_plan,
                "hybrid": _hybrid(R)}[plan_name]
    port_plan = {"llcg": P.llcg_plan, "psgd_pa": P.psgd_pa_plan,
                 "ggs": P.ggs_plan, "single": P.single_machine_plan,
                 "hybrid": _hybrid(P)}[plan_name]
    ref = ref_build_trainer(ref_sbm(**data_kw),
                            ref_build_model(*model_args, **model_kw),
                            _with_comm(ref_plan(RefDistConfig(**cfg_kw)),
                                       comm)).run()
    # stochastic rounding: round with the JAX package's uniforms
    kw = ({"uniforms": JaxUniforms}
          if comm.get("compression") in ("int8", "int8_ef") else {})
    port = P.build_trainer(sbm_graph(**data_kw),
                           build_model(*model_args, **model_kw),
                           _with_comm(port_plan(P.DistConfig(**cfg_kw)),
                                      comm),
                           device="cpu", **kw).run()
    return ref, port, data_kw, cfg_kw


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trajectory_matches_reference(name):
    ref, port, data_kw, cfg = _run_both(name)
    assert port.rounds == ref.rounds == [1, 2, 3]
    assert port.steps_cum == ref.steps_cum
    assert port.bytes_cum == ref.bytes_cum
    for key in ("local_loss", "corr_loss"):
        np.testing.assert_allclose(port.meta[key], ref.meta[key], rtol=0,
                                   atol=LOSS_TOL)
    assert port.meta["corr_rounds"] == ref.meta["corr_rounds"]
    np.testing.assert_allclose(port.train_loss, ref.train_loss, rtol=0,
                               atol=LOSS_TOL)
    n_val = int(0.2 * data_kw["num_nodes"])
    np.testing.assert_allclose(port.val_score, ref.val_score, rtol=0,
                               atol=1.0 / n_val + 1e-6)
    for key in ("num_retraces", "num_corr_retraces", "masked_steps",
                "param_bytes", "corr_agg_layout", "cut_stats"):
        assert port.meta[key] == ref.meta[key], key
    for key in ("halo_executed", "halo_bytes_per_step",
                "exchange_bytes_per_step", "halo_max_send", "halo_max_halo"):
        assert port.meta.get(key) == ref.meta.get(key), key
    ours = tree_leaves(port.meta["final_params"])
    theirs = jax.tree_util.tree_leaves(ref.meta["final_params"])
    assert len(ours) == len(theirs)
    diff = np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                           for a, b in zip(ours, theirs)])
    R, K, S, lr = (len(port.rounds), cfg["local_k"],
                   cfg["correction_steps"], cfg["lr"])
    if CONFIGS[name][3].get("compression", "").startswith("int8"):
        assert np.mean(diff > LOSS_TOL + R * K * lr / 127) <= 0.01
        assert diff.max() <= 2 * R * (K + S) * lr
    else:
        assert diff.max() <= LOSS_TOL


def test_accounting_without_running():
    _, cfg_kw, model_args, model_kw = _setting(("SBSBS", {}))
    plan = P.llcg_plan(P.DistConfig(**cfg_kw))
    trainer = P.build_trainer(None, build_model(*model_args, **model_kw),
                              plan, device="cpu")
    rows = trainer.accounting()
    pb = sum(int(np.prod(a.shape)) * 4 for layer in
             build_model(*model_args, **model_kw).init_numpy(0).values()
             for a in layer.values())
    assert [r["bytes"] for r in rows] == [2.0 * 4 * pb] * 3
    assert [r["steps"] for r in rows] == [4 * cfg_kw["local_k"]] * 3


def test_default_device_is_cuda():
    _, cfg_kw, model_args, model_kw = _setting(("GG", {}))
    trainer = P.build_trainer(None, build_model(*model_args, **model_kw),
                              P.psgd_pa_plan(P.DistConfig(**cfg_kw)))
    assert trainer.device == torch.device("cuda")


def _run_sharded(mesh, data, model, plan):
    return P.build_trainer(data, model, plan, backend="shard_map",
                           mesh=mesh).run()


_SAMPLER_OPTIONS = {
    "device_sampler": dict(placement="device"),
    "overlap": dict(overlap=True),
    "shard_map": {},
}


@pytest.mark.parametrize("option", sorted(_SAMPLER_OPTIONS))
def test_sampler_and_backend_options_run(option):
    """The options refused before the device sampler and the
    device-per-machine backend were ported now run, and train as the
    host-placed, synchronous vmap run does (the device stream draws other
    samples, so its run is held to the same accounting only)."""
    from repro_torch.launch.mesh import launch_machines
    data = sbm_graph(num_nodes=60, num_classes=3, feature_dim=8, seed=0)
    model = build_model("GG", data.feature_dim, data.num_classes,
                        hidden_dim=8)
    base = P.psgd_pa_plan(P.DistConfig(num_machines=2, rounds=2))
    plan = dataclasses.replace(base, sampler=dataclasses.replace(
        base.sampler, **_SAMPLER_OPTIONS[option]))
    if option == "shard_map":
        hist = launch_machines(_run_sharded, 2, data, model, plan,
                               device="cpu")
    else:
        hist = P.build_trainer(data, model, plan, device="cpu").run()
    ref = P.build_trainer(data, model, base, device="cpu").run()
    assert hist.rounds == [1, 2] and hist.bytes_cum == ref.bytes_cum
    assert hist.meta["sampler_placement"] == plan.sampler.placement
    assert hist.meta["sampler_overlap"] == plan.sampler.resolved_overlap
    if option != "device_sampler":
        np.testing.assert_allclose(hist.train_loss, ref.train_loss,
                                   rtol=0, atol=LOSS_TOL)


_CHECKPOINT_OPTIONS = {
    "checkpoint": lambda d: P.TrainPlan(
        phases=(P.local_steps(), P.averaging()),
        comm=P.CommSpec(num_machines=2), schedule=P.ScheduleSpec(rounds=2),
        checkpoint=P.CheckpointSpec(dir=str(d))),
    "checkpoint_dir": lambda d: P.psgd_pa_plan(P.DistConfig(
        num_machines=2, rounds=2, checkpoint_dir=str(d))),
}


@pytest.mark.parametrize("option", sorted(_CHECKPOINT_OPTIONS))
def test_checkpoint_options_run(option, tmp_path):
    """The options refused before checkpointing was ported now run: a
    ``CheckpointSpec`` writes committed full-state checkpoints, a
    ``checkpoint_dir`` exports each round's params."""
    import os
    data = sbm_graph(num_nodes=60, num_classes=3, feature_dim=8, seed=0)
    model = build_model("GG", data.feature_dim, data.num_classes,
                        hidden_dim=8)
    plan = _CHECKPOINT_OPTIONS[option](tmp_path)
    hist = P.build_trainer(data, model, plan, device="cpu").run()
    assert hist.rounds == [1, 2]
    want = ({"ckpt_1.npz", "ckpt_1.json", "ckpt_2.npz", "ckpt_2.json"}
            if option == "checkpoint" else {"step_1.npz", "step_2.npz"})
    assert set(os.listdir(tmp_path)) == want


_INVALID_COMM = {
    # error feedback needs a persistent residual that halo buffers lack
    "halo_int8_ef": dict(compression="int8_ef", halo_compression="int8_ef"),
    # the host-materialized halo never crosses the compressed exchange
    "host_halo_compressed": dict(host_halo=True, halo_compression="int8"),
}


@pytest.mark.parametrize("case", sorted(_INVALID_COMM))
def test_invalid_codec_combinations_are_refused(case):
    with pytest.raises(ValueError, match="halo_compression"):
        P.CommSpec(**_INVALID_COMM[case])
