"""The whole slice: ``build_trainer(data, model, plan).run()`` in the port
against the JAX package, 3 rounds, same seeds.

Config A is the paper's ``reddit`` plan (arch SBSBS) with the server
correction through the BCSR SpMM (``server_agg_layout="bcsr_kernel"``);
config B is the same plan on a fused GAT, whose every aggregation goes
through the edge-softmax kernel.  Both are scaled down (fewer nodes and
machines, hidden width 16) to keep the CPU run short.

Tolerances: losses within 1e-4 — the f32 differences of single forwards
(1e-5, see test_torch_model.py) compound over 3 rounds of Adam steps;
validation F1 within one eval node — a logit tie broken the other way
flips one argmax; byte and step accounting exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.plan import DistConfig as RefDistConfig
from repro.core.plan import build_trainer as ref_build_trainer
from repro.core.plan import llcg_plan as ref_llcg_plan
from repro.core.plan import psgd_pa_plan as ref_psgd_pa_plan
from repro.core.plan import single_machine_plan as ref_single_plan
from repro.graph.datasets import sbm_graph as ref_sbm
from repro.models.gnn.model import build_model as ref_build_model

from repro_torch.configs.gnn_datasets import SETTINGS
from repro_torch.core import plan as P
from repro_torch.graph.datasets import sbm_graph
from repro_torch.models.gnn.model import build_model

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
    return data_kw, cfg_kw, model_args, dict(hidden_dim=16, **model_kw)


CONFIGS = {
    "A": (("SBSBS", {}), {"server_agg_layout": "bcsr_kernel"}, "llcg"),
    "B": (("GAT", {"fused_gat": True}), {"server_agg_layout": "bcsr_kernel"},
          "llcg"),
    "psgd_pa": (("GG", {}), {}, "psgd_pa"),
    "llcg_bucketed": (("SBSBS", {}), {"rho": 1.5, "k_bucketing": True},
                      "llcg"),
    # full-graph sampling on one machine, optimizer state kept across rounds
    "single": (("GG", {}), {}, "single"),
}


def _run_both(name):
    arch_kw, cfg_over, plan_name = CONFIGS[name]
    data_kw, cfg_kw, model_args, model_kw = _setting(arch_kw)
    cfg_kw.update(cfg_over)
    ref_plan = {"llcg": ref_llcg_plan, "psgd_pa": ref_psgd_pa_plan,
                "single": ref_single_plan}[plan_name]
    port_plan = {"llcg": P.llcg_plan, "psgd_pa": P.psgd_pa_plan,
                 "single": P.single_machine_plan}[plan_name]
    ref = ref_build_trainer(ref_sbm(**data_kw),
                            ref_build_model(*model_args, **model_kw),
                            ref_plan(RefDistConfig(**cfg_kw))).run()
    port = P.build_trainer(sbm_graph(**data_kw),
                           build_model(*model_args, **model_kw),
                           port_plan(P.DistConfig(**cfg_kw)),
                           device="cpu").run()
    return ref, port, data_kw


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trajectory_matches_reference(name):
    ref, port, data_kw = _run_both(name)
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


_REFUSED = {
    "halo_exchange": lambda: P.TrainPlan(
        phases=(P.RoundPhase("halo_exchange"),)),
    "compression": lambda: P.CommSpec(compression="int8"),
    "halo_compression": lambda: P.CommSpec(halo_compression="bf16"),
    "host_halo": lambda: P.DistConfig(ggs_host_halo=True),
    "checkpoint": lambda: P.TrainPlan(
        phases=(P.local_steps(), P.averaging()),
        checkpoint=P.CheckpointSpec(dir="ck")),
    "checkpoint_dir": lambda: P.llcg_plan(P.DistConfig(checkpoint_dir="ck")),
    "device_sampler": lambda: P.SamplerSpec(placement="device"),
    "overlap": lambda: P.SamplerSpec(overlap=True),
    "shard_map": lambda: P.build_trainer(
        None, None, P.llcg_plan(P.DistConfig()), backend="shard_map"),
    "csr_layout": lambda: P.DistConfig(server_agg_layout="csr"),
}


@pytest.mark.parametrize("option", sorted(_REFUSED))
def test_unported_options_are_refused_with_their_roadmap_item(option):
    with pytest.raises(ValueError, match=r"ROADMAP Queue 1 item \d+"):
        _REFUSED[option]()
