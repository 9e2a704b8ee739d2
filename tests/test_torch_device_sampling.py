"""The port's device sampler against the JAX package's, bit for bit, and
the device-placed plan, prefetch and serving paths that run on it.

The counterpart of ``tests/test_device_sampling.py``.  Both packages draw
from the documented ``jax.random`` stream (the port replays it with
``repro_torch.utils.threefry``), so the sampled tables, masks and batches
must be EQUAL — on a narrow graph (``dmax ≤ 128``: the reference's
pairwise-rank keys) and on one with a hub of degree over 128 and train
pools over 128 (its ``top_k`` keys, for tables and batches alike), and with
pools smaller than the batch (the with-replacement ``randint`` branch).

Device-placed trajectories are held to the slice's tolerances
(``tests/test_torch_slice.py``): losses and final parameters within 1e-4,
validation F1 within one eval node, byte and step accounting and the
sampler's retrace count equal.  Served predictions equal, logits within
1e-5 (``tests/test_torch_serving_gnn.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as R
from repro.graph import sampling as RS
from repro.graph.csr import CSRGraph as RefCSR
from repro.graph.datasets import grid_graph as ref_grid
from repro.graph.datasets import sbm_graph as ref_sbm
from repro.models.gnn.model import build_model as ref_build_model
from repro.serving import GNNRequest as RefRequest
from repro.serving import GNNServingEngine as RefEngine

from repro_torch.core import plan as P
from repro_torch.graph import sampling as S
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.datasets import grid_graph, sbm_graph
from repro_torch.models.gnn.model import build_model
from repro_torch.serving.gnn import GNNRequest, GNNServingEngine
from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_leaves

LOSS_TOL = 1e-4
SERVE_TOL = 1e-5

# name: (nodes, hub degree, train pool, batch, table width): a narrow graph
# drawn wider than its max degree (zero-padded columns), a hub of degree >
# 128 with pools > 128, and pools smaller than the batch
GRAPHS = {"narrow": (40, 0, 20, 8, 16), "hub": (300, 200, 150, 16, 7),
          "small_pool": (50, 0, 5, 8, 7)}


def _stacks(name, P_=3):
    n, hub, ntrain, batch, _ = GRAPHS[name]
    rng = np.random.default_rng(0)
    ref_g, port_g = [], []
    for p in range(P_):
        src = rng.integers(0, n, 3 * n)
        dst = rng.integers(0, n, 3 * n)
        if hub:
            src = np.concatenate([src, np.zeros(hub, np.int64)])
            dst = np.concatenate([dst, rng.choice(np.arange(1, n), hub,
                                                  replace=False)])
        m = n - p                        # unequal shard sizes: padded rows
        ref_g.append(RefCSR.from_edges(m, src % m, dst % m))
        port_g.append(CSRGraph.from_edges(m, src % m, dst % m))
    pools = [rng.choice(n - p, ntrain, replace=False) for p in range(P_)]
    fanouts = [5, 7, 6][:P_]
    ref = RS.build_device_csr(ref_g, n_pad=n, train_nodes=pools,
                              fanouts=fanouts, t_pad_min=batch)
    port = S.build_device_csr(port_g, n_pad=n, train_nodes=pools,
                              fanouts=fanouts, t_pad_min=batch, device="cpu")
    return ref, port, port_g, pools, fanouts, batch


# the reference's draws, jitted as its RoundSampler and serving engine run them
_ref_round = jax.jit(RS.sample_round_device,
                     static_argnames=("num_steps", "width", "batch_size"))
_ref_serving = jax.jit(RS.sample_serving_tables_device,
                       static_argnames=("width",))


def _keys(seed=3, r=2):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), r),
            threefry.fold_in(threefry.prng_key(seed), r))


def _assert_equal(want, got):
    for w, g in zip(want, got):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sample_round_device_matches_jax(name):
    ref, port, *_, batch = _stacks(name)
    assert port.dmax == ref.dmax
    if name == "hub":
        assert port.dmax > S._RANK_SELECT_MAX_WIDTH
        assert port.train_nodes.shape[1] > S._RANK_SELECT_MAX_WIDTH
    width = GRAPHS[name][4]
    assert (width > port.dmax) == (name == "narrow")
    key, tkey = _keys()
    _assert_equal(_ref_round(ref, key, num_steps=3, width=width,
                             batch_size=batch),
                  S.sample_round_device(port, tkey, 3, width, batch))


@pytest.mark.parametrize("name", ["narrow", "hub"])
def test_serving_tables_device_matches_jax(name):
    ref, port, *_ = _stacks(name)
    key, tkey = _keys(seed=11, r=0)
    for width in (3, port.dmax):
        _assert_equal(_ref_serving(ref, key, width=width),
                      S.sample_serving_tables_device(port, tkey, width))


def test_prefix_identity_under_k_bucketing():
    """Every step folds its own key: a draw at the bucketed length repeats
    the unbucketed draw on the real prefix."""
    _, port, *_, batch = _stacks("hub")
    _, tkey = _keys()
    short = S.sample_round_device(port, tkey, 3, 9, batch)
    long = S.sample_round_device(port, tkey, 8, 9, batch)
    for a, b in zip(short, long):
        assert torch.equal(a, b[:, :3])


def test_one_machine_shard_draws_its_slice_of_the_stack():
    """A shard_map rank's stack of one machine (global n_pad, t_pad, dmax)
    draws exactly that machine's slice of the full stack's draw."""
    _, port, graphs, pools, fanouts, batch = _stacks("hub")
    _, tkey = _keys()
    full = S.sample_round_device(port, tkey, 4, 9, batch)
    for p in range(len(graphs)):
        one = S.build_device_csr(
            graphs[p:p + 1], n_pad=port.n_pad, train_nodes=pools[p:p + 1],
            fanouts=fanouts[p:p + 1], t_pad_min=port.train_nodes.shape[1],
            device="cpu", machines=(p,), dmax=port.dmax)
        for a, b in zip(full, S.sample_round_device(one, tkey, 4, 9, batch)):
            assert torch.equal(a[p:p + 1], b)


# --------------------------------------------------------------------------
# device-placed plans
# --------------------------------------------------------------------------
def _cfg_kw(**over):
    kw = dict(num_machines=4, rounds=3, local_k=3, correction_steps=1,
              batch_size=16, server_batch_size=32, fanout=6, lr=1e-2,
              partition_method="random", seed=0)
    kw.update(over)
    return kw


DATA_KW = dict(num_nodes=240, num_classes=4, feature_dim=12, avg_degree=12,
               seed=0)


def _hybrid(pkg, cfg):
    return pkg.TrainPlan(
        phases=(pkg.halo_exchange(first=1), pkg.local_steps(after=1),
                pkg.averaging(after=1), pkg.correction(after=1)),
        name="hybrid", seed=cfg.seed, **cfg.specs())


PLANS = {
    "local": lambda pkg, cfg: pkg.llcg_plan(cfg),
    "hybrid": _hybrid,
    "full": lambda pkg, cfg: pkg.single_machine_plan(cfg),
}


def _device(plan, **smp):
    return dataclasses.replace(plan, sampler=dataclasses.replace(
        plan.sampler, placement="device", **smp))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_device_placed_trajectory_matches_jax(name):
    kw = _cfg_kw(rounds=2)
    if name == "local":     # K grows and is bucketed: drawn at the pad
        kw.update(rho=1.5, k_bucketing=True)
    ref = R.build_trainer(
        ref_sbm(**DATA_KW), ref_build_model("SBSBS", 12, 4, hidden_dim=16),
        _device(PLANS[name](R, R.DistConfig(**kw)))).run()
    port = P.build_trainer(
        sbm_graph(**DATA_KW), build_model("SBSBS", 12, 4, hidden_dim=16),
        _device(PLANS[name](P, P.DistConfig(**kw))), device="cpu").run()
    assert port.meta["sampler_placement"] == "device"
    assert port.meta["sampler_overlap"] is True
    assert port.steps_cum == ref.steps_cum
    assert port.bytes_cum == ref.bytes_cum
    for key in ("sampler_retraces", "masked_steps", "num_retraces"):
        assert port.meta[key] == ref.meta[key], key
    for key in ("local_loss", "corr_loss"):
        np.testing.assert_allclose(port.meta[key], ref.meta[key], rtol=0,
                                   atol=LOSS_TOL)
    np.testing.assert_allclose(port.train_loss, ref.train_loss, rtol=0,
                               atol=LOSS_TOL)
    n_val = int(0.2 * DATA_KW["num_nodes"])
    np.testing.assert_allclose(port.val_score, ref.val_score, rtol=0,
                               atol=1.0 / n_val + 1e-6)
    diff = max(float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b in
               zip(tree_leaves(port.meta["final_params"]),
                   jax.tree_util.tree_leaves(ref.meta["final_params"])))
    assert diff <= LOSS_TOL


@pytest.mark.parametrize("placement", ["host", "device"])
def test_overlap_is_bit_identical_to_synchronous(placement):
    """Prefetching round r+1 while round r runs changes nothing: the host
    streams draw in the same order, the device stream is stateless."""
    data = sbm_graph(**DATA_KW)
    model = build_model("SBSBS", 12, 4, hidden_dim=16)
    plan = P.llcg_plan(P.DistConfig(**_cfg_kw(rounds=2)))
    runs = []
    for overlap in (False, True):
        p = dataclasses.replace(plan, sampler=dataclasses.replace(
            plan.sampler, placement=placement, overlap=overlap))
        runs.append(P.build_trainer(data, model, p, device="cpu").run())
    a, b = runs
    assert a.meta["sampler_overlap"] is False and b.meta["sampler_overlap"]
    assert (a.train_loss, a.val_score, a.meta["local_loss"],
            a.meta["corr_loss"]) == (b.train_loss, b.val_score,
                                     b.meta["local_loss"],
                                     b.meta["corr_loss"])
    for x, y in zip(tree_leaves(a.meta["final_params"]),
                    tree_leaves(b.meta["final_params"])):
        assert torch.equal(x, y)


def test_device_placement_refuses_rng_compat():
    with pytest.raises(ValueError, match="rng_compat"):
        _device(P.llcg_plan(P.DistConfig(**_cfg_kw(rng_compat=True))))


# --------------------------------------------------------------------------
# serving on device-drawn tables
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scheduler", ["wave", "slot"])
def test_device_placed_serving_matches_jax(scheduler):
    kw = dict(side=16, num_classes=4, feature_dim=8, seed=0)
    rdata, data = ref_grid(**kw), grid_graph(**kw)
    args = ("SS", data.feature_dim, data.num_classes)
    rmodel = ref_build_model(*args, hidden_dim=16)
    model = build_model(*args, hidden_dim=16)
    opts = dict(num_machines=4, batch_size=4, seed=0, scheduler=scheduler,
                width_min=2, sampler_placement="device")
    ref = RefEngine(rmodel, rmodel.init(0), rdata, **opts)
    eng = GNNServingEngine(model, model.init(0, device="cpu"), data,
                           device="cpu", **opts)
    rng = np.random.default_rng(7)
    for i in range(8):
        req = dict(uid=i, fanout=(2, 3, None)[i % 3], return_embeddings=True,
                   nodes=[int(x) for x in rng.integers(0, data.num_nodes, 5)])
        ref.submit(RefRequest(**req))
        eng.submit(GNNRequest(**req))
    want = {r.uid: r for r in ref.run()}
    got = {r.uid: r for r in eng.run()}
    assert sorted(got) == sorted(want)
    for uid, w in want.items():
        assert got[uid].predictions == w.predictions, uid
        np.testing.assert_allclose(got[uid].embeddings, w.embeddings,
                                   atol=SERVE_TOL, rtol=SERVE_TOL)
    assert eng.stats()["sampler_placement"] == "device"
