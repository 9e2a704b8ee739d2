"""Host layer of the port against the JAX package: exact equality.

Graphs, partitions, sampled tables and batches, BCSR operands, the round
sampler's draws and the initial parameters are numpy in both packages,
drawn from the same ``np.random.Generator`` streams — so every array must
be ``np.array_equal``, not merely close.  The optimizers run the same f32
arithmetic and are held within 1e-6 per step (the two frameworks' f32
``pow``/``sqrt`` may round the last bit differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.plan import DistConfig as RefDistConfig
from repro.core.plan import RoundSampler as RefSampler
from repro.core.plan import lower_plan as ref_lower, llcg_plan as ref_llcg
from repro.core.schedules import KBucketing as RefKBucketing
from repro.data.graph_loader import make_shard_loaders as ref_loaders
from repro.data.graph_loader import sample_round as ref_sample_round
from repro.graph import csr as ref_csr
from repro.graph import datasets as ref_datasets
from repro.graph import partition as ref_partition
from repro.graph import sampling as ref_sampling
from repro.kernels.spmm import build_bcsr as ref_build_bcsr
from repro.models.gnn.model import build_model as ref_build_model
from repro.optim import optimizers as ref_optim
from repro.utils.pytree import tree_bytes as ref_tree_bytes

from repro_torch.convert import params_from_jax
from repro_torch.core.plan import DistConfig, RoundSampler, llcg_plan
from repro_torch.core.plan import lower_plan
from repro_torch.core.schedules import KBucketing
from repro_torch.data.graph_loader import make_shard_loaders, sample_round
from repro_torch.graph import csr, datasets, partition, sampling
from repro_torch.kernels.spmm import build_bcsr
from repro_torch.models.gnn.model import build_model
from repro_torch.optim import optimizers as optim
from repro_torch.utils.pytree import tree_bytes, tree_leaves


def _graph_equal(a, b):
    assert a.num_nodes == b.num_nodes
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)


@pytest.fixture(scope="module")
def pair():
    kw = dict(num_nodes=240, num_classes=6, feature_dim=16, avg_degree=10,
              homophily=0.9, feature_snr=0.3, seed=5)
    return ref_datasets.sbm_graph(**kw), datasets.sbm_graph(**kw)


@pytest.mark.parametrize("kind,kw", [
    ("sbm", dict(num_nodes=200, seed=1)),
    ("rmat", dict(num_nodes=150, num_edges=600, seed=2)),
    ("grid", dict(side=12, seed=3)),
])
def test_datasets_equal(kind, kw):
    r = ref_datasets.make_dataset(kind, **kw)
    p = datasets.make_dataset(kind, **kw)
    _graph_equal(r.graph, p.graph)
    for f in ("features", "labels", "train_nodes", "val_nodes", "test_nodes"):
        assert np.array_equal(getattr(r, f), getattr(p, f)), f


def test_neighbor_table_equal(pair):
    r, p = pair
    for md in (None, 4):
        rt, rm = ref_csr.build_neighbor_table(r.graph, md)
        pt, pm = csr.build_neighbor_table(p.graph, md)
        assert np.array_equal(rt, pt) and np.array_equal(rm, pm)


@pytest.mark.parametrize("method", ["random", "bfs", "spectral"])
def test_partition_equal(pair, method):
    r, p = pair
    rp = ref_partition.partition_graph(r.graph, 4, method=method, seed=7)
    pp = partition.partition_graph(p.graph, 4, method=method, seed=7)
    assert np.array_equal(rp.assignment, pp.assignment)
    for a, b in zip(rp.part_nodes, pp.part_nodes):
        assert np.array_equal(a, b)
    for a, b in zip(rp.local_graphs, pp.local_graphs):
        _graph_equal(a, b)
    assert ref_partition.cut_edge_stats(r.graph, rp.assignment) == \
        partition.cut_edge_stats(p.graph, pp.assignment)


@pytest.mark.parametrize("rng_compat", [False, True])
def test_sampled_tables_and_batches_equal(pair, rng_compat):
    r, p = pair
    rr, pr = np.random.default_rng(3), np.random.default_rng(3)
    nodes = np.arange(0, r.num_nodes, 3)
    a = ref_sampling.sample_neighbors(r.graph, nodes, 5, rr,
                                      rng_compat=rng_compat)
    b = sampling.sample_neighbors(p.graph, nodes, 5, pr,
                                  rng_compat=rng_compat)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    a = ref_sampling.sample_round_batched(r.graph, 3, 6, rr, n_pad=250,
                                          fanout_pad=8, rng_compat=rng_compat)
    b = sampling.sample_round_batched(p.graph, 3, 6, pr, n_pad=250,
                                      fanout_pad=8, rng_compat=rng_compat)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(
        ref_sampling.sample_minibatch_batched(r.train_nodes, 16, 4, rr),
        sampling.sample_minibatch_batched(p.train_nodes, 16, 4, pr))
    assert np.array_equal(ref_sampling.sample_minibatch(r.train_nodes, 8, rr),
                          sampling.sample_minibatch(p.train_nodes, 8, pr))


def test_shard_loaders_and_round_equal(pair):
    r, p = pair
    rp = ref_partition.partition_graph(r.graph, 3, method="random", seed=1)
    pp = partition.partition_graph(p.graph, 3, method="random", seed=1)
    rl, rs = ref_loaders(r, rp, fanout=6, seed=2)
    pl, ps = make_shard_loaders(p, pp, fanout=6, seed=2)
    n_max = max(len(x) for x in pp.part_nodes)
    a = ref_sample_round(rl, 4, 16, n_max, 6, np.random.default_rng(9))
    b = sample_round(pl, 4, 16, n_max, 6, np.random.default_rng(9))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(rs.minibatch(r.train_nodes, 8)[1],
                          ps.minibatch(p.train_nodes, 8)[1])


@pytest.mark.parametrize("norm", ["mean", "sym", "none"])
def test_build_bcsr_equal(pair, norm):
    r, p = pair
    a = ref_build_bcsr(r.graph, normalization=norm)
    b = build_bcsr(p.graph, normalization=norm)
    assert a[2] == b[2]
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("arch", ["SBSBS", "GG", "GAT", "APPNP", "BSBSBL",
                                  "GBGBG", "SSS"])
def test_init_params_bit_equal(arch):
    ref = jax.tree_util.tree_map(
        np.asarray, ref_build_model(arch, 16, 5, hidden_dim=12).init(3))
    port = build_model(arch, 16, 5, hidden_dim=12).init(3, device="cpu")
    assert ref.keys() == port.keys()
    for layer in ref:
        assert ref[layer].keys() == port[layer].keys()
        for name, a in ref[layer].items():
            b = port[layer][name].numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b)
    conv = params_from_jax(ref, device="cpu")
    assert all(torch.equal(conv[layer][name], port[layer][name])
               for layer in port for name in port[layer])
    assert tree_bytes(port) == ref_tree_bytes(ref)


def test_round_sampler_draws_equal(pair):
    """The plan layer's sampler consumes the RNG streams in the reference's
    order: local tables + batches, then the correction batches."""
    r, p = pair
    kw = dict(num_machines=3, rounds=2, local_k=3, correction_steps=2,
              batch_size=8, server_batch_size=16, fanout=5,
              partition_method="random", seed=4)
    rs = RefSampler(r, ref_build_model("GG", 16, 6, hidden_dim=8),
                    ref_llcg(RefDistConfig(**kw)))
    ps = RoundSampler(p, build_model("GG", 16, 6, hidden_dim=8),
                      llcg_plan(DistConfig(**kw)), "cpu")
    rplan, pplan = ref_lower(ref_llcg(RefDistConfig(**kw))), \
        lower_plan(llcg_plan(DistConfig(**kw)))
    for rd, pd in zip(rplan, pplan):
        a, b = rs.sample(rd), ps.sample(pd)
        for f in ("tables", "masks", "batches", "bmasks", "corr_batches",
                  "corr_bmasks", "corr_tables", "corr_masks"):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  getattr(b, f).numpy()), f
    assert np.array_equal(np.asarray(rs.feats), ps.feats.numpy())
    assert rs.param_bytes == ps.param_bytes


def test_k_bucketing_equal():
    sched = [3, 4, 6, 9, 13, 20, 30]
    assert RefKBucketing.fit(sched, min_len=3).lengths == \
        KBucketing.fit(sched, min_len=3).lengths
    assert RefKBucketing(min_len=3).bucket_lengths(sched) == \
        KBucketing(min_len=3).bucket_lengths(sched)


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                    "b": rng.standard_normal(3).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        for _ in range(3)]
    return params, grads


def _to_t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "sgd_momentum"])
def test_optimizer_steps_match(name):
    params, grads = _opt_inputs(1)
    ro, po = ref_optim.make_optimizer(name, 1e-2), \
        optim.make_optimizer(name, 1e-2)
    rp, pp = jax.tree_util.tree_map(jnp.asarray, params), _to_t(params)
    rs, ps = ro.init(rp), po.init(pp)
    for g in grads:
        ru, rs = ro.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        pu, ps = po.update(_to_t(g), ps, pp)
        rp, pp = ref_optim.apply_updates(rp, ru), optim.apply_updates(pp, pu)
        for a, b in zip(jax.tree_util.tree_leaves(rp), tree_leaves(pp)):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                       atol=1e-6)


def test_masked_update_is_a_bitwise_noop():
    params, grads = _opt_inputs(2)
    opt = optim.adam(1e-2)
    pp = _to_t(params)
    state = opt.init(pp)
    _, state = opt.update(_to_t(grads[0]), state, pp)
    upd, same = optim.masked_update(opt, _to_t(grads[1]), state, pp, 0.0)
    assert same is state and same.step == 1
    assert all(float(u.abs().max()) == 0.0 for u in tree_leaves(upd))
    upd, new = optim.masked_update(opt, _to_t(grads[1]), state, pp, 1.0)
    assert new.step == 2
