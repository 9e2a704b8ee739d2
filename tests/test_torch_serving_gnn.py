"""GNN serving in the port against the JAX package's ``repro.serving.gnn``,
and the stacked csr operands it runs on.

Inputs are the reference's own fixtures: a 16×16 grid graph (4 classes, 8
features, seed 0) served on 4 BFS machines with an ``SS`` model, a ``GAT``
model (fused and csr) on the same graph, and a degree-skewed R-MAT graph
(150 nodes, 600 edges, seed 3) for the stacked edge ops.  Params are the
JAX ``init(0)`` tree, which the port draws bit for bit.

Tolerances: host arrays (stacked edge operands, neighbor tables) exactly
equal; f32 aggregates and served logits 1e-5 (both sides sum the same
terms in another order); the serve-time correction 1e-4 (two optimizer
steps compound single-forward differences); predictions exactly equal.
Under the int8 halo codec the JAX package's jitted quantize scale may be
1 ulp off its oracle (ROADMAP Queue 3 quirk 1), which can move a value one
level: every exchanged value lies within one level (``max|row|/127``) of
the reference's, at most 1% beyond 1e-5, and so do the served logits
(1e-5 on at least 99% of the nodes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph.datasets import grid_graph as ref_grid
from repro.graph.datasets import rmat_graph as ref_rmat
from repro.graph.partition import partition_graph as ref_partition
from repro.models.gnn import agg as ref_agg
from repro.models.gnn.model import build_model as ref_build_model
from repro.serving import GNNRequest as RefRequest
from repro.serving import GNNServingEngine as RefEngine
from repro.serving.gnn import _halo_exchange as ref_halo_exchange

from repro_torch.graph.csr import build_neighbor_table
from repro_torch.graph.datasets import grid_graph, rmat_graph
from repro_torch.graph.halo import build_inference_plan
from repro_torch.graph.partition import partition_graph
from repro_torch.models.gnn import agg, layers
from repro_torch.models.gnn.model import build_model
from repro_torch.serving.gnn import (GNNRequest, GNNServingEngine,
                                     _halo_exchange)
from repro_torch.utils.pytree import tree_leaves

TOL = 1e-5
CORR_TOL = 1e-4
P = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# --------------------------------------------------------------------------
# §0: stacked edge operands with pad edges
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stacked():
    """Extended graphs of 4 machines of a skewed R-MAT graph: unequal edge
    counts, so every machine but the largest carries pad edges."""
    kw = dict(num_nodes=150, num_edges=600, feature_dim=12, num_classes=5,
              seed=3)
    r, p = ref_rmat(**kw), rmat_graph(**kw)
    part = partition_graph(p.graph, P, method="bfs", seed=0)
    plan = build_inference_plan(p.graph, part, 2)
    graphs = list(plan.ext_graphs)
    n_pad = max(g.num_nodes for g in graphs)
    rpart = ref_partition(r.graph, P, method="bfs", seed=0)
    from repro.graph.halo import build_inference_plan as ref_plan
    rgraphs = list(ref_plan(r.graph, rpart, 2).ext_graphs)
    counts = [g.num_edges for g in graphs]
    assert len(set(counts)) > 1, "fixture must carry pad edges"
    return graphs, rgraphs, n_pad


def test_stacked_edge_operands_bit_equal(stacked):
    graphs, rgraphs, n_pad = stacked
    ref = ref_agg.stacked_edge_operands(rgraphs, n_pad)
    seg, nbr, w, em = agg.stacked_edge_arrays(graphs, n_pad)
    for got, want in ((seg, ref.seg), (nbr, ref.nbr), (w, ref.w_mean),
                      (em, ref.emask)):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    ops = agg.stacked_edge_operands(graphs, n_pad, device="cpu")
    np.testing.assert_array_equal(ops.seg.numpy(), seg)
    assert (seg == n_pad).any() and ops.num_segments == n_pad


def test_pad_edges_fault_before_the_repair(stacked):
    """The pre-repair scatter (``index_add_`` into exactly num_segments
    rows) raises on a pad edge, where ``jax.ops.segment_sum`` drops it."""
    graphs, _, n_pad = stacked
    ops = agg.stacked_edge_operands(graphs, n_pad, device="cpu")
    h = torch.ones((n_pad, 3))
    with pytest.raises((IndexError, RuntimeError)):
        torch.zeros((n_pad, 3)).index_add_(0, ops.seg[0].clone().fill_(
            n_pad), h[:ops.seg.shape[1]])
    # the repaired op on one machine's (padded) operands drops them
    one = agg.EdgeCSR(seg=ops.seg[0], nbr=ops.nbr[0], w_mean=ops.w_mean[0],
                      emask=ops.emask[0], num_segments=n_pad)
    got = agg.csr_mean_aggregate(h, one)
    want = ref_agg.csr_mean_aggregate(
        jnp.ones((n_pad, 3)), ref_agg.EdgeCSR(
            seg=jnp.asarray(ops.seg[0].numpy(), jnp.int32),
            nbr=jnp.asarray(ops.nbr[0].numpy(), jnp.int32),
            w_mean=jnp.asarray(ops.w_mean[0].numpy()),
            emask=jnp.asarray(ops.emask[0].numpy()), num_segments=n_pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("op", ["mean", "sym", "gat"])
def test_stacked_csr_aggregates_match_jax(stacked, op):
    """The layers' csr branch over P stacked graphs (one flattened launch,
    pad edges to a sink) against the reference's ``vmap`` of its ops, in
    value and in every gradient."""
    graphs, rgraphs, n_pad = stacked
    d = 6
    rng = np.random.default_rng(11)
    h = rng.standard_normal((P, n_pad, d)).astype(np.float32)
    src = rng.standard_normal((P, n_pad)).astype(np.float32)
    dst = rng.standard_normal((P, n_pad)).astype(np.float32)
    nrm = rng.uniform(0.2, 1.0, (P, n_pad)).astype(np.float32)
    g = rng.standard_normal((P, n_pad, d)).astype(np.float32)
    ref_ops = ref_agg.stacked_edge_operands(rgraphs, n_pad)
    ops = agg.stacked_edge_operands(graphs, n_pad, device="cpu")

    def ref_fn(h, src, dst):
        def one(hh, s, t, nr, e):
            e = ref_agg.EdgeCSR(seg=e[0], nbr=e[1], w_mean=e[2], emask=e[3],
                                num_segments=n_pad)
            if op == "mean":
                return ref_agg.csr_mean_aggregate(hh, e)
            if op == "sym":
                return ref_agg.csr_sym_aggregate(hh, e, nr)
            return ref_agg.csr_gat_aggregate(hh, s, t, e)
        out = jax.vmap(one)(h, src, dst, jnp.asarray(nrm),
                            (ref_ops.seg, ref_ops.nbr, ref_ops.w_mean,
                             ref_ops.emask))
        return jnp.sum(out * g), out

    (_, want), grads = jax.value_and_grad(ref_fn, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst))
    th, ts, tt = (_t(x).requires_grad_(True) for x in (h, src, dst))
    aggo = agg.AggOperands("csr", edges=ops)
    if op == "mean":
        out = layers.mean_aggregate(th, None, None, agg=aggo)
    elif op == "sym":
        out = layers.sym_aggregate(th, None, None, _t(nrm), agg=aggo)
    else:
        flat = agg.flatten_stacked(ops)
        out = agg.csr_gat_aggregate(th.reshape(P * n_pad, d),
                                    ts.reshape(-1), tt.reshape(-1),
                                    flat).reshape(P, n_pad, d)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    (out * _t(g)).sum().backward()
    # the reference's csr GAT backward turns a pad edge of a machine whose
    # last row has no edge into inf · 0 = NaN (its shift is m[ns − 1] =
    # −1e30; ROADMAP Queue 3): the port's gradients are finite everywhere
    # and equal the reference's wherever those are
    pairs = [(th.grad, grads[0])]
    if op == "gat":
        pairs += [(ts.grad, grads[1]), (tt.grad, grads[2])]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert torch.isfinite(got).all()
        ok = np.isfinite(ref)
        assert ok.mean() > 0.9
        np.testing.assert_allclose(got.numpy()[ok], ref[ok], atol=TOL,
                                   rtol=TOL)


# --------------------------------------------------------------------------
# serving against repro.serving.gnn
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def grid():
    kw = dict(side=16, num_classes=4, feature_dim=8, seed=0)
    return ref_grid(**kw), grid_graph(**kw)


def _models(data, arch, **kw):
    args = (arch, data.feature_dim, data.num_classes)
    return (ref_build_model(*args, hidden_dim=16, **kw),
            build_model(*args, hidden_dim=16, **kw))


def _reqs(n_nodes, fanout, n=6, uid0=0, k=5):
    rng = np.random.default_rng(7 + uid0)
    return [dict(uid=uid0 + i, fanout=fanout, return_embeddings=True,
                 nodes=[int(x) for x in rng.integers(0, n_nodes, k)])
            for i in range(n)]


def _serve_both(grid, arch, reqs, model_kw=None, **kw):
    rdata, data = grid
    rmodel, model = _models(rdata, arch, **(model_kw or {}))
    params = model.init(0, device="cpu")
    ref = RefEngine(rmodel, rmodel.init(0), rdata, num_machines=P,
                    batch_size=4, seed=0, **kw)
    eng = GNNServingEngine(model, params, data, num_machines=P,
                           batch_size=4, seed=0, device="cpu", **kw)
    for r in reqs:
        ref.submit(RefRequest(**r))
        eng.submit(GNNRequest(**r))
    want = {r.uid: r for r in ref.run()}
    got = {r.uid: r for r in eng.run()}
    return want, got, ref, eng, params


SERVE_CASES = {
    "SS-full": ("SS", {}, None, {}),
    "SS-narrow": ("SS", {}, 2, {}),
    "SS-csr": ("SS", {}, None, {"agg_layout": "csr"}),
    "SS-auto-narrow": ("SS", {}, 3, {"agg_layout": "auto"}),
    "GAT-fused": ("GAT", {"fused_gat": True}, None, {}),
    "GAT-csr": ("GAT", {}, None, {"agg_layout": "csr"}),
    "GG-narrow": ("GG", {}, 2, {}),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_wave_serving_matches_jax(grid, case):
    arch, mkw, fanout, kw = SERVE_CASES[case]
    want, got, ref, eng, _ = _serve_both(
        grid, arch, _reqs(grid[1].num_nodes, fanout), model_kw=mkw, **kw)
    assert sorted(got) == sorted(want)
    for uid, w in want.items():
        g = got[uid]
        assert g.predictions == w.predictions, uid
        np.testing.assert_allclose(g.embeddings, w.embeddings, atol=TOL,
                                   rtol=TOL)
        assert (g.halo, g.corrected, g.wave) == (w.halo, w.corrected,
                                                 w.wave)
    rs, gs = ref.stats(), eng.stats()
    for key in ("waves", "served", "widths_compiled", "full_fanout",
                "num_hops", "exchange_bytes_per_wave", "exchange_bytes_cum",
                "nodes_served", "agg_layout", "num_retraces"):
        assert gs[key] == rs[key], key


def test_full_width_serving_equals_single_machine_forward(grid):
    """The reference's contract: full width reproduces the full-graph
    forward, halo-crossing queries included, through the stacked csr
    operands as through the padded tables."""
    rdata, data = grid
    _, model = _models(rdata, "SS")
    params = model.init(0, device="cpu")
    table, mask = build_neighbor_table(data.graph)
    full = model.apply(params, _t(data.features), _t(table),
                       _t(mask)).detach().numpy()
    for layout in ("padded", "csr"):
        eng = GNNServingEngine(model, params, data, num_machines=P,
                               batch_size=4, seed=0, device="cpu",
                               agg_layout=layout)
        cross = np.flatnonzero(eng.backend.crossing)[:5]
        inner = np.flatnonzero(~eng.backend.crossing)[:5]
        eng.submit(GNNRequest(uid=0, nodes=cross.tolist(),
                              return_embeddings=True))
        eng.submit(GNNRequest(uid=1, nodes=inner.tolist(),
                              return_embeddings=True))
        res = {r.uid: r for r in eng.run()}
        assert res[0].halo and not res[1].halo
        for r in res.values():
            np.testing.assert_allclose(r.embeddings, full[r.nodes],
                                       atol=TOL, rtol=TOL)
            assert r.predictions == list(full[r.nodes].argmax(-1))


def test_online_correction_matches_jax_and_keeps_params(grid):
    reqs = [dict(uid=1, nodes=[0, 17, 123], return_embeddings=True),
            dict(uid=2, nodes=[5, 200], return_embeddings=True)]
    want, got, _, eng, params = _serve_both(
        grid, "SS", reqs, correction_steps=2, server_lr=5e-2)
    stored = [x.clone() for x in tree_leaves(params)]
    for uid, w in want.items():
        assert got[uid].corrected and w.corrected
        np.testing.assert_allclose(got[uid].embeddings, w.embeddings,
                                   atol=CORR_TOL, rtol=CORR_TOL)
        assert got[uid].predictions == w.predictions
    # the refinement is wave-local: the engine's params are the stored
    # ones, unchanged, and a replay gives the same outputs
    for a, b in zip(tree_leaves(eng.params), stored):
        assert torch.equal(a, b)
    for r in reqs:
        eng.submit(GNNRequest(**r))
    again = {r.uid: r for r in eng.run()}
    for uid in got:
        np.testing.assert_array_equal(again[uid].embeddings,
                                      got[uid].embeddings)


def test_int8_halo_codec_within_one_level(grid):
    rdata, data = grid
    reqs = _reqs(data.num_nodes, None, n=4, k=40)
    want, got, ref, eng, _ = _serve_both(grid, "SS", reqs,
                                         halo_compression="int8")
    b, rb = eng.backend, ref.backend
    ext = _halo_exchange(b.feats, *b._halo_idx, compression="int8").numpy()
    rext = np.asarray(ref_halo_exchange(rb.feats, *rb._halo_idx,
                                        compression="int8"))
    raw = _halo_exchange(b.feats, *b._halo_idx).numpy()
    level = np.abs(raw).max(-1, keepdims=True) / 127
    diff = np.abs(ext - rext)
    assert (diff <= level + 1e-6).all()
    assert np.mean(diff > TOL) <= 0.01
    emb = np.concatenate([got[u].embeddings for u in sorted(want)])
    remb = np.concatenate([want[u].embeddings for u in sorted(want)])
    assert np.mean(np.abs(emb - remb).max(-1) > TOL) <= 0.01
    assert eng.stats()["exchange_bytes_cum"] == ref.stats()[
        "exchange_bytes_cum"]


@pytest.mark.parametrize("fanout", [None, 2])
def test_slot_serving_matches_jax_slot(grid, fanout):
    """The slot backend against the reference's slot backend (full width
    and a sampled bucket, whose tables come from the width-keyed
    generator), and at full width against the port's own wave path."""
    reqs = _reqs(grid[1].num_nodes, fanout, n=6, uid0=3)
    want, got, ref, eng, _ = _serve_both(grid, "SS", reqs, scheduler="slot",
                                         width_min=2)
    for uid, w in want.items():
        assert got[uid].predictions == w.predictions
        np.testing.assert_allclose(got[uid].embeddings, w.embeddings,
                                   atol=TOL, rtol=TOL)
    for key in ("forward_retraces", "exchange_runs", "bucket_widths_cached",
                "serve_steps", "steps"):
        assert eng.stats()[key] == ref.stats()[key], key
    if fanout is None:
        _, wave, _, _, _ = _serve_both(grid, "SS", reqs)
        assert {u: r.predictions for u, r in wave.items()} == \
            {u: r.predictions for u, r in got.items()}


def test_slot_determinism_and_retrace_bound(grid):
    """Predictions depend only on (seed, width bucket): admission order and
    pool size never change them; one forward per width bucket and one
    halo exchange."""
    rdata, data = grid
    _, model = _models(rdata, "SS")
    params = model.init(0, device="cpu")

    def serve(order, slots):
        eng = GNNServingEngine(model, params, data, num_machines=3,
                               batch_size=slots, seed=0, scheduler="slot",
                               width_min=2, device="cpu")
        reqs = _reqs(data.num_nodes, 2, n=4) + _reqs(data.num_nodes, None,
                                                     n=2, uid0=100)
        for i in order:
            eng.submit(GNNRequest(**reqs[i]))
        return {r.uid: r.predictions for r in eng.run()}, eng.stats()

    out_a, st_a = serve([0, 1, 2, 3, 4, 5], 4)
    out_b, st_b = serve([5, 3, 1, 4, 2, 0], 2)
    assert out_a == out_b
    for st in (st_a, st_b):
        assert st["forward_retraces"] == len(st["bucket_widths_cached"]) == 2
        assert st["exchange_runs"] == 1


def test_wave_retraces_bounded_by_width_buckets(grid):
    rdata, data = grid
    _, model = _models(rdata, "SS")
    eng = GNNServingEngine(model, model.init(0, device="cpu"), data,
                           num_machines=P, batch_size=4, seed=0,
                           device="cpu")
    rng = np.random.default_rng(1)
    for i, fo in enumerate([1, 2, 3, 4, 2, 1]):
        eng.submit(GNNRequest(uid=100 + i,
                              nodes=[int(rng.integers(data.num_nodes))],
                              fanout=fo))
    assert len(eng.run()) == 6
    widths = eng.backend.stats()["widths_compiled"]
    assert eng.backend.num_retraces == len(widths)
    assert all(w <= eng.backend.full_fanout for w in widths)


REFUSED = {
    "batch_stats_arch": (dict(arch="BSS"), {}, "batch statistics"),
    "bcsr_kernel": ({}, dict(agg_layout="bcsr_kernel"), "train-side"),
    "unknown_placement": ({}, dict(sampler_placement="tpu"),
                          "sampler_placement"),
    "slot_correction": ({}, dict(scheduler="slot", correction_steps=2),
                        "wave-scoped"),
    "halo_int8_ef": ({}, dict(halo_compression="int8_ef"),
                     "halo_compression"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(grid, case):
    rdata, data = grid
    mkw, kw, match = REFUSED[case]
    arch = mkw.get("arch", "SS")
    model = build_model(arch, data.feature_dim, data.num_classes,
                        hidden_dim=16)
    with pytest.raises(ValueError, match=match):
        GNNServingEngine(model, model.init(0, device="cpu"), data,
                         num_machines=P, device="cpu", **kw)


def test_device_sampler_option_runs(grid):
    """``sampler_placement="device"``, refused before the device sampler
    was ported, serves: at full width the device-drawn tables are the
    full neighbor tables, so predictions equal the host placement's."""
    reqs = _reqs(grid[1].num_nodes, None)
    _, host, _, _, _ = _serve_both(grid, "SS", reqs)
    _, dev, _, eng, _ = _serve_both(grid, "SS", reqs,
                                    sampler_placement="device")
    assert eng.stats()["sampler_placement"] == "device"
    assert {u: r.predictions for u, r in dev.items()} == \
        {u: r.predictions for u, r in host.items()}


def test_request_validation(grid):
    rdata, data = grid
    _, model = _models(rdata, "SS")
    eng = GNNServingEngine(model, model.init(0, device="cpu"), data,
                           num_machines=P, device="cpu")
    for bad in (dict(nodes=[]), dict(nodes=[data.num_nodes]),
                dict(nodes=[0], fanout=0)):
        with pytest.raises(ValueError):
            eng.submit(GNNRequest(uid=0, **bad))


def test_model_agg_layout_is_validated_and_read(grid):
    rdata, data = grid
    with pytest.raises(ValueError, match="agg_layout"):
        build_model("SS", 8, 4, agg_layout="dense")
    model = build_model("SS", data.feature_dim, data.num_classes,
                        hidden_dim=16, agg_layout="csr")
    eng = GNNServingEngine(model, model.init(0, device="cpu"), data,
                           num_machines=P, device="cpu")
    assert eng.backend.agg_layout == "csr"
    assert model.num_message_hops() == 2
    assert build_model("GAT", 8, 4).num_message_hops() == 2


def test_default_device_is_cuda(grid):
    _, data = grid
    model = build_model("SS", data.feature_dim, data.num_classes)
    import inspect
    sig = inspect.signature(GNNServingEngine.__init__)
    assert sig.parameters["device"].default == "cuda"
    sig = inspect.signature(GNNServingEngine.from_checkpoint)
    assert sig.parameters["device"].default == "cuda"
    assert model.agg_layout == "padded"


def test_serve_example_runs(capsys):
    """``examples/torch_serve_gnn.py`` trains, exports, serves wave then
    slot, and the two schedulers agree."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "torch_serve_gnn.py"
    spec = importlib.util.spec_from_file_location("torch_serve_gnn", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 10 queries" in out
    assert "slot predictions match the wave run: True" in out
