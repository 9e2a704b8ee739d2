"""The ``csr`` aggregation layout in the port: edge-centric segment sums
against the padded path and against the JAX package's ``csr_*`` ops, and
the server correction through ``build_trainer`` with
``server_agg_layout`` in {padded, csr, auto} against the reference.

Inputs are the reference's own fixtures: a degree-skewed R-MAT graph with
zero-degree rows (150 nodes, 600 edges, seed 3) for the ops, and
``rmat_graph(160, 700, seed=5)`` for the 2-round plans.

Tolerances: f32 ops 1e-5 (both sides sum the same terms in another
order); bf16 2e-2 (``tests/test_kernels.py``'s bf16 tolerance); 2-round
trajectories 1e-4 (single-forward differences compound over the Adam
steps) with validation F1 within one eval node.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.plan import DistConfig as RefDistConfig
from repro.core.plan import build_trainer as ref_build_trainer
from repro.core.plan import llcg_plan as ref_llcg_plan
from repro.graph.csr import build_neighbor_table as ref_table
from repro.graph.csr import symmetric_normalizers as ref_nrm
from repro.graph.datasets import rmat_graph as ref_rmat
from repro.models.gnn import agg as ref_agg
from repro.models.gnn import layers as ref_layers
from repro.models.gnn.model import build_model as ref_build_model

from repro_torch.core import plan as P
from repro_torch.graph.datasets import rmat_graph
from repro_torch.models.gnn import agg, layers
from repro_torch.models.gnn.model import build_model

TOL = 1e-5
BF16_TOL = 2e-2
LOSS_TOL = 1e-4


@pytest.fixture(scope="module")
def skewed():
    kw = dict(num_nodes=150, num_edges=600, feature_dim=12, num_classes=5,
              seed=3)
    r, p = ref_rmat(**kw), rmat_graph(**kw)
    assert (p.graph.degrees() == 0).any(), "fixture must cover deg-0 rows"
    np.testing.assert_array_equal(p.graph.indices, r.graph.indices)
    table, mask = ref_table(r.graph)
    nrm = ref_nrm(r.graph).astype(np.float32)
    return r, p, table, mask, nrm


def _t(a, dtype=None):
    x = torch.from_numpy(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _port_op(op, edges, nrm):
    """The port's csr op as a function of (z, src, dst) tensors."""
    return {"mean": lambda z, s, d: agg.csr_mean_aggregate(z, edges),
            "sym": lambda z, s, d: agg.csr_sym_aggregate(z, edges, nrm),
            "gat": lambda z, s, d: agg.csr_gat_aggregate(z, s, d, edges)}[op]


def _value_and_grads(fn, arrays, dtype=torch.float32):
    xs = [_t(a, dtype).requires_grad_(True) for a in arrays]
    out = fn(*xs)
    grads = torch.autograd.grad((out.float() ** 2).sum(), xs,
                                allow_unused=True)
    return out, [torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads)]


def _padded(op, table, mask, nrm):
    """The padded path of the same op, one graph as a stack of 1."""
    t, m = _t(table)[None], _t(mask)[None]
    if op == "mean":
        return lambda z, s, d: layers.mean_aggregate(z[None], t, m)[0]
    if op == "sym":
        return lambda z, s, d: layers.sym_aggregate(z[None], t, m,
                                                    _t(nrm)[None])[0]

    def gat(z, s, d):
        e = torch.nn.functional.leaky_relu(s[:, None] + d[_t(table).long()],
                                           0.2)
        e = torch.where(_t(mask) > 0, e, torch.full_like(e, -1e30))
        alpha = torch.softmax(e, dim=-1) * _t(mask)
        return torch.einsum("nf,nfd->nd", alpha, z[_t(table).long()])
    return gat


@pytest.mark.parametrize("op", ["mean", "sym", "gat"])
def test_csr_ops_match_padded_forward_and_gradient(skewed, op):
    _, p, table, mask, nrm = skewed
    edges = agg.edge_operands(p.graph, device="cpu")
    arrays = _inputs(p.num_nodes)
    out, grads = _value_and_grads(_port_op(op, edges, _t(nrm)), arrays)
    ref, ref_grads = _value_and_grads(_padded(op, table, mask, nrm), arrays)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    for g, rg in zip(grads, ref_grads):
        torch.testing.assert_close(g, rg, rtol=TOL, atol=TOL)


def _jax_op(op, edges, nrm):
    return {"mean": lambda z, s, d: ref_agg.csr_mean_aggregate(z, edges),
            "sym": lambda z, s, d: ref_agg.csr_sym_aggregate(z, edges, nrm),
            "gat": lambda z, s, d: ref_agg.csr_gat_aggregate(z, s, d,
                                                             edges)}[op]


@pytest.mark.parametrize("op", ["mean", "sym", "gat"])
def test_csr_ops_match_jax_forward_and_gradient(skewed, op):
    r, p, _, _, nrm = skewed
    arrays = _inputs(p.num_nodes, seed=1)
    fn = _jax_op(op, ref_agg.edge_operands(r.graph), jnp.asarray(nrm))
    j_out = fn(*arrays)
    j_grads = jax.grad(lambda *xs: (fn(*xs) ** 2).sum(),
                       argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    out, grads = _value_and_grads(
        _port_op(op, agg.edge_operands(p.graph, device="cpu"), _t(nrm)),
        arrays)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=TOL, atol=TOL)
    for g, jg in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("op", ["mean", "sym", "gat"])
def test_csr_zero_degree_rows_are_exactly_zero(skewed, op):
    _, p, _, _, nrm = skewed
    zero = np.flatnonzero(p.graph.degrees() == 0)
    fn = _port_op(op, agg.edge_operands(p.graph, device="cpu"), _t(nrm))
    out = fn(*map(_t, _inputs(p.num_nodes, seed=2)))
    assert torch.isfinite(out).all()
    assert float(out[_t(zero)].abs().max()) == 0.0


@pytest.mark.parametrize("op", ["mean", "sym", "gat"])
def test_csr_ops_in_bf16_match_jax(skewed, op):
    r, p, _, _, nrm = skewed
    arrays = _inputs(p.num_nodes, seed=3)
    fn = _jax_op(op, ref_agg.edge_operands(r.graph), jnp.asarray(nrm))
    j_out = fn(*(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    out = _port_op(op, agg.edge_operands(p.graph, device="cpu"), _t(nrm))(
        *(_t(a, torch.bfloat16) for a in arrays))
    assert out.dtype == torch.bfloat16 and j_out.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("layout", ["padded", "csr", "bcsr_kernel"])
def test_sym_aggregate_on_every_layout_matches_jax(skewed, layout):
    r, p, table, mask, nrm = skewed
    h = _inputs(p.num_nodes, seed=4)[0]
    ref = ref_layers.sym_aggregate(jnp.asarray(h), jnp.asarray(table),
                                   jnp.asarray(mask), jnp.asarray(nrm))
    out = layers.sym_aggregate(
        _t(h)[None], _t(table)[None], _t(mask)[None], _t(nrm)[None],
        agg=agg.build_agg_operands(p.graph, layout, "cpu"))[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_edge_operands_are_cached_per_graph_and_device(skewed):
    _, p, *_ = skewed
    g = p.graph
    cpu = agg.edge_operands(g, device="cpu")
    assert agg.edge_operands(g, device="cpu") is cpu
    assert agg.build_agg_operands(g, "csr", "cpu").edges is cpu
    assert agg.edge_operands(g, num_segments=g.num_nodes + 8,
                             device="cpu") is not cpu
    meta = agg.edge_operands(g, device="meta")
    assert meta is not cpu and meta.seg.device.type == "meta"
    assert agg.edge_operands(g, device="meta") is meta
    assert cpu.seg.dtype == cpu.nbr.dtype == torch.int64
    assert int(cpu.seg.shape[0]) == g.num_edges == int(cpu.w_mean.shape[0])


def test_csr_with_correction_sampling_is_refused():
    with pytest.raises(ValueError, match="correction_sampling"):
        P.ServerSpec(agg_layout="csr", correction_sampling=True)
    assert P.ServerSpec(agg_layout="csr").agg_layout == "csr"


# --------------------------------------------------------------------------
# The correction through the plan API, port against the reference
# --------------------------------------------------------------------------
_PLAN_DATA = dict(num_nodes=160, num_edges=700, feature_dim=10,
                  num_classes=4, seed=5)
_PLAN_CFG = dict(num_machines=2, rounds=2, local_k=2, batch_size=16,
                 server_batch_size=16, correction_steps=2, fanout=5,
                 partition_method="random", seed=0)


@pytest.fixture(scope="module")
def plan_hists():
    r, p = ref_rmat(**_PLAN_DATA), rmat_graph(**_PLAN_DATA)
    args = ("GGL", r.feature_dim, r.num_classes)
    rm, pm = ref_build_model(*args, hidden_dim=8), build_model(*args,
                                                                hidden_dim=8)
    hists = {}
    for lay in ("padded", "csr", "auto"):
        ref = ref_build_trainer(r, rm, ref_llcg_plan(RefDistConfig(
            server_agg_layout=lay, **_PLAN_CFG))).run()
        port = P.build_trainer(p, pm, P.llcg_plan(P.DistConfig(
            server_agg_layout=lay, **_PLAN_CFG)), device="cpu").run()
        hists[lay] = (ref, port)
    return hists, 1.0 / len(p.val_nodes)


@pytest.mark.parametrize("layout", ["padded", "csr", "auto"])
def test_llcg_plan_layout_matches_jax(plan_hists, layout):
    hists, one_node = plan_hists
    ref, port = hists[layout]
    assert port.meta["corr_agg_layout"] == ref.meta["corr_agg_layout"]
    assert port.meta["corr_agg_layout"] == ("padded" if layout == "padded"
                                            else "csr")
    for key in ("local_loss", "corr_loss"):
        np.testing.assert_allclose(port.meta[key], ref.meta[key],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(port.train_loss, ref.train_loss,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(port.val_score, ref.val_score, rtol=0,
                               atol=one_node + 1e-9)
    assert port.bytes_cum == ref.bytes_cum
    assert port.steps_cum == ref.steps_cum


def test_csr_correction_trajectory_equals_padded_in_the_port(plan_hists):
    hists, _ = plan_hists
    pad = hists["padded"][1]
    for lay in ("csr", "auto"):
        np.testing.assert_allclose(hists[lay][1].train_loss, pad.train_loss,
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(hists[lay][1].meta["corr_loss"],
                                   pad.meta["corr_loss"], rtol=TOL, atol=TOL)
