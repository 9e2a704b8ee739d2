"""Per-kernel parity: the port's kernels against the JAX package's.

On the CPU every port kernel wrapper runs its plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode (``ops.*``) and its
oracle (``ref.*``).  All inputs come from numpy with a fixed seed.

Tolerance 1e-5 throughout: both sides compute in f32, and the sums (over
≤ max-degree neighbors for the SpMM, over ≤ F slots for the edge softmax)
are taken in a different order by the two frameworks.  The port's SpMM takes
CSR operands; :func:`bcsr_to_csr` turns the JAX package's tiles into them,
exactly.  The kernels
themselves are held against the plain versions on the card in
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph.csr import CSRGraph as RefCSRGraph
from repro.graph.datasets import rmat_graph as ref_rmat
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.spmm import build_bcsr as ref_build_bcsr
from repro.models.gnn import agg as ref_agg

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.datasets import rmat_graph
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.edge_softmax import edge_softmax
from repro_torch.kernels.spmm import (SEGMENT, bcsr_to_csr, build_bcsr,
                                      build_csr, row_split, spmm_csr)
from repro_torch.models.gnn import agg

TOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    # degree-skewed, with zero-degree rows
    kw = dict(num_nodes=150, num_edges=600, feature_dim=12, num_classes=5,
              seed=3)
    return ref_rmat(**kw), rmat_graph(**kw)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _hub_graph_edges():
    """240 nodes: node 0 a hub joined to nodes 1..200 (above the kernel's
    row split), a ring over 1..29, rows 201..239 empty."""
    n = 240
    hub = np.arange(1, 201)
    ring = np.arange(1, 30)
    src = np.concatenate([np.zeros(200, np.int64), ring])
    dst = np.concatenate([hub, np.roll(ring, 1)])
    return n, src, dst


@pytest.fixture(scope="module")
def hub_graphs():
    n, src, dst = _hub_graph_edges()
    return RefCSRGraph.from_edges(n, src, dst), CSRGraph.from_edges(n, src,
                                                                    dst)


@pytest.mark.parametrize("norm", ["mean", "sym", "none"])
@pytest.mark.parametrize("d", [8, 20])
def test_spmm_plain_matches_reference(graphs, norm, d):
    rg, pg = graphs
    h = np.random.default_rng(d).standard_normal(
        (pg.num_nodes, d)).astype(np.float32)
    port = ops.spmm_aggregate(pg.graph, torch.from_numpy(h), norm)
    _close(port, ref_ops.spmm_aggregate(rg.graph, jnp.asarray(h), norm))
    _close(port, ref_ops.spmm_aggregate(rg.graph, jnp.asarray(h), norm,
                                        use_ref=True))
    # the reference's own tiles, converted, through the port's SpMM path
    cols, vals, n_pad = ref_build_bcsr(rg.graph, normalization=norm)
    csr = bcsr_to_csr(cols, vals, pg.num_nodes)
    hp = np.pad(h, ((0, n_pad - pg.num_nodes), (0, 0)))
    _close(spmm_csr(*map(torch.from_numpy, csr), torch.from_numpy(h)),
           ref_ref.spmm_bcsr_ref(jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(hp))[:pg.num_nodes])


@pytest.mark.parametrize("norm", ["none", "mean", "sym"])
def test_bcsr_to_csr_of_reference_tiles_is_the_graph_csr(graphs, hub_graphs,
                                                         norm):
    for rg, pg in ((graphs[0].graph, graphs[1].graph), hub_graphs):
        indptr, indices, values = bcsr_to_csr(
            *ref_build_bcsr(rg, normalization=norm)[:2], pg.num_nodes)
        want = build_csr(pg, norm)
        assert indptr.dtype == np.int32 and indices.dtype == np.int32
        np.testing.assert_array_equal(indptr, pg.indptr)
        np.testing.assert_array_equal(indices, pg.indices)
        np.testing.assert_array_equal(indptr, want[0])
        np.testing.assert_array_equal(indices, want[1])
        np.testing.assert_array_equal(values, want[2])


@pytest.mark.parametrize("norm", ["none", "mean", "sym"])
def test_port_tile_reference_matches_csr_path(hub_graphs, norm):
    """The port's own tile builder and tile contraction (the TPU kernel's
    format) against its CSR path on the same graph."""
    _, pg = hub_graphs
    h = np.random.default_rng(5).standard_normal(
        (pg.num_nodes, 6)).astype(np.float32)
    cols, vals, n_pad = build_bcsr(pg, normalization=norm)
    tiles = port_ref.spmm_bcsr_ref(
        torch.from_numpy(cols), torch.from_numpy(vals),
        torch.from_numpy(np.pad(h, ((0, n_pad - pg.num_nodes), (0, 0)))))
    csr = map(torch.from_numpy, bcsr_to_csr(cols, vals, pg.num_nodes))
    _close(spmm_csr(*csr, torch.from_numpy(h)), tiles[:pg.num_nodes])


@pytest.mark.parametrize("d", [8, 20])
def test_spmm_aggregate_matches_jax_with_empty_and_hub_rows(hub_graphs, d):
    rg, pg = hub_graphs
    assert pg.degrees()[30:].max() <= 1 and (pg.degrees() == 0).any()
    assert pg.max_degree() > SEGMENT
    h = np.random.default_rng(100 + d).standard_normal(
        (pg.num_nodes, d)).astype(np.float32)
    for norm in ("mean", "sym", "none"):
        _close(ops.spmm_aggregate(pg, torch.from_numpy(h), norm),
               ref_ops.spmm_aggregate(rg, jnp.asarray(h), norm))


def test_row_split_covers_each_row_in_segments(hub_graphs):
    _, pg = hub_graphs
    assert row_split(np.array([0, 3, 3, SEGMENT + 3])) is None
    items = row_split(pg.indptr)
    rows, lo = items
    deg = pg.degrees()
    assert items.dtype == np.int32
    assert items.shape[1] == pg.num_nodes + sum(
        -(-int(x) // SEGMENT) - 1 for x in deg if x > SEGMENT)
    for r in range(pg.num_nodes):
        mine = lo[rows == r]
        want = pg.indptr[r] + np.arange(max(1, -(-int(deg[r]) // SEGMENT))
                                        ) * SEGMENT
        np.testing.assert_array_equal(mine, want)


def test_spmm_counts_no_launch_on_cpu(graphs):
    _, pg = graphs
    before = spmm_csr.launches
    ops.spmm_aggregate(pg.graph, torch.ones(pg.num_nodes, 4))
    assert spmm_csr.launches == before


def test_spmm_autograd_matches_jax_grad(graphs):
    rg, pg = graphs
    rng = np.random.default_rng(0)
    h = rng.standard_normal((pg.num_nodes, 6)).astype(np.float32)
    w = rng.standard_normal((pg.num_nodes, 6)).astype(np.float32)
    rops = ref_agg.bcsr_operands(rg.graph)
    jgrad = jax.grad(lambda x: jnp.sum(
        ref_agg.bcsr_mean_aggregate(x, rops) * w))(jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    pops = agg.bcsr_operands(pg.graph, "cpu")
    out = agg.bcsr_mean_aggregate(x, pops)
    _close(out.detach(), ref_agg.bcsr_mean_aggregate(jnp.asarray(h), rops))
    (out * torch.from_numpy(w)).sum().backward()
    _close(x.grad, jgrad)


def test_bcsr_sym_aggregate_matches_reference(graphs):
    rg, pg = graphs
    rng = np.random.default_rng(1)
    h = rng.standard_normal((pg.num_nodes, 5)).astype(np.float32)
    nrm = rng.random(pg.num_nodes).astype(np.float32)
    _close(agg.bcsr_sym_aggregate(torch.from_numpy(h),
                                  agg.bcsr_operands(pg.graph, "cpu"),
                                  torch.from_numpy(nrm)),
           ref_agg.bcsr_sym_aggregate(jnp.asarray(h),
                                      ref_agg.bcsr_operands(rg.graph),
                                      jnp.asarray(nrm)))


def _esm_inputs(n, f, d, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, f)).astype(np.float32)
    m = (rng.random((n, f)) < 0.6).astype(np.float32)
    m[: max(1, n // 8)] = 0.0                    # fully masked rows
    v = rng.standard_normal((n, f, d)).astype(np.float32)
    return s, m, v


@pytest.mark.parametrize("n,f,d", [(13, 5, 7), (64, 10, 16), (40, 33, 8)])
def test_edge_softmax_plain_matches_reference(n, f, d):
    s, m, v = _esm_inputs(n, f, d, n)
    port = edge_softmax(*map(torch.from_numpy, (s, m, v)))
    _close(port, ref_ops.edge_softmax_aggregate(*map(jnp.asarray, (s, m, v))))
    _close(port, ref_ref.edge_softmax_ref(*map(jnp.asarray, (s, m, v))))
    assert float(port[: max(1, n // 8)].abs().max()) == 0.0


@pytest.mark.parametrize("n,f,d", [(13, 5, 7), (40, 33, 8)])
def test_edge_softmax_backward_matches_jax_vjp(n, f, d):
    s, m, v = _esm_inputs(n, f, d, 100 + n)
    g = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    _, vjp = jax.vjp(ref_ref.edge_softmax_ref, *map(jnp.asarray, (s, m, v)))
    js, _, jv = vjp(jnp.asarray(g))
    ts = torch.from_numpy(s).requires_grad_(True)
    tv = torch.from_numpy(v).requires_grad_(True)
    out = ops.edge_softmax_aggregate_trainable(ts, torch.from_numpy(m), tv)
    out.backward(torch.from_numpy(g))
    _close(ts.grad, js)
    _close(tv.grad, jv)


def test_edge_softmax_trainable_in_bf16_matches_jax():
    """bf16 operands through the fused GAT op: f32 inside, bf16 out and
    bf16 cotangents, as the JAX op; forward and both gradients within
    bf16's 2e-2 (masked slots and fully masked rows included)."""
    n, f, d = 16, 5, 8
    s, m, v = _esm_inputs(n, f, d, 160)
    g = np.random.default_rng(161).standard_normal((n, d)).astype(np.float32)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    jout, vjp = jax.vjp(ref_ops.edge_softmax_aggregate_trainable,
                        jb(s), jb(m), jb(v))
    js, _, jv = vjp(jb(g))
    assert jout.dtype == js.dtype == jv.dtype == jnp.bfloat16
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    ts, tv = tb(s).requires_grad_(True), tb(v).requires_grad_(True)
    out = ops.edge_softmax_aggregate_trainable(ts, tb(m), tv)
    out.backward(tb(g))
    assert out.dtype == ts.grad.dtype == tv.grad.dtype == torch.bfloat16
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    for port, ref in ((out, jout), (ts.grad, js), (tv.grad, jv)):
        _close(port.detach().float(), f32(ref), tol=2e-2)
    assert float(out.detach()[: n // 8].abs().max()) == 0.0


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        edge_softmax(torch.zeros(4, 3), torch.zeros(4, 2),
                     torch.zeros(4, 3, 2))
    indptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    indices = torch.tensor([1, 0], dtype=torch.int32)
    with pytest.raises(ValueError):
        spmm_csr(indptr, indices, torch.ones(3), torch.zeros(2, 4))


def test_edge_softmax_wrapper_refuses_non_f32_and_other_devices():
    s, m, v = (torch.from_numpy(a) for a in _esm_inputs(6, 4, 8, 0))
    assert edge_softmax(s, m, v).shape == (6, 8)
    for args in ((s.double(), m, v), (s, m.bool(), v), (s, m, v.half())):
        with pytest.raises(ValueError, match="float32"):
            edge_softmax(*args)
    with pytest.raises(ValueError, match="cpu or cuda"):
        edge_softmax(s.to("meta"), m.to("meta"), v.to("meta"))


def test_csr_wrapper_refuses_wrong_indptr_and_dtypes():
    indptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    indices = torch.tensor([1, 0], dtype=torch.int32)
    values, h = torch.ones(2), torch.zeros(2, 4)
    assert spmm_csr(indptr, indices, values, h).shape == (2, 4)
    with pytest.raises(ValueError, match="indptr"):       # N+1 vs h's rows
        spmm_csr(indptr[:2], indices, values, h)
    with pytest.raises(ValueError, match="indptr"):
        spmm_csr(indptr[None], indices, values, h)
    with pytest.raises(ValueError, match="int32"):
        spmm_csr(indptr.long(), indices, values, h)
    with pytest.raises(ValueError, match="int32"):
        spmm_csr(indptr, indices.long(), values, h)
    with pytest.raises(ValueError, match="float32"):
        spmm_csr(indptr, indices, values.double(), h)
    with pytest.raises(ValueError, match="items"):
        spmm_csr(indptr, indices, values, h, items=torch.zeros(
            2, 2, dtype=torch.int64))
