"""Per-kernel parity: the port's kernels against the JAX package's.

On the CPU every port kernel wrapper runs its plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode (``ops.*``) and its
oracle (``ref.*``).  All inputs come from numpy with a fixed seed.

Tolerance 1e-5 throughout: both sides compute in f32, and the sums (over
≤ max-degree neighbors for the SpMM, over ≤ F slots for the edge softmax)
are taken in a different order by the two frameworks.  The kernels
themselves are held against the plain versions on the card in
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph.datasets import rmat_graph as ref_rmat
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models.gnn import agg as ref_agg

from repro_torch.graph.datasets import rmat_graph
from repro_torch.kernels import ops
from repro_torch.kernels.edge_softmax import edge_softmax
from repro_torch.kernels.spmm import build_bcsr, spmm_bcsr
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
    cols, vals, n_pad = build_bcsr(pg.graph, normalization=norm)
    hp = np.pad(h, ((0, n_pad - pg.num_nodes), (0, 0)))
    _close(spmm_bcsr(torch.from_numpy(cols), torch.from_numpy(vals),
                     torch.from_numpy(hp)),
           ref_ref.spmm_bcsr_ref(jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(hp)))


def test_spmm_counts_no_launch_on_cpu(graphs):
    _, pg = graphs
    before = spmm_bcsr.launches
    ops.spmm_aggregate(pg.graph, torch.ones(pg.num_nodes, 4))
    assert spmm_bcsr.launches == before


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


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        edge_softmax(torch.zeros(4, 3), torch.zeros(4, 2),
                     torch.zeros(4, 3, 2))
    with pytest.raises(ValueError):
        spmm_bcsr(torch.zeros(2, 3, dtype=torch.int32),
                  torch.zeros(2, 4, 8, 128), torch.zeros(256, 4))
