"""The CUDA and Triton kernels against their plain versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one; they import no JAX, so they run on a GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.datasets import rmat_graph
from repro_torch.kernels import ops, ref
from repro_torch.kernels.edge_softmax import edge_softmax
from repro_torch.kernels.spmm import spmm_bcsr

# edge softmax: weights ≤ 1 on unit-scale values, f32 sums over ≤ F slots
ESM_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph():
    # degree-skewed, with zero-degree rows
    return rmat_graph(num_nodes=150, num_edges=600, feature_dim=12,
                      num_classes=5, seed=3).graph


def _esm_inputs(n, f, d, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, f)).astype(np.float32)
    m = (rng.random((n, f)) < 0.6).astype(np.float32)
    m[: max(1, n // 8)] = 0.0                    # fully masked rows
    v = rng.standard_normal((n, f, d)).astype(np.float32)
    return s, m, v


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 64, 100])
def test_spmm_kernel_matches_plain_on_card(graph, cuda, d):
    cols, vals, n_pad = ops.bcsr_device_operands(graph, cuda,
                                                 normalization="none")
    h = torch.randn(graph.num_nodes, d, device=cuda)
    before = spmm_bcsr.launches
    out = spmm_bcsr(cols, vals, h)
    assert spmm_bcsr.launches == before + 1
    plain = ref.spmm_bcsr_ref(cols, vals, torch.nn.functional.pad(
        h, (0, 0, 0, n_pad - graph.num_nodes)))
    # f32 sums of ≤ max-degree unit-scale terms in another order
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,d", [(13, 5, 7), (800, 10, 64), (800, 57, 8)])
def test_edge_softmax_kernel_matches_plain_on_card(cuda, n, f, d):
    s, m, v = (torch.from_numpy(a).to(cuda) for a in _esm_inputs(n, f, d, 7))
    before = edge_softmax.launches
    out = edge_softmax(s, m, v)
    assert edge_softmax.launches == before + 1
    torch.testing.assert_close(out, ref.edge_softmax_ref(s, m, v),
                               rtol=ESM_TOL, atol=ESM_TOL)
    assert float(out[: max(1, n // 8)].abs().max()) == 0.0


@pytest.mark.gpu
def test_spmm_backward_launches_the_kernel_on_card(graph, cuda):
    """The BCSR aggregation's backward is the same kernel on the
    cotangent: one launch forward, one backward."""
    from repro_torch.models.gnn import agg
    ops_ = agg.bcsr_operands(graph, cuda)
    x = torch.randn(graph.num_nodes, 16, device=cuda, requires_grad=True)
    before = spmm_bcsr.launches
    agg.bcsr_mean_aggregate(x, ops_).sum().backward()
    assert spmm_bcsr.launches == before + 2
    xc = x.detach().cpu().requires_grad_(True)
    agg.bcsr_mean_aggregate(xc, agg.bcsr_operands(graph, "cpu")).sum() \
        .backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-5, atol=1e-4)
