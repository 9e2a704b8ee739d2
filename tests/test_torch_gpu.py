"""The CUDA kernels against their plain versions, on the card.

The int8 quantize/dequantize kernels are held bit-equal (correctly rounded
divisions on both sides); the SpMM, edge softmax and chunked linear scan
within f32 tolerances.

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
from repro_torch.kernels.linear_scan import linear_scan_chunked
from repro_torch.kernels.quantize import dequantize_rows, quantize_rows
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.spmm import (SEGMENT, SlabPlan, _launch,
                                      pack_slabs, row_split, slab_plan,
                                      spmm_csr)

# edge softmax: weights ≤ 1 on unit-scale values, f32 sums over ≤ F slots
ESM_TOL = 1e-5
# linear scan: f32 sums in another order (tests/test_kernels.py's tolerance)
SCAN_TOL = 2e-4


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


@pytest.fixture(scope="module")
def hub_graph():
    """A 3,000-node R-MAT graph (with empty rows) plus two hubs far above
    the kernel's row split, each joined to 700 random nodes."""
    rng = np.random.default_rng(5)
    base = rmat_graph(num_nodes=3000, num_edges=9000, feature_dim=4,
                      num_classes=2, seed=4).graph
    src, dst = base.to_edges()
    hubs = np.repeat([7, 1234], 700)
    return CSRGraph.from_edges(3000, np.concatenate([src, hubs]),
                               np.concatenate([dst, rng.integers(0, 3000,
                                                                 1400)]))


def _esm_inputs(n, f, d, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, f)).astype(np.float32)
    m = (rng.random((n, f)) < 0.6).astype(np.float32)
    m[: max(1, n // 8)] = 0.0                    # fully masked rows
    v = rng.standard_normal((n, f, d)).astype(np.float32)
    return s, m, v


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["slice", "hub"])
@pytest.mark.parametrize("d", [8, 30, 64, 100, 128, 256])
def test_spmm_kernel_matches_plain_on_card(graph, hub_graph, cuda, d, which):
    """The CSR kernel straight from H (D % 4 == 0) and from its slab-major
    copy (D % 4 != 0), one and two column slabs, on a graph with empty rows
    and one whose hubs take the row split."""
    g = graph if which == "slice" else hub_graph
    indptr, indices, values, items = ops.csr_device_operands(
        g, cuda, normalization="none")
    assert (items is not None) == (g.max_degree() > SEGMENT)
    h = torch.randn(g.num_nodes, d, device=cuda)
    before = spmm_csr.launches
    out = spmm_csr(indptr, indices, values, h, items)
    assert spmm_csr.launches == before + 1
    plain = ref.spmm_csr_ref(indptr, indices, values, h)
    # f32 sums of ≤ max-degree unit-scale terms in another order
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-4)
    # the same order every run: no atomics on the sums
    assert torch.equal(out, spmm_csr(indptr, indices, values, h, items))
    if items is not None:         # one group per row gives the same result
        torch.testing.assert_close(spmm_csr(indptr, indices, values, h),
                                   plain, rtol=1e-5, atol=1e-4)


def _slab_operands(n: int, seed: int, device):
    """CSR operands of an n-row matrix: ~4 nonzeros a row at random
    columns, three hubs past the row split (129, 300 and 700 nonzeros),
    every 17th row empty; values unit-scale."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n)
    deg[::17] = 0
    deg[[1, n // 2, n - 1]] = [129, 300, 700]
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    cols = cols[np.lexsort((cols, rows))]
    vals = rng.standard_normal(nnz).astype(np.float32)
    items = row_split(indptr)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (indptr, cols, vals, items))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [256, 602])
@pytest.mark.parametrize("n", [120_000, 240_000, 500_000])
def test_spmm_column_slabs_match_plain_on_card(cuda, n, d):
    """Past half of the L2 the launch makes one pass per 32-float slab,
    from the slab-major copy where a row is no whole number of lines: it
    matches the plain version, with split and empty rows, and its sums
    equal bit for bit those of the lane split (one pass straight from H, as
    where H fits) and of the packed slabs on the same columns."""
    indptr, indices, values, items = _slab_operands(n, n + d, cuda)
    h = torch.randn(n, d, device=cuda)
    plan = slab_plan(n, d, h.data_ptr())
    assert plan.width == 32 and plan.slabs == -(-d // 32)
    assert plan.packed == (d % 32 != 0)
    before = spmm_csr.launches, spmm_csr.slab_passes
    out = spmm_csr(indptr, indices, values, h, items)
    assert (spmm_csr.launches, spmm_csr.slab_passes) == \
        (before[0] + 1, before[1] + plan.slabs)
    plain = ref.spmm_csr_ref(indptr, indices, values, h)
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-4)
    w = d - d % 4                   # the columns the lane split can take
    lanes = _launch(SlabPlan(32, -(-w // 128), False), indptr, indices,
                    values, h[:, :w].contiguous(), items)
    assert torch.equal(out[:, :w], lanes)
    packed = SlabPlan(8, plan.slabs, True)
    assert torch.equal(out, _launch(packed, indptr, indices, values, h,
                                    items))
    assert torch.equal(out, spmm_csr(indptr, indices, values, h, items))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(7, 602), (1000, 37), (5000, 256),
                                 (240_000, 602)])
def test_pack_kernel_equals_plain_on_card(cuda, n, d):
    """The pack kernel writes the plain version's slab-major copy, zeros
    past D."""
    h = torch.randn(n, d, device=cuda)
    slabs = -(-d // 32)
    assert torch.equal(pack_slabs(h, slabs),
                       pack_slabs(h.cpu(), slabs).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("n,f,d", [
    (13, 5, 7), (800, 10, 64), (800, 10, 8), (800, 57, 64), (800, 57, 8),
    (50, 200, 64), (30, 200, 8), (40, 20, 100), (9, 3, 256)])
def test_edge_softmax_kernel_matches_plain_on_card(cuda, n, f, d, aligned):
    """Config B's four shapes, F past the 64 slots whose weights stay in
    registers, D of 7 and 100 (idle lanes) and 256 (two column slabs),
    and vals whose data does not start 16-byte aligned (the scalar
    path)."""
    s, m, v = (torch.from_numpy(a).to(cuda) for a in _esm_inputs(n, f, d, 7))
    if not aligned:                  # the same values one float further on
        v = torch.cat([v.new_zeros(1), v.flatten()])[1:].view(n, f, d)
    before = edge_softmax.launches
    out = edge_softmax(s, m, v)
    assert edge_softmax.launches == before + 1
    torch.testing.assert_close(out, ref.edge_softmax_ref(s, m, v),
                               rtol=ESM_TOL, atol=ESM_TOL)
    assert float(out[: max(1, n // 8)].abs().max()) == 0.0
    # a fixed order of sums: the same bits on every call
    assert torch.equal(out, edge_softmax(s, m, v))
    assert edge_softmax.launches == before + 2


@pytest.mark.gpu
def test_spmm_backward_launches_the_kernel_on_card(graph, cuda):
    """The SpMM aggregation's backward is the same kernel on the
    cotangent: one launch forward, one backward."""
    from repro_torch.models.gnn import agg
    ops_ = agg.bcsr_operands(graph, cuda)
    x = torch.randn(graph.num_nodes, 16, device=cuda, requires_grad=True)
    before = spmm_csr.launches
    agg.bcsr_mean_aggregate(x, ops_).sum().backward()
    assert spmm_csr.launches == before + 2
    xc = x.detach().cpu().requires_grad_(True)
    agg.bcsr_mean_aggregate(xc, agg.bcsr_operands(graph, "cpu")).sum() \
        .backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("with_u", [True, False], ids=["u", "half_up"])
@pytest.mark.parametrize("r,c", [(1, 7), (5, 33), (37, 128), (130, 65),
                                 (8, 4096), (8, 2048), (8, 512), (8, 64),
                                 (8, 8), (800, 32), (3, 1000), (65536, 256),
                                 (2, 300000), (3, 70001)])
def test_quantize_kernels_bit_equal_plain_on_card(cuda, r, c, with_u):
    """Every averaging shape of the main path, the halo shape, scalar
    widths, and rows longer than the loads held in registers ((2, 300000);
    (3, 70001) on scalar loads), whose excess is streamed."""
    rng = np.random.default_rng(r * 1000 + c)
    x = torch.from_numpy((rng.standard_normal((r, c)) * 3.0).astype(
        np.float32)).to(cuda)
    x[0, : c // 2] = 0.0                         # a half-zero row
    u = (torch.from_numpy(rng.random((r, c)).astype(np.float32)).to(cuda)
         if with_u else None)
    before = (quantize_rows.launches, dequantize_rows.launches)
    q, s = quantize_rows(x, u)
    deq = dequantize_rows(q, s)
    assert (quantize_rows.launches, dequantize_rows.launches) == (
        before[0] + 1, before[1] + 1)
    qr, sr = ref.quantize_int8_rows_ref(x, u)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(deq, ref.dequantize_int8_rows_ref(qr, sr))
    # and the CPU plain version agrees bit for bit
    qc, sc = ref.quantize_int8_rows_ref(x.cpu(), None if u is None
                                        else u.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)


@pytest.mark.gpu
@pytest.mark.parametrize("with_u", [True, False], ids=["u", "half_up"])
@pytest.mark.parametrize("r,c", [(8, 4096), (800, 32), (8, 64)])
def test_quantize_kernel_bit_equal_on_unaligned_views_on_card(cuda, r, c,
                                                              with_u):
    """x and u starting one float past a 16-byte boundary take the scalar
    loads (quantize.geometry with vec4=False), still bit-equal."""
    rng = np.random.default_rng(c)
    base = torch.from_numpy((rng.standard_normal(r * c + 1) * 3.0).astype(
        np.float32)).to(cuda)
    x = base[1:].view(r, c)
    u = (torch.from_numpy(rng.random(r * c + 1).astype(np.float32)).to(cuda)
         [1:].view(r, c) if with_u else None)
    assert x.data_ptr() % 16 != 0
    before = quantize_rows.launches
    q, s = quantize_rows(x, u)
    assert quantize_rows.launches == before + 1
    qr, sr = ref.quantize_int8_rows_ref(x, u)
    assert torch.equal(q, qr) and torch.equal(s, sr)


def _grouped_operands(shapes, cuda, seed):
    """int8 payloads in [-127, 127] and positive f32 scales for (R, C)
    ``shapes``, on the card."""
    rng = np.random.default_rng(seed)
    qs = [torch.from_numpy(rng.integers(-127, 128, (r, c)).astype(np.int8))
          .to(cuda) for r, c in shapes]
    ss = [torch.from_numpy((rng.random((r, 1)) * 3e-2 + 1e-9).astype(
        np.float32)).to(cuda) for r, _ in shapes]
    return qs, ss


# config C's round (8 machines x 13 leaves), rows of 1, 8, 17 and 33
# values, empty segments, and more segments than a launch's table holds
_GROUPED = {
    "round": [(8, 4096)] * 2 + [(8, 2048)] * 2 + [(8, 512)] * 2
             + [(8, 64)] * 6 + [(8, 8)],
    "awkward": [(5, 1), (8, 8), (3, 17), (7, 33), (1, 1), (700, 300),
                (65536, 256)],
    "empty": [(0, 5), (3, 0), (4, 17), (0, 0), (2, 16)],
    "split": [(i % 5 + 1, 3 + 7 * i) for i in range(70)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_GROUPED))
def test_grouped_dequantize_bit_equal_plain_on_card(cuda, name):
    """One launch per MAX_SEGMENTS non-empty segments (1 for C's 13-leaf
    round), each result bit-equal to the plain version and contiguous."""
    from repro_torch.kernels import quantize
    shapes = _GROUPED[name]
    qs, ss = _grouped_operands(shapes, cuda, len(shapes))
    live = sum(1 for r, c in shapes if r * c)
    want = -(-live // quantize.MAX_SEGMENTS)
    assert want == (1 if name != "split" else 3)
    before = dequantize_rows.launches
    outs = quantize.dequantize_rows_many(qs, ss)
    assert dequantize_rows.launches == before + want
    for q, s, out in zip(qs, ss, outs):
        assert out.shape == q.shape and out.is_contiguous()
        assert torch.equal(out, ref.dequantize_int8_rows_ref(q, s))


@pytest.mark.gpu
def test_grouped_dequantize_bit_equal_on_unaligned_views_on_card(cuda):
    """A q starting one byte past a 16-byte boundary (byte loads), a
    non-contiguous q[:, 1:] (copied first) and aligned ones in one call."""
    from repro_torch.kernels import quantize
    qs, ss = _grouped_operands([(8, 4097), (9, 40), (3, 33)], cuda, 3)
    flat = torch.cat([qs[0].new_zeros(1), qs[2].flatten()])
    odd = flat[1:].view(3, 33)
    assert odd.data_ptr() % 16 != 0 and torch.equal(odd, qs[2])
    views = [qs[0][:, 1:], qs[1], odd]
    before = dequantize_rows.launches
    outs = quantize.dequantize_rows_many(views, ss)
    assert dequantize_rows.launches == before + 1
    for q, s, out in zip(views, ss, outs):
        assert torch.equal(out, ref.dequantize_int8_rows_ref(q, s))


@pytest.mark.gpu
def test_grouped_dequantize_raises_on_a_refused_launch(cuda, monkeypatch):
    """A table whose tile counts do not match its segments is refused by
    the C entry; the wrapper raises and counts nothing."""
    import ctypes
    from repro_torch.kernels import quantize
    qs, ss = _grouped_operands([(8, 4096), (8, 64)], cuda, 4)
    quantize.dequantize_rows_many(qs, ss)            # built and loaded
    plan = quantize._plan((qs[0].shape, qs[1].shape),
                          (ss[0].shape, ss[1].shape))
    bad = plan._replace(launches=(((0, 1), (ctypes.c_int * 4)(8, 4096, 8, 64),
                                   (ctypes.c_int * 3)(0, 1, 2)),))
    # 8 x 4096 values take 8 tiles, not 1
    monkeypatch.setattr(quantize, "_plan", lambda *args: bad)
    before = dequantize_rows.launches
    with pytest.raises(RuntimeError, match="dequantize_rows kernel launch"):
        quantize.dequantize_rows_many(qs, ss)
    assert dequantize_rows.launches == before


@pytest.mark.gpu
def test_halo_fill_drops_padded_slots_on_card(cuda):
    """The padded destinations point one past the buffer: the sink row
    keeps the CUDA scatter in bounds."""
    from repro_torch.core.machine import halo_fill
    feats = torch.randn(2, 5, 3, device=cuda)
    gathered = torch.randn(4, 3, device=cuda)
    recv = torch.tensor([[1, 0], [3, 2]], device=cuda)
    dest = torch.tensor([[4, 5], [3, 4]], device=cuda)      # 5 = padding
    valid = torch.tensor([[1.0, 0.0], [1.0, 1.0]], device=cuda)
    out = halo_fill(feats, gathered, recv, dest, valid)
    torch.cuda.synchronize()
    want = feats.clone()
    want[0, 4], want[1, 3], want[1, 4] = gathered[1], gathered[3], gathered[2]
    assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("bh,t,dk,dv,chunk,with_h0", [
    (2, 64, 8, 16, 16, False), (3, 128, 16, 24, 32, True),
    (4, 256, 64, 64, 64, True), (5, 77, 64, 64, 64, False),
    (3, 50, 32, 48, 16, True), (2, 33, 64, 64, 1, True),
    (3, 70, 20, 30, 24, True), (2, 61, 64, 64, 64, False),
    (128, 192, 64, 64, 64, False), (128, 77, 64, 64, 64, False),
    (512, 2048, 64, 64, 64, True), (224, 1024, 64, 64, 64, True)])
def test_linear_scan_kernel_matches_plain_on_card(cuda, bh, t, dk, dv, chunk,
                                                  with_h0, strict):
    """Both conventions, ragged T (masked in the kernel), odd widths, one
    and two dv slabs, chunks below 64 and chip_smoke.py's four shapes,
    against the plain chunked form on the card."""
    rng = np.random.default_rng(bh * 1000 + t)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    q, k, v = f(bh, t, dk), f(bh, t, dk), f(bh, t, dv)
    lw = torch.from_numpy((-0.15 * rng.random((bh, t, dk))).astype(
        np.float32)).to(cuda)
    h0 = f(bh, dk, dv) if with_h0 else None
    u = f(bh, dk) * 0.3 if strict else None
    before = linear_scan_chunked.launches
    y, h = ops.linear_scan(q, k, v, lw, h0, chunk=chunk, strict=strict, u=u)
    torch.cuda.synchronize()
    assert linear_scan_chunked.launches == before + 1
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, -t % chunk))
    y_r, h_r = ref.chunked_scan_ref(pad(q), pad(k), pad(v), pad(lw), h0,
                                    chunk=chunk, strict=strict, u=u)
    y_r = y_r[:, :t]
    tol = SCAN_TOL * max(1.0, float(y_r.abs().max()))
    torch.testing.assert_close(y, y_r, rtol=0, atol=tol)
    tol = SCAN_TOL * max(1.0, float(h_r.abs().max()))
    torch.testing.assert_close(h, h_r, rtol=0, atol=tol)
    y_c, h_c = ops.linear_scan(q.cpu(), k.cpu(), v.cpu(), lw.cpu(),
                               None if h0 is None else h0.cpu(),
                               chunk=chunk, strict=strict,
                               u=None if u is None else u.cpu())
    torch.testing.assert_close(y.cpu(), y_c, rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("decay,finite", [(1.0, True), (1.5, False)])
def test_linear_scan_kernel_overflows_where_the_reference_does(cuda, decay,
                                                               finite):
    """P⁻¹ = 1/P overflows f32 where the reference's exp(−cumsum log_w)
    does: finite at −1.0 per step over a 64-step chunk, not at −1.5."""
    rng = np.random.default_rng(3)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    q, k, v = f(2, 128, 64), f(2, 128, 64), f(2, 128, 64)
    lw = torch.full_like(q, -decay)
    u = f(2, 64) * 0.3
    y, h = linear_scan_chunked(q, k, v, lw, u=u, chunk=64, strict=True)
    y_r, _ = ref.chunked_scan_ref(q, k, v, lw, chunk=64, strict=True, u=u)
    assert bool(torch.isfinite(y).all()) is finite
    assert bool(torch.isfinite(y_r).all()) is finite


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [0.15, 3.0], ids=["mild", "strong"])
@pytest.mark.parametrize("bh,t,dk,dv,chunk,with_h0", [
    (2, 64, 8, 16, 16, False), (3, 128, 16, 24, 32, True),
    (5, 77, 64, 64, 64, False), (3, 70, 20, 30, 24, True),
    (2, 33, 64, 64, 1, True), (448, 192, 64, 64, 64, False),
    (448, 77, 64, 64, 64, True)])
def test_linear_scan_scalar_decay_kernel_matches_plain_on_card(
        cuda, bh, t, dk, dv, chunk, with_h0, decay):
    """The scalar-decay mode (log_w of shape (BH, T), Mamba2's) against its
    plain segsum form on the card and against the sequential recurrence,
    at odd widths, ragged T, chunks below 64 and zamba2's prefill shapes;
    at −3 per step a 64-step chunk sums past the factored form's overflow
    and both stay finite."""
    rng = np.random.default_rng(bh * 1000 + t + 7)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    q, k, v = f(bh, t, dk), f(bh, t, dk), f(bh, t, dv)
    lw = torch.from_numpy((-decay * rng.random((bh, t))).astype(
        np.float32)).to(cuda) if decay < 1 else torch.full(
            (bh, t), -decay, device=cuda)
    h0 = f(bh, dk, dv) if with_h0 else None
    before = linear_scan_chunked.launches
    y, h = ops.linear_scan(q, k, v, lw, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert linear_scan_chunked.launches == before + 1
    pad = -t % chunk
    y_r, h_r = ref.chunked_scan_scalar_ref(
        torch.nn.functional.pad(q, (0, 0, 0, pad)),
        torch.nn.functional.pad(k, (0, 0, 0, pad)),
        torch.nn.functional.pad(v, (0, 0, 0, pad)),
        torch.nn.functional.pad(lw, (0, pad)), h0, chunk=chunk)
    y_r = y_r[:, :t]
    y_s, h_s = ref.linear_scan_batched_ref(q, k, v, lw[:, :, None].expand(
        bh, t, dk), h0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    for got, want in ((y, y_r), (h, h_r), (y, y_s), (h, h_s)):
        tol = SCAN_TOL * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.gpu
def test_linear_scan_kernel_fits_two_ctas_per_sm(cuda):
    from repro_torch.kernels.linear_scan import ctas_per_sm
    assert ctas_per_sm(True) >= 2 and ctas_per_sm(False) >= 2
    assert ctas_per_sm(False, scalar_decay=True) >= 2


@pytest.mark.gpu
def test_linear_scan_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(2, 64, 96, device=cuda)
    with pytest.raises(ValueError, match="dk, dv"):
        linear_scan_chunked(q, q, q, q, chunk=64)
    q = torch.zeros(2, 64, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        linear_scan_chunked(q, q, q, q, chunk=64)
    q = torch.zeros(2, 64, 8, device=cuda)
    with pytest.raises(ValueError, match="plain convention"):
        linear_scan_chunked(q, q, q, q[:, :, 0], chunk=64, strict=True)


@pytest.mark.gpu
def test_rwkv6_prefill_on_card_matches_cpu(cuda):
    """The smoke RWKV6 model's prefill and decode on the card (scan kernel)
    against the same weights on the CPU (plain versions)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import tree_leaves, tree_map
    model = LM(get_smoke_config("rwkv6-1.6b"))
    p_cpu = model.init(0, "cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 77)))
    before = linear_scan_chunked.launches
    lg, sg = model.prefill(p_gpu, {"tokens": toks.to(cuda)}, max_seq=128)
    assert linear_scan_chunked.launches == before + 2        # one per layer
    lc, sc = model.prefill(p_cpu, {"tokens": toks}, max_seq=128)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(sg), tree_leaves(sc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    tok = toks[:, -1]
    lg, _ = model.decode_step(p_gpu, sg, tok.to(cuda), 77, max_seq=128)
    lc, _ = model.decode_step(p_cpu, sc, tok, 77, max_seq=128)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_zamba2_prefill_and_decode_on_card_match_cpu(cuda):
    """The smoke zamba2 model (two units: one shared attention set applied
    twice, two Mamba2 blocks on the scan's scalar-decay mode) on the card
    against the same weights on the CPU: prefill logits and every state
    leaf, then decode steps against the caches."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import flatten_with_paths, tree_map
    model = LM(dataclasses.replace(get_smoke_config("zamba2-7b"), n_units=2,
                                   num_layers=4))
    p_cpu = model.init(0, "cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 77)))
    before = linear_scan_chunked.launches
    lg, sg = model.prefill(p_gpu, {"tokens": toks.to(cuda)}, max_seq=96)
    assert linear_scan_chunked.launches == before + 2      # one per mamba2
    lc, sc = model.prefill(p_cpu, {"tokens": toks}, max_seq=96)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for (k, a), (_, b) in zip(flatten_with_paths(sg), flatten_with_paths(sc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4,
                                   msg=k)
    for step in range(3):
        tok = toks[:, step]
        lg, sg = model.decode_step(p_gpu, sg, tok.to(cuda), 77 + step,
                                   max_seq=96)
        lc, sc = model.decode_step(p_cpu, sc, tok, 77 + step, max_seq=96)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-1b", "h2o-danube-3-4b",
                                  "stablelm-12b", "starcoder2-15b"])
def test_dense_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """The smoke dense stacks (``full`` / ``swa``, ring caches that wrap,
    gemma3's ``qk_norm``, starcoder2's GELU MLP) on the card against the
    same weights on the CPU: prefill logits and every state leaf (the
    positions exactly), then decode steps; no kernel launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import flatten_with_paths, tree_map
    model = LM(get_smoke_config(arch))
    p_cpu = model.init(0, "cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 80)))
    before = linear_scan_chunked.launches
    lg, sg = model.prefill(p_gpu, {"tokens": toks.to(cuda)}, max_seq=96)
    lc, sc = model.prefill(p_cpu, {"tokens": toks}, max_seq=96)
    for step in range(9):
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        for (k, a), (_, b) in zip(flatten_with_paths(sg),
                                  flatten_with_paths(sc)):
            if k.endswith("pos"):
                assert torch.equal(a.cpu(), b), k
            else:
                torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4,
                                           msg=k)
        tok = toks[:, step]
        lg, sg = model.decode_step(p_gpu, sg, tok.to(cuda), 80 + step,
                                   max_seq=96)
        lc, sc = model.decode_step(p_cpu, sc, tok, 80 + step, max_seq=96)
    assert linear_scan_chunked.launches == before


@pytest.mark.gpu
def test_slot_pool_per_row_positions_on_card(cuda):
    """The slot pool on the card: gemma3's smoke config (ring caches of 64
    slots, prompts of 9 to 80 tokens, so the slots sit at other positions
    and wrap at other slots) served through ``scheduler="slot"`` gives the
    CPU's slot tokens; one decode step of rows at their own positions
    matches the CPU's within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer.model import LM, per_row_positions
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.utils.pytree import flatten_with_paths, tree_map
    cfg = get_smoke_config("gemma3-1b")
    p_cpu = LM(cfg).init(0, "cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    rng = np.random.default_rng(1)
    reqs = [(i, rng.integers(0, 512, n).tolist())
            for i, n in enumerate((80, 9, 37, 70, 80, 15))]
    tokens = []
    for dev, params in (("cpu", p_cpu), (cuda, p_gpu)):
        eng = ServingEngine(cfg, params=params, batch_size=3, max_seq=96,
                            scheduler="slot", device=dev)
        for uid, prompt in reqs:
            eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
        tokens.append({r.uid: r.tokens for r in eng.run()})
        assert eng.stats()["prefill_bucket"] == "exact"
    assert tokens[1] == tokens[0]
    model = LM(cfg)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 81)))
    _, st = model.prefill(p_cpu, {"tokens": toks[:, :80]}, max_seq=96)
    st = tree_map(lambda x: x.contiguous(), per_row_positions(st, 2))
    pos = torch.tensor([80, 41])
    lc, sc = model.decode_step(p_cpu, st, toks[:, 80], pos, max_seq=96)
    lg, sg = model.decode_step(p_gpu, tree_map(lambda x: x.to(cuda), st),
                               toks[:, 80].to(cuda), pos.to(cuda),
                               max_seq=96)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for (k, a), (_, b) in zip(flatten_with_paths(sg), flatten_with_paths(sc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4, msg=k)


# MoE routing: a token whose router probabilities (f32, card against CPU
# ~1e-7 apart) tie within this may pick another expert on the card
ROUTE_TIE = 1e-5


def _recorded_routes(monkeypatch):
    """Every ``moe.route`` call's result, appended to the returned list."""
    from repro_torch.models.transformer import moe as MOE
    routes, route = [], MOE.route

    def recording(*args, **kw):
        routes.append(route(*args, **kw))
        return routes[-1]
    monkeypatch.setattr(MOE, "route", recording)
    return routes


def _rows_routed_alike(routes_gpu, routes_cpu, batch):
    """The batch rows none of whose tokens was routed otherwise on the
    card in any layer; every difference must be a near tie or the
    capacity shift one causes."""
    from repro_torch.models.transformer import moe as MOE
    assert len(routes_gpu) == len(routes_cpu) > 0
    alike = torch.ones(batch, dtype=torch.bool)
    for rg, rc in zip(routes_gpu, routes_cpu):
        rg = MOE.Routing(*(x.cpu() if torch.is_tensor(x) else x for x in rg))
        differ, unexplained = MOE.routing_differences(rc, rg, ROUTE_TIE)
        assert not bool(unexplained.any())
        alike &= ~differ.reshape(batch, -1).any(-1)
    assert bool(alike.any())
    return alike


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_prefill_and_decode_on_card_match_cpu(cuda, arch, monkeypatch):
    """The smoke MoE stacks with qwen2's routing (60 experts top-4, so
    capacity binds in the 80-token prefill) on the card against the same
    weights on the CPU: every routing difference a near tie or its
    capacity shift, and the rows routed alike within 1e-4 through the
    prefill, 3 decode steps of the wave (one group) and one of a slot
    pool (a (B,) position: each row its own group); no kernel launches."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer.model import LM, per_row_positions
    from repro_torch.utils.pytree import tree_map
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=60, top_k=4, expert_d_ff=64))
    model = LM(cfg)
    p_cpu = model.init(0, "cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 84)))
    routes = _recorded_routes(monkeypatch)
    before = linear_scan_chunked.launches
    alike = torch.ones(2, dtype=torch.bool)

    def both(fn_gpu, fn_cpu):
        nonlocal alike
        routes.clear()
        out_g = fn_gpu()
        n = len(routes)
        out_c = fn_cpu()
        alike &= _rows_routed_alike(routes[:n], routes[n:], 2)
        torch.testing.assert_close(out_g[0].cpu()[alike], out_c[0][alike],
                                   rtol=1e-4, atol=1e-4)
        return out_g[1], out_c[1]

    sg, sc = both(
        lambda: model.prefill(p_gpu, {"tokens": toks[:, :80].to(cuda)},
                              max_seq=96),
        lambda: model.prefill(p_cpu, {"tokens": toks[:, :80]}, max_seq=96))
    assert not bool(routes[-1].keep.all())              # capacity binds
    for step in range(3):
        tok = toks[:, 80 + step]
        sg, sc = both(
            lambda: model.decode_step(p_gpu, sg, tok.to(cuda), 80 + step,
                                      max_seq=96),
            lambda: model.decode_step(p_cpu, sc, tok, 80 + step, max_seq=96))
    pos = torch.tensor([83, 83])
    sg, sc = per_row_positions(sg, 2), per_row_positions(sc, 2)
    both(lambda: model.decode_step(p_gpu, sg, toks[:, 83].to(cuda),
                                   pos.to(cuda), max_seq=96),
         lambda: model.decode_step(p_cpu, sc, toks[:, 83], pos, max_seq=96))
    assert routes[-1].top_i.shape[:2] == (2, 1)         # a group a row
    assert linear_scan_chunked.launches == before


@pytest.mark.gpu
def test_hubert_bfloat16_forward_on_card_matches_cpu(cuda):
    """hubert's smoke encoder with ``dtype="bfloat16"`` (the audio stream
    computes in bf16: no √d scale) and masked frames, on the card against
    the CPU within bf16's 2e-2 × max(1, max|cpu|); bidirectional, 0
    kernel launches."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import tree_map
    cfg = dataclasses.replace(get_smoke_config("hubert-xlarge"),
                              dtype="bfloat16")
    model = LM(cfg)
    p_cpu = model.init(0, "cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    rng = np.random.default_rng(0)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
                 (2, 100, cfg.frontend_dim)).astype(np.float32)),
             "mask_positions": torch.from_numpy(rng.random((2, 100)) < 0.3)}
    before = linear_scan_chunked.launches
    lg, _ = model.forward(p_gpu, tree_map(lambda x: x.to(cuda), batch))
    lc, _ = model.forward(p_cpu, batch)
    assert lg.dtype == lc.dtype == torch.bfloat16
    err = float((lg.cpu().float() - lc.float()).abs().max())
    assert err <= 2e-2 * max(1.0, float(lc.float().abs().max()))
    assert linear_scan_chunked.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mean", "sym", "gat"])
def test_csr_aggregates_on_card_match_cpu(graph, cuda, op):
    """The csr layout's edge-centric ops (index_add / scatter_reduce, with
    atomics on the card) against the same call on the CPU, forward and
    gradient."""
    from repro_torch.graph.csr import symmetric_normalizers
    from repro_torch.models.gnn import agg
    rng = np.random.default_rng(11)
    n = graph.num_nodes
    arrays = (rng.standard_normal((n, 16)).astype(np.float32),
              rng.standard_normal(n).astype(np.float32),
              rng.standard_normal(n).astype(np.float32),
              symmetric_normalizers(graph).astype(np.float32))
    results = []
    for dev in (cuda, torch.device("cpu")):
        z, s, d, nrm = (torch.from_numpy(a).to(dev).requires_grad_(True)
                        for a in arrays)
        edges = agg.edge_operands(graph, device=dev)
        out = {"mean": lambda: agg.csr_mean_aggregate(z, edges),
               "sym": lambda: agg.csr_sym_aggregate(z, edges, nrm),
               "gat": lambda: agg.csr_gat_aggregate(z, s, d, edges)}[op]()
        grads = torch.autograd.grad((out ** 2).sum(), (z, s, d, nrm),
                                    allow_unused=True)
        results.append([out] + [g for g in grads if g is not None])
    for a, b in zip(*results):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_edge_operands_land_on_the_requested_device(graph, cuda):
    from repro_torch.models.gnn import agg
    edges = agg.edge_operands(graph, device=cuda)
    assert all(t.is_cuda for t in (edges.seg, edges.nbr, edges.w_mean,
                                   edges.emask))
    assert agg.build_agg_operands(graph, "csr", cuda).edges is edges
    assert not agg.edge_operands(graph, device="cpu").seg.is_cuda


@pytest.mark.gpu
def test_run_llcg_on_card_keeps_its_tensors_there(cuda, monkeypatch):
    """``run_llcg(..., device="cuda")`` with the csr correction: no tensor
    is copied off the card while it runs, the final parameters are CUDA
    tensors, and the History agrees with the CPU run's."""
    from repro_torch.core import DistConfig, run_llcg
    from repro_torch.graph.datasets import sbm_graph
    from repro_torch.models.gnn import build_model
    from repro_torch.utils.pytree import tree_leaves
    data = sbm_graph(num_nodes=240, num_classes=4, feature_dim=16, seed=0)
    model = build_model("GG", 16, 4, hidden_dim=16)
    cfg = DistConfig(num_machines=4, rounds=3, local_k=2, fanout=8,
                     correction_steps=2, partition_method="random",
                     server_agg_layout="csr")
    cpu_hist = run_llcg(data, model, cfg, device="cpu")
    moved = []
    to, cpu = torch.Tensor.to, torch.Tensor.cpu

    def spy_to(self, *args, **kw):
        out = to(self, *args, **kw)
        if self.is_cuda and not out.is_cuda:
            moved.append(tuple(self.shape))
        return out

    def spy_cpu(self, *args, **kw):
        if self.is_cuda:
            moved.append(tuple(self.shape))
        return cpu(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy_to)
    monkeypatch.setattr(torch.Tensor, "cpu", spy_cpu)
    hist = run_llcg(data, model, cfg, device="cuda")
    monkeypatch.undo()
    assert moved == []
    assert hist.meta["device"] == "cuda" and hist.meta["corr_agg_layout"] \
        == "csr"
    assert all(x.is_cuda for x in tree_leaves(hist.meta["final_params"]))
    np.testing.assert_allclose(hist.train_loss, cpu_hist.train_loss,
                               rtol=1e-3, atol=1e-3)
    assert hist.bytes_cum == cpu_hist.bytes_cum
    assert hist.steps_cum == cpu_hist.steps_cum


# --------------------------------------------------------------------------
# the device sampler, the prefetch stream and the shard_map backend
# --------------------------------------------------------------------------
def _sampling_setting(placement="device", kind="llcg", **comm):
    import dataclasses
    from repro_torch.core import plan as P
    from repro_torch.graph.datasets import sbm_graph
    from repro_torch.models.gnn.model import build_model
    data = sbm_graph(num_nodes=400, num_classes=4, feature_dim=8, seed=0)
    model = build_model("SBSBS", 8, 4, hidden_dim=16)
    cfg = P.DistConfig(num_machines=2, rounds=2, local_k=3, batch_size=16,
                       server_batch_size=32, fanout=6,
                       partition_method="random", seed=0)
    plan = {"llcg": P.llcg_plan, "ggs": P.ggs_plan}[kind](cfg)
    return data, model, dataclasses.replace(
        plan, comm=dataclasses.replace(plan.comm, **comm),
        sampler=dataclasses.replace(plan.sampler, placement=placement))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["llcg", "ggs"])
def test_device_sampler_on_card_equals_cpu(cuda, kind):
    """The same draw on the card and on the CPU, bit for bit: integer
    arithmetic and a sort of distinct keys on both."""
    from repro_torch.core.plan import RoundSampler, lower_plan
    data, model, plan = _sampling_setting(kind=kind)
    desc = lower_plan(plan)[0]
    draws = [RoundSampler(data, model, plan, dev).sample_round_on_device(
        desc, k_pad=desc.k + 2) for dev in (cuda, "cpu")]
    for a, b in zip(draws[0][:4], draws[1][:4]):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    assert draws[0][4] == draws[1][4]


@pytest.mark.gpu
def test_wide_rank_select_on_card_equals_cpu(hub_graph, cuda):
    """Rows wider than 128 slots (the reference's ``top_k`` keys) and train
    pools over 128, card against CPU."""
    from repro_torch.graph import sampling as S
    from repro_torch.utils import threefry
    pool = np.arange(0, 3000, 7)
    key = threefry.fold_in(threefry.prng_key(1), 3)
    outs = []
    for dev in (cuda, "cpu"):
        dcsr = S.build_device_csr([hub_graph], train_nodes=[pool],
                                  fanouts=[12], t_pad_min=64, device=dev)
        assert dcsr.dmax > S._RANK_SELECT_MAX_WIDTH
        outs.append(S.sample_round_device(dcsr, key, 3, 16, 64)
                    + S.sample_serving_tables_device(dcsr, key, 300))
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)


_PREFETCH_RUN = r"""
import dataclasses, json, sys
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
sys.path.insert(0, sys.argv[1])
from test_torch_gpu import _sampling_setting
from repro_torch.core.plan import build_trainer
from repro_torch.utils.pytree import tree_leaves
data, model, plan = _sampling_setting()
out = []
for overlap in (True, False):
    p = dataclasses.replace(plan, sampler=dataclasses.replace(
        plan.sampler, overlap=overlap))
    h = build_trainer(data, model, p).run()
    out.append(torch.cat([x.reshape(-1).cpu() for x in
                          tree_leaves(h.meta["final_params"])]))
print(json.dumps({"equal": bool(torch.equal(*out)),
                  "max": float((out[0] - out[1]).abs().max())}))
"""


@pytest.mark.gpu
def test_side_stream_prefetch_under_a_fresh_allocator(cuda):
    """A device-placed run prefetching its draws on a side stream equals
    the synchronous run bit for bit, in a fresh process (an empty caching
    allocator, whose first reuse of the tables' memory would show a
    missing ``record_stream``), under deterministic algorithms."""
    import json
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(here, "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _PREFETCH_RUN, here],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["equal"], out


def _two_ranks(mesh):
    from repro_torch.core.plan import build_trainer
    data, model, plan = _sampling_setting(compression="int8_ef")
    hist = build_trainer(data, model, plan, backend="shard_map",
                         mesh=mesh).run()
    return hist, mesh.gather_wire_bytes(), str(mesh.device)


@pytest.mark.gpu
def test_two_gloo_ranks_share_one_card(cuda):
    """Two shard_map ranks on ``cuda:0`` over gloo (NCCL refuses two ranks
    on one device): the vmap backend's trajectory within 1e-4 (the local
    rounds run as batches of one, which cuBLAS may compute in another
    order), the accounting's bytes at the collectives."""
    from repro_torch.core.plan import build_trainer
    from repro_torch.launch.mesh import launch_machines
    from repro_torch.utils.pytree import tree_leaves
    hist, wire, dev = launch_machines(_two_ranks, 2, device="cuda")
    assert dev.startswith("cuda") and hist.meta["device"] == dev
    ref = build_trainer(*_sampling_setting(compression="int8_ef")).run()
    assert hist.bytes_cum == ref.bytes_cum
    assert 2 * sum(w["averaging"] for w in wire) == hist.bytes_cum[-1]
    np.testing.assert_allclose(hist.train_loss, ref.train_loss, atol=1e-4)
    for a, b in zip(tree_leaves(hist.meta["final_params"]),
                    tree_leaves(ref.meta["final_params"])):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,dk,dv,chunk,mode,with_h0,with_dh", [
    (128, 128, 64, 64, 64, "strict", False, False),
    (128, 77, 64, 64, 64, "strict", True, True),
    (3, 100, 16, 24, 32, "strict", True, True),
    (224, 192, 64, 64, 64, "plain", True, True),
    (5, 50, 20, 30, 16, "plain", False, False),
    (448, 192, 64, 64, 64, "scalar", False, False),
    (448, 77, 64, 64, 64, "scalar", True, True),
    (2, 33, 64, 64, 1, "scalar", True, False)])
def test_linear_scan_backward_kernel_matches_plain_on_card(
        cuda, bh, t, dk, dv, chunk, mode, with_h0, with_dh):
    """The gradient kernel (strict with ``u``, plain per-key, scalar decay;
    ragged T, a chunk of 1, odd widths) through ``ops.linear_scan``'s
    autograd Function against torch autograd of the plain version on the
    card: one forward and one backward launch, every gradient within
    SCAN_TOL × max(1, max|plain|)."""
    from repro_torch.kernels.linear_scan import linear_scan_chunked_bwd
    rng = np.random.default_rng(bh * 7 + t)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    scalar, strict = mode == "scalar", mode == "strict"
    lw = torch.from_numpy((-0.3 * rng.random(
        (bh, t) if scalar else (bh, t, dk))).astype(np.float32)).to(cuda)
    ins = [f(bh, t, dk), f(bh, t, dk), f(bh, t, dv), lw,
           f(bh, dk, dv) if with_h0 else None, f(bh, dk) if strict else None]
    leaves = [None if x is None else x.requires_grad_(True) for x in ins]
    dy, dh = f(bh, t, dv), f(bh, dk, dv) if with_dh else None
    fwd, bwd = linear_scan_chunked.launches, linear_scan_chunked_bwd.launches
    y, h_t = ops.linear_scan(*leaves[:5], chunk=chunk, strict=strict,
                             u=leaves[5])
    used = [x for x in leaves if x is not None]
    got = torch.autograd.grad([y] + ([h_t] if with_dh else []), used,
                              [dy] + ([dh] if with_dh else []))
    assert linear_scan_chunked.launches == fwd + 1
    assert linear_scan_chunked_bwd.launches == bwd + 1
    want = [g for g in ref.linear_scan_vjp_ref(*ins, dy, dh, chunk=chunk,
                                               strict=strict)
            if g is not None]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        tol = SCAN_TOL * max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


@pytest.mark.gpu
def test_rwkv6_loss_gradient_on_card_matches_cpu(cuda):
    """``LM.loss`` and every gradient leaf of the smoke RWKV6 model on the
    card (the scan and its gradient kernel, one launch each a layer)
    against the CPU's plain versions."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.steps import value_and_grad
    from repro_torch.kernels.linear_scan import linear_scan_chunked_bwd
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import flatten_with_paths, tree_map
    model = LM(get_smoke_config("rwkv6-1.6b"))
    p_cpu = model.init(0, "cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 512, (2, 77)))
             for k in ("tokens", "labels")}
    fwd, bwd = linear_scan_chunked.launches, linear_scan_chunked_bwd.launches
    lg, gg = value_and_grad(model.loss, p_gpu,
                            {k: v.to(cuda) for k, v in batch.items()})
    assert linear_scan_chunked.launches == fwd + 2
    assert linear_scan_chunked_bwd.launches == bwd + 2
    lc, gc = value_and_grad(model.loss, p_cpu, batch)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=0)
    for (k, a), (_, b) in zip(flatten_with_paths(gg), flatten_with_paths(gc)):
        tol = 1e-3 * max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=tol, msg=k)


# ---------------------------------------------------------------------------
# the scan kernels at rwkv6-1.6b's training shapes
# ---------------------------------------------------------------------------
_SENTINEL = 1.2345e30


def _model_decays(shape, gen, device):
    """rwkv6's decay at its init: log w = -exp(clamp(base + lora, -8, 2)),
    base uniform in [-5, -2] and the adapter's term ~N(0, 0.6²)."""
    base = torch.empty(shape, device=device).uniform_(-5, -2, generator=gen)
    lora = torch.randn(shape, device=device, generator=gen) * 0.6
    return -torch.exp(torch.clamp(base + lora, -8, 2))


def _guarded(shape, device, pad=1 << 15):
    """A view of ``shape`` inside a buffer of sentinels ``pad`` floats
    wider on each side."""
    n = int(np.prod(shape))
    buf = torch.full((n + 2 * pad,), _SENTINEL, device=device)
    return buf, buf[pad:pad + n].view(shape), pad, n


def _guard_intact(g):
    buf, view, pad, n = g
    return (bool((buf[:pad] == _SENTINEL).all()),
            bool((buf[pad + n:] == _SENTINEL).all()),
            int((view == _SENTINEL).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,chunk,mode,with_h0", [
    (32, 4096, 8, "strict", False), (64, 4096, 8, "strict", False),
    (32, 4093, 8, "strict", False), (128, 128, 8, "strict", False),
    (32, 4096, 8, "plain", False), (32, 4096, 64, "scalar", False),
    (64, 4093, 64, "scalar", False), (32, 4093, 8, "strict", True),
    (32, 1000, 64, "strict", True), (32, 4093, 8, "scalar", True)])
def test_scan_kernels_write_their_outputs_and_nothing_else(cuda, bh, t,
                                                           chunk, mode,
                                                           with_h0):
    """Both scan kernels called with every output inside a band of
    sentinels: no sentinel outside an output changes, every element of
    every output is written, and no input changes (y, h_T, h_in; dq, dk,
    dv, d log_w, dh0, du); the cell's shapes, a ragged T, the plain and
    the scalar-decay modes."""
    from repro_torch.kernels import build
    from repro_torch.kernels.linear_scan import _bwd_kernel, _kernel
    gen = torch.Generator(device=cuda).manual_seed(bh + t + chunk)
    strict, scalar = mode == "strict", mode == "scalar"
    d = 64
    r = lambda *shape: torch.randn(*shape, device=cuda, generator=gen)
    q, k, v = r(bh, t, d), r(bh, t, d), r(bh, t, d)
    lw = (-0.3 * torch.rand(bh, t, device=cuda, generator=gen) if scalar
          else _model_decays((bh, t, d), gen, cuda))
    h0 = r(bh, d, d) if with_h0 else None
    u = r(bh, d) * 0.3 if strict else None
    dy, dh = r(bh, t, d), (r(bh, d, d) if with_h0 else None)
    ins = [x for x in (q, k, v, lw, h0, u, dy, dh) if x is not None]
    before = [x.clone() for x in ins]
    ptr = lambda x: None if x is None else x.data_ptr()
    nch = -(-t // chunk)
    gy, gh, gi = (_guarded(s, cuda) for s in
                  ((bh, t, d), (bh, d, d), (bh, nch, d, d)))
    assert build.launch_on(
        cuda.index or 0, _kernel(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), lw.data_ptr(), ptr(h0), ptr(u), gy[1].data_ptr(),
        gh[1].data_ptr(), gi[1].data_ptr(), bh, t, d, d, chunk, int(strict),
        int(scalar)) == 0
    grads = {"dq": _guarded((bh, t, d), cuda),
             "dk": _guarded((bh, t, d), cuda),
             "dv": _guarded((bh, t, d), cuda),
             "dlog_w": _guarded(tuple(lw.shape), cuda)}
    if with_h0:
        grads["dh0"] = _guarded((bh, d, d), cuda)
    if strict:
        grads["du"] = _guarded((bh, d), cuda)
    out = lambda name: ptr(grads[name][1]) if name in grads else None
    assert build.launch_on(
        cuda.index or 0, _bwd_kernel(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), lw.data_ptr(), ptr(u), gi[1].data_ptr(),
        gh[1].data_ptr() if with_h0 else None, dy.data_ptr(), ptr(dh),
        out("dq"), out("dk"), out("dv"), out("dlog_w"), out("dh0"),
        out("du"), bh, t, d, d, chunk, int(strict), int(scalar)) == 0
    torch.cuda.synchronize()
    named = {"y": gy, "h_T": gh, "h_in": gi, **grads}
    for name, g in named.items():
        assert _guard_intact(g) == (True, True, 0), name
    for a, b in zip(ins, before):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t", [(32, 4096), (64, 4096), (32, 4093),
                                  (128, 128)])
def test_scan_gradient_at_rwkv6_decays_matches_float64(cuda, bh, t):
    """The scan and its gradient kernel (strict with u, chunk 8, rwkv6's
    decays at init) against the float64 recurrence of
    ``llcg_bench/reference/lm_rwkv6.py`` under autograd: y and every
    gradient within 2e-6 of its norm.  The gradient kernel once summed
    d log w over every later step of the sequence, 5.8e-6 off at 4,096
    steps; it takes each chunk's end-state term now."""
    from llcg_bench.reference import lm_rwkv6 as ref_lm
    gen = torch.Generator(device=cuda).manual_seed(bh + t)
    r = lambda *shape: torch.randn(*shape, device=cuda, generator=gen)
    q, k, v, u = r(bh, t, 64), r(bh, t, 64), r(bh, t, 64), r(bh, 64) * 0.3
    lw = _model_decays((bh, t, 64), gen, cuda)
    dy = r(bh, t, 64)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v, lw, u)]
    with torch.enable_grad():
        y, _ = ops.linear_scan(*ins[:4], None, chunk=8, strict=True,
                               u=ins[4])
        got = [y, *torch.autograd.grad(y, ins, dy)]
    wide = [x.double().requires_grad_(True) for x in (q, k, v, lw, u)]
    with torch.enable_grad():
        y64 = ref_lm.scan(*wide)
        want = [y64, *torch.autograd.grad(y64, wide, dy.double())]
    for name, a, b in zip(("y", "dq", "dk", "dv", "dlog_w", "du"), got,
                          want):
        gap = float((a.detach().double() - b).norm() / b.norm())
        assert gap < 2e-6, (name, gap)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [41, 7])
def test_rwkv6_24_layers_at_4096_tokens_against_float64(cuda, seed):
    """rwkv6-1.6b at full width and depth in float32, one sequence of
    4,096 tokens, through the scan kernels, against the float64 reference
    (``llcg_bench/reference/lm_rwkv6.py``): every token's loss within 1e-5
    (the norm of the gap over the loss's), and ``LM.loss``'s first
    gradient with per-block recomputation, per leaf and layer over the
    larger of its norm and the median one's, at the median within 0.1 and
    everywhere within 1 (a gradient lost or of the wrong sign reads 1 or
    more).  No tighter: the gradient is ill-conditioned at init.  The
    first token's GroupNorm divides outputs of variance down to ~1e-7 by
    sqrt(var + 1e-6), and those tokens' gradients, ~1e5 times the others',
    dominate every leaf upstream of them: the plain float32 scan reads up
    to 1.9e-3 off float64 on the trainer's corpus at these seeds, the
    kernels 8.2e-3, 0.074 on random tokens; in the LM cell the program's
    median leaf reads up to 0.21 off float64 (PERF.md §6)."""
    import dataclasses

    from llcg_bench.reference import lm_rwkv6 as ref_lm
    from repro_torch.configs import get_config
    from repro_torch.distributed.steps import value_and_grad
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import flatten_with_paths
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), dtype="float32")
    model = LM(cfg)
    params = model.init(seed, cuda)
    gen = torch.Generator().manual_seed(seed)
    batch = {k: torch.randint(0, 256, (1, 4096), generator=gen).mul_(256)
             .to(cuda) for k in ("tokens", "labels")}
    with torch.no_grad():
        logits = model.forward(params, batch)[0].float()
        nll = (torch.logsumexp(logits, -1) - logits.gather(
            -1, batch["labels"].long()[..., None])[..., 0]).double()
    del logits
    loss = lambda p, b: model.loss(p, b, remat=True)
    _, grads = value_and_grad(loss, params, batch)
    got = dict(flatten_with_paths(grads))
    wide = {k: v.double() for k, v in flatten_with_paths(params)}
    del params, grads
    torch.cuda.empty_cache()
    with torch.no_grad():
        nll64 = ref_lm.token_nll(wide, batch["tokens"], batch["labels"],
                                 cfg.norm_eps, remat=False)
    nll_gap = float((nll - nll64).norm() / nll64.norm())
    _, want = ref_lm.value_and_grad(wide, batch, cfg.norm_eps)
    del wide
    gaps, norms = {}, {}
    for k, w in want.items():
        n = cfg.num_layers if k.startswith("units/") else 1
        for i, (a, b) in enumerate(zip(got[k].reshape(n, -1),
                                       w.reshape(n, -1))):
            gaps[k, i] = float((a.double() - b).norm())
            norms[k, i] = float(b.norm())
    med = sorted(norms.values())[len(norms) // 2]
    rel = sorted((gaps[x] / max(norms[x], med), x) for x in gaps)
    median, worst = rel[len(rel) // 2][0], rel[-1]
    assert nll_gap < 1e-5 and median < 0.1 and worst[0] < 1.0, (
        nll_gap, median, worst)


@pytest.mark.gpu
def test_rwkv6_unbound_layers_equal_indexed_on_card(cuda):
    """rwkv6-1.6b at its widths with 4 layers, one sequence of 4,096 tokens
    and per-block recomputation: ``LM.loss``'s gradients through one
    ``unbind`` per stacked leaf equal those through per-layer ``x[idx]``
    views (``tests/lm_indexed.py``) bit for bit, and the peak of allocated
    memory over one ``value_and_grad`` is no higher."""
    import dataclasses

    from lm_indexed import IndexedLM
    from repro_torch.configs import get_config
    from repro_torch.distributed.steps import value_and_grad
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import flatten_with_paths
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=4)
    model = LM(cfg)
    params = model.init(11, cuda)
    gen = torch.Generator().manual_seed(11)
    batch = {k: torch.randint(0, 256, (1, 4096), generator=gen).mul_(256)
             .to(cuda) for k in ("tokens", "labels")}

    def run(lm):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = value_and_grad(
            lambda p, b: lm.loss(p, b, remat=True), params, batch)
        torch.cuda.synchronize()
        return loss, grads, torch.cuda.max_memory_allocated() - base

    loss_i, grads_i, peak_i = run(IndexedLM(cfg))
    loss, grads, peak = run(model)
    assert torch.equal(loss, loss_i)
    for (k, g), (_, w) in zip(flatten_with_paths(grads),
                              flatten_with_paths(grads_i)):
        assert torch.equal(g, w), k
    assert peak <= peak_i, (peak, peak_i)
