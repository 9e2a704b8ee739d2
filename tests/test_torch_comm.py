"""The port's compressed-communication layer against the JAX package.

The plain quantize/dequantize (what the CUDA kernels are held to on the
card) must be bit-equal to the JAX package's oracles
(``repro.kernels.ref``).  Against the JAX op itself (the Pallas kernel in
interpret mode, under ``jit``) the tolerance is the JAX package's own
(``tests/test_comm.py``): the scale within 1 ulp — XLA computes
``amax / 127`` as ``amax · (1/127)`` — and ``q`` within ±1 level, since a
1-ulp scale can move ``floor`` one level at a boundary.

Stochastic rounding draws its uniforms from one explicit source;
:class:`JaxUniforms` replays the JAX package's fold chain
``fold_in(fold_in(fold_in(PRNGKey(seed), call), machine), leaf)`` so both
packages round with the same numbers.  Leaf ``i`` has to mean the same leaf
in both, so the port's leaf order is checked against ``tree_leaves``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.comm import compress as ref_comp
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_k
from repro.models.gnn.model import build_model as ref_build_model

from repro_torch.comm import compress as comp
from repro_torch.configs.gnn_datasets import SETTINGS
from repro_torch.kernels import ops, quantize
from repro_torch.kernels import ref as ref_k_torch
from repro_torch.kernels.quantize import dequantize_rows, quantize_rows
from repro_torch.models.gnn.model import build_model
from repro_torch.utils.pytree import tree_leaves, tree_map

SHAPES = [(1, 7), (5, 33), (37, 128), (130, 65), (8, 4096)]


class JaxUniforms:
    """The JAX package's stochastic-rounding draws, as a port uniform
    source: per call ``c``, machine ``m`` and leaf ``i`` the uniforms of
    ``fold_in(fold_in(fold_in(PRNGKey(seed), c), m), i)``
    (``src/repro/core/engine.py`` and ``src/repro/comm/compress.py``)."""

    def __init__(self, seed: int):
        self.seed = seed
        self.reset()

    def reset(self):
        self.calls = 0

    def draw(self, num_machines, sizes, device):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), self.calls)
        self.calls += 1
        keys = ref_comp.machine_keys(key, num_machines)
        out = []
        for i, n in enumerate(sizes):
            u = jax.vmap(lambda k: jax.random.uniform(
                jax.random.fold_in(k, i), (n,)))(keys)
            out.append(torch.from_numpy(np.array(u)).to(device))
        return out


def _xu(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    u = rng.random(shape).astype(np.float32)
    return x, u


def _assert_scale_within_ulp(port, jax_scale):
    a, b = np.asarray(port, np.float32), np.asarray(jax_scale, np.float32)
    assert (np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                   np.abs(b)))).all()


def _assert_q_within_level(port, jax_q):
    d = np.abs(np.asarray(port, np.int32) - np.asarray(jax_q, np.int32))
    assert int(d.max(initial=0)) <= 1


# --------------------------------------------------------------------------
# kernels' plain versions
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_u", [True, False], ids=["u", "half_up"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_quantize_is_bit_equal_to_the_oracle(shape, with_u):
    x, u = _xu(shape)
    uj = jnp.asarray(u) if with_u else None
    ut = torch.from_numpy(u) if with_u else None
    qr, sr = ref_k.quantize_int8_rows_ref(jnp.asarray(x), uj)
    qp, sp = ops.quantize_int8_rows(torch.from_numpy(x), ut)
    assert qp.dtype == torch.int8 and sp.shape == (shape[0], 1)
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sr))
    np.testing.assert_array_equal(
        ops.dequantize_int8_rows(qp, sp).numpy(),
        np.asarray(ref_k.dequantize_int8_rows_ref(qr, sr)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_quantize_within_tolerance_of_the_jax_kernel(shape):
    x, u = _xu(shape, seed=1)
    qk, sk = ref_ops.quantize_int8_rows(jnp.asarray(x), jnp.asarray(u))
    qp, sp = ops.quantize_int8_rows(torch.from_numpy(x), torch.from_numpy(u))
    _assert_scale_within_ulp(sp.numpy(), sk)
    _assert_q_within_level(qp.numpy(), qk)
    # reconstruction error bounded by one quantization level per row
    err = np.abs(ops.dequantize_int8_rows(qp, sp).numpy() - x)
    assert (err <= sp.numpy() * 1.001).all()


def test_all_zero_rows_and_the_half_up_default():
    x = torch.tensor([[0.0, 0.0, 0.0], [0.4, -0.4, 126.6]])
    q, s = ops.quantize_int8_rows(x)
    qr, sr = ref_k.quantize_int8_rows_ref(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    assert q[0].abs().max() == 0
    d = ops.dequantize_int8_rows(q, s)[1]
    assert float((d - x[1]).abs().max()) <= float(s[1, 0]) / 2 + 1e-6


def test_wrappers_count_no_launch_on_cpu_and_reject_bad_shapes():
    before = (quantize_rows.launches, dequantize_rows.launches)
    q, s = quantize_rows(torch.randn(4, 9))
    dequantize_rows(q, s)
    assert (quantize_rows.launches, dequantize_rows.launches) == before
    with pytest.raises(ValueError):
        quantize_rows(torch.randn(4, 9), torch.rand(4, 8))
    with pytest.raises(ValueError):
        quantize_rows(torch.randn(9))
    with pytest.raises(ValueError):
        dequantize_rows(q, s[:2])


def _geometry_cover(g, r, c):
    """How many times the quantize kernel's threads take each element of an
    (r, c) buffer under geometry ``g`` (the mapping ``quantize.Geometry``
    documents; loads past ``slots`` are the streamed ones)."""
    span = g.lanes * g.row_warps
    step = g.cluster * span
    n = -(-c // g.vec)
    b = np.arange(g.grid)[:, None, None]
    t = np.arange(g.threads)[None, :, None]
    i = np.arange(-(-n // step))[None, None, :]
    row = (b // g.cluster) * g.cta_rows + t // span
    load = (b % g.cluster) * span + t % span + i * step
    row, load = np.broadcast_arrays(row, load)
    ok = (row < r) & (load < n)
    elems = (row[ok][:, None] * c + load[ok][:, None] * g.vec
             + np.arange(g.vec)[None, :])
    return np.bincount(elems.ravel(), minlength=r * c)


@pytest.mark.parametrize("c", [1, 7, 8, 33, 64, 65, 128, 256, 512, 513, 1000,
                               2048, 4096, 65536])
def test_quantize_geometry_covers_every_element_once(c):
    """Every (r, c), float4 or scalar loads: each element exactly once, a
    cluster of at most 8 CTAs, lanes per row dividing 32, and the launch
    limits the C entry checks."""
    rows = [1, 3, 8, 131, 800] + ([65536] if c == 256 else [])
    for r in rows if c < 65536 else [1, 8]:
        for vec4 in (True, False):
            g = quantize.geometry(r, c, vec4)
            assert g.vec == (4 if vec4 and c % 4 == 0 else 1)
            assert 1 <= g.cluster <= quantize.MAX_CLUSTER
            assert 32 % g.lanes == 0
            assert g.slots in (1, 2, 4, 8)
            assert g.threads % 32 == 0 and g.threads <= 512
            assert g.grid % g.cluster == 0
            if g.row_warps > 1 or g.cluster > 1:
                assert g.lanes == 32 and g.cta_rows == 1
            cover = _geometry_cover(g, r, c)
            assert cover.shape == (r * c,) and (cover == 1).all(), (r, c, g)


def test_quantize_geometry_fills_the_card_at_the_averaging_shapes():
    """(8, 4096) and (8, 2048) split each row over a cluster of 8 (64
    CTAs); narrow rows take shuffles within a group of lanes."""
    for c in (4096, 2048):
        g = quantize.geometry(8, c)
        assert g.cluster == 8 and g.grid >= 64 and g.slots == 1
    for r, c in ((800, 32), (8, 64), (8, 8)):
        g = quantize.geometry(r, c)
        assert g.cluster == 1 and g.row_warps == 1 and g.lanes < 32
        assert g.lanes * g.slots * g.vec >= c


def _table_cover(table, shapes):
    """How many times the dequantize kernel's warps write each float of
    the flat output under ``table`` (the mapping ``quantize.SegmentTable``
    documents, the segment found as the kernel finds it; a warp's span of
    ``32 · CHUNK`` values is written once whichever path takes it)."""
    cover = np.zeros(table.size, np.int64)
    warps = quantize.DEQ_THREADS // 32
    span = 32 * quantize.CHUNK
    for segs, start in table.launches:
        b = np.arange(start[-1])
        s = (np.asarray(start[1:len(segs)])[None, :] <= b[:, None]).sum(1)
        tile = b - np.asarray(start)[s]
        w = np.arange(warps)[None, :, None]
        j = np.arange(span)[None, None, :]
        value = tile[:, None, None] * quantize.TILE + w * span + j
        n = np.asarray([shapes[segs[i]][0] * shapes[segs[i]][1]
                        for i in s])[:, None, None]
        offset = np.asarray([table.offsets[segs[i]] for i in s])[:, None, None]
        value, n, offset = np.broadcast_arrays(value, n, offset)
        ok = value < n
        np.add.at(cover, (offset + value)[ok], 1)
    return cover


# C's round (8 machines x the 13 leaves of SBSBS at hidden 64), rows of
# 1, 8, 17 and 33 values, empty segments, more segments than a table holds
_TABLES = {
    "round": [(8, 4096)] * 2 + [(8, 2048)] * 2 + [(8, 512)] * 2
             + [(8, 64)] * 6 + [(8, 8)],
    "awkward": [(5, 1), (8, 8), (3, 17), (7, 33), (1, 1), (700, 300)],
    "empty": [(0, 5), (3, 0), (4, 17), (0, 0), (2, 16)],
    "split": [(i % 5 + 1, 3 + 7 * i) for i in range(70)],
}


@pytest.mark.parametrize("name", sorted(_TABLES))
def test_segment_table_covers_every_value_once(name):
    """Each value of each segment written exactly once, nothing between
    them; outputs 16-byte aligned; empty segments in no launch; at most
    ``MAX_SEGMENTS`` segments a launch."""
    shapes = tuple(_TABLES[name])
    table = quantize.segment_table(shapes)
    sizes = [r * c for r, c in shapes]
    live = [i for i, n in enumerate(sizes) if n]
    assert all(o % 4 == 0 for o in table.offsets)
    assert [i for segs, _ in table.launches for i in segs] == live
    assert len(table.launches) == -(-len(live) // quantize.MAX_SEGMENTS)
    for segs, start in table.launches:
        assert 1 <= len(segs) <= quantize.MAX_SEGMENTS
        assert start[0] == 0 and len(start) == len(segs) + 1
        # the tile counts the C entry checks
        assert [b - a for a, b in zip(start, start[1:])] == \
            [-(-sizes[i] // quantize.TILE) for i in segs]
    want = np.zeros(table.size, np.int64)
    for o, n in zip(table.offsets, sizes):
        assert want[o:o + n].sum() == 0             # no overlap
        want[o:o + n] = 1
    assert table.size < sum(sizes) + 4 * len(shapes)
    np.testing.assert_array_equal(_table_cover(table, shapes), want)


def test_segment_table_constants_are_the_kernels():
    """The tile geometry the host lays out is the one the kernel runs."""
    import re
    src = (quantize.build.CSRC / "quantize_rows.cu").read_text()
    for name, value in (("kDeqThreads", quantize.DEQ_THREADS),
                        ("kChunk", quantize.CHUNK),
                        ("kMaxSegments", quantize.MAX_SEGMENTS)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name


def test_grouped_dequantize_on_cpu_equals_plain_per_segment():
    """The grouped wrapper on the CPU: the plain version per segment, bit
    for bit, empty segments included, and no launch counted."""
    rng = np.random.default_rng(9)
    shapes = _TABLES["awkward"] + _TABLES["empty"] + _TABLES["split"]
    qs = [torch.from_numpy(rng.integers(-127, 128, (r, c)).astype(np.int8))
          for r, c in shapes]
    ss = [torch.from_numpy(rng.random((r, 1)).astype(np.float32) + 1e-3)
          for r, _ in shapes]
    before = dequantize_rows.launches
    outs = quantize.dequantize_rows_many(qs, ss)
    assert dequantize_rows.launches == before
    assert len(outs) == len(shapes)
    for q, s, out in zip(qs, ss, outs):
        assert out.dtype == torch.float32 and out.shape == q.shape
        assert torch.equal(out, ref_k_torch.dequantize_int8_rows_ref(q, s))
        assert torch.equal(dequantize_rows(q, s), out)
    assert quantize.dequantize_rows_many([], []) == []
    with pytest.raises(ValueError):
        quantize.dequantize_rows_many(qs[:2], ss[:1])
    with pytest.raises(ValueError):
        quantize.dequantize_rows_many(qs[:2], [ss[0], ss[0]])


@pytest.mark.parametrize("stacked", [True, False],
                         ids=["stacked", "one_machine"])
def test_decompress_tree_on_config_c_leaves_equals_jax_exactly(stacked):
    """Config C's parameter leaves (SBSBS, 32 features, 8 classes, hidden
    64) stacked over 8 machines (one scale per machine), or one machine's
    leaves with one scale each: the same int8 payload and scales
    dequantize to the same floats in both packages."""
    P = 8 if stacked else 1
    lead = (P,) if stacked else ()
    rparams = ref_build_model("SBSBS", 32, 8, hidden_dim=64).init(0)
    rng = np.random.default_rng(12)
    payload = jax.tree_util.tree_map(
        lambda a: rng.integers(-127, 128, lead + a.shape).astype(np.int8),
        rparams)
    scales = jax.tree_util.tree_map(
        lambda a: (rng.random((P, 1)) * 1e-3 + 1e-6).astype(np.float32),
        rparams)
    assert len(jax.tree_util.tree_leaves(payload)) == 13
    jd = ref_comp.decompress_tree(
        jax.tree_util.tree_map(jnp.asarray, payload),
        jax.tree_util.tree_map(jnp.asarray, scales), "int8_ef")
    td = comp.decompress_tree(tree_map(torch.from_numpy, payload),
                              tree_map(torch.from_numpy, scales), "int8_ef")
    ours, theirs = tree_leaves(td), jax.tree_util.tree_leaves(jd)
    assert len(ours) == len(theirs) == 13
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stochastic_rounding_is_unbiased():
    x = torch.linspace(-2.0, 2.0, 16)[None]
    stream = comp.UniformStream(0)
    acc = torch.zeros(x.shape, dtype=torch.float64)
    n = 400
    for _ in range(n):
        (u,) = stream.draw(1, [16], "cpu")
        q, s = ops.quantize_int8_rows(x, u)
        acc += ops.dequantize_int8_rows(q, s).double()
    scale = 2.0 / 127.0                    # one quantization level
    np.testing.assert_allclose((acc / n).numpy(), x.numpy(),
                               atol=3 * scale / np.sqrt(n))


def test_uniform_stream_restarts_and_splits_per_leaf():
    stream = comp.UniformStream(5)
    a = stream.draw(3, [4, 7], "cpu")
    b = stream.draw(3, [4, 7], "cpu")
    stream.reset()
    a2 = stream.draw(3, [4, 7], "cpu")
    assert [t.shape for t in a] == [(3, 4), (3, 7)]
    assert all(torch.equal(x, y) for x, y in zip(a, a2))
    assert not torch.equal(a[0], b[0])
    assert all(float(t.min()) >= 0.0 and float(t.max()) < 1.0 for t in a)


# --------------------------------------------------------------------------
# leaf order, codecs and pricing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted({s.base_arch
                                         for s in SETTINGS.values()}))
def test_leaf_order_is_the_jax_tree_order(arch):
    pm = build_model(arch, 12, 5, hidden_dim=16)
    rm = ref_build_model(arch, 12, 5, hidden_dim=16)
    ours = tree_leaves(pm.init_numpy(3))
    theirs = jax.tree_util.tree_leaves(rm.init(3))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))


def _stacked_delta(P=3, seed=0):
    rm = ref_build_model("SBSBS", 12, 5, hidden_dim=16)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal((P,) + a.shape) * 0.01).astype(
            np.float32), rm.init(0))
    return tree


@pytest.mark.parametrize("compression", ref_comp.COMPRESSIONS)
def test_compress_tree_matches_the_jax_payloads(compression):
    P = 3
    tree = _stacked_delta(P)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = tree_map(torch.from_numpy, tree)
    stoch = compression in ("int8", "int8_ef")
    key = (ref_comp.machine_keys(
        jax.random.fold_in(jax.random.PRNGKey(7), 0), P) if stoch else None)
    u = (JaxUniforms(7).draw(P, [x[0].numel() for x in tree_leaves(ttree)],
                             "cpu") if stoch else None)
    jp, js = ref_comp.compress_tree(jtree, compression, key=key, stacked=True)
    tp, ts = comp.compress_tree(ttree, compression, u=u, stacked=True)
    jd = ref_comp.decompress_tree(jp, js, compression)
    td = comp.decompress_tree(tp, ts, compression)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert a.shape == b.shape
        if compression.startswith("int8"):
            _assert_q_within_level(a.numpy(), b)
        else:
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
    if ts is not None:
        for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
            assert a.shape == b.shape == (P, 1)
            _assert_scale_within_ulp(a.numpy(), b)
    for a, b in zip(tree_leaves(td), jax.tree_util.tree_leaves(jd)):
        assert a.dtype == torch.float32
        # one quantization level of a 0.01-scale delta at most
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("compression", ref_comp.HALO_COMPRESSIONS)
def test_compress_features_matches_jax(compression):
    x, _ = _xu((40, 24), seed=4)
    jp, js = ref_comp.compress_features(jnp.asarray(x), compression)
    tp, ts = comp.compress_features(torch.from_numpy(x), compression)
    jd = np.asarray(ref_comp.decompress_features(jp, js, compression))
    td = comp.decompress_features(tp, ts, compression).numpy()
    if compression == "int8":
        _assert_scale_within_ulp(ts.numpy(), js)
        _assert_q_within_level(tp.numpy(), jp)
        # the plain version is the oracle's deterministic rounding exactly
        q, s = ref_k.quantize_int8_rows_ref(jnp.asarray(x))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(q))
        np.testing.assert_allclose(td, jd, rtol=0,
                                   atol=float(ts.max()) * 1.001)
    else:
        np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("compression", ref_comp.COMPRESSIONS)
def test_wire_pricing_is_exactly_equal(compression):
    for d in (1, 16, 32, 100):
        for dtype in (np.float32, np.float16):
            assert comp.wire_row_bytes(d, dtype, compression) == \
                ref_comp.wire_row_bytes(d, dtype, compression)
    for arch in ("SBSBS", "GAT", "BSBSBL"):
        pm = build_model(arch, 12, 5, hidden_dim=16)
        rparams = ref_build_model(arch, 12, 5, hidden_dim=16).init(0)
        want = ref_comp.averaging_payload_bytes(rparams, compression)
        assert comp.averaging_payload_bytes(pm.init_numpy(0),
                                            compression) == want
        assert comp.averaging_payload_bytes(pm.init(0, device="cpu"),
                                            compression) == want


def test_check_compression_rejects_unknown_codecs():
    assert comp.check_compression("int8_ef") == "int8_ef"
    with pytest.raises(ValueError, match="halo_compression"):
        comp.check_compression("int8_ef", halo=True)
    with pytest.raises(ValueError, match="compression"):
        comp.check_compression("fp8")
