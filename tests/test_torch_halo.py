"""The port's halo machinery against the JAX package.

``graph/halo.py`` is a numpy copy, so every :class:`HaloPlan` /
:class:`HaloProgram` array and byte count must be ``np.array_equal`` to the
reference's.  :func:`repro_torch.core.machine.halo_fill` (stacked over the
machines, with a sink row in place of JAX's dropped out-of-bounds writes)
must reproduce the numpy oracle ``halo_exchange_reference`` exactly — it
only moves rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core.machine import halo_fill as ref_halo_fill
from repro.graph import datasets as ref_datasets
from repro.graph import halo as ref_halo
from repro.graph import partition as ref_partition

from repro_torch.comm.compress import COMPRESSIONS
from repro_torch.core.machine import halo_fill
from repro_torch.graph import datasets, halo, partition

CASES = [("sbm", 4, "random"), ("sbm", 3, "bfs"), ("rmat", 5, "random")]


def _pair(kind, P, method):
    if kind == "sbm":
        kw = dict(num_nodes=180, num_classes=5, feature_dim=8, avg_degree=8,
                  seed=3)
        r, p = ref_datasets.sbm_graph(**kw), datasets.sbm_graph(**kw)
    else:
        kw = dict(num_nodes=150, num_edges=500, feature_dim=8, num_classes=4,
                  seed=4)
        r, p = ref_datasets.rmat_graph(**kw), datasets.rmat_graph(**kw)
    rpart = ref_partition.partition_graph(r.graph, P, method=method, seed=1)
    ppart = partition.partition_graph(p.graph, P, method=method, seed=1)
    return r, p, rpart, ppart


def _plans_equal(a, b):
    assert a.ext_num_local == b.ext_num_local
    for x, y in zip(a.halo_nodes + a.halo_owner, b.halo_nodes + b.halo_owner):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for g, h in zip(a.ext_graphs, b.ext_graphs):
        assert g.num_nodes == h.num_nodes
        assert np.array_equal(g.indptr, h.indptr)
        assert np.array_equal(g.indices, h.indices)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-P{c[1]}-{c[2]}")
def test_halo_plan_and_program_equal(case):
    r, p, rpart, ppart = _pair(*case)
    rplan = ref_halo.build_halo_plan(r.graph, rpart)
    pplan = halo.build_halo_plan(p.graph, ppart)
    _plans_equal(pplan, rplan)
    assert halo.ext_fanout(pplan, 10) == ref_halo.ext_fanout(rplan, 10)
    rprog = ref_halo.build_halo_program(r.graph, rpart, plan=rplan)
    pprog = halo.build_halo_program(p.graph, ppart, plan=pplan)
    for f in ("num_machines", "max_send", "max_halo", "n_ext_pad"):
        assert getattr(pprog, f) == getattr(rprog, f), f
    for f in ("send_idx", "send_counts", "recv_idx", "dest_idx",
              "recv_valid", "halo_counts", "num_local"):
        a, b = getattr(pprog, f), getattr(rprog, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for comp in COMPRESSIONS[:3]:
        for d in (8, 32):
            for fn in ("halo_bytes", "exchange_bytes",
                       "gathered_bytes_per_device"):
                assert getattr(pprog, fn)(d, compression=comp) == \
                    getattr(rprog, fn)(d, compression=comp), (fn, comp, d)


@pytest.mark.parametrize("hops", [1, 2])
def test_inference_plan_and_crossing_mask_equal(hops):
    r, p, rpart, ppart = _pair("sbm", 4, "bfs")
    _plans_equal(halo.build_inference_plan(p.graph, ppart, num_hops=hops),
                 ref_halo.build_inference_plan(r.graph, rpart,
                                               num_hops=hops))
    assert np.array_equal(
        halo.cut_crossing_mask(p.graph, ppart.assignment, hops),
        ref_halo.cut_crossing_mask(r.graph, rpart.assignment, hops))


def _local_feats(prog, part, features):
    P, n = prog.num_machines, prog.n_ext_pad
    feats = np.zeros((P, n, features.shape[1]), np.float32)
    for q in range(P):
        local = part.part_nodes[q]
        feats[q, : local.size] = features[local]
    return feats


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-P{c[1]}-{c[2]}")
def test_halo_fill_matches_the_exchange_oracle(case):
    r, p, rpart, ppart = _pair(*case)
    prog = halo.build_halo_program(p.graph, ppart)
    feats = _local_feats(prog, ppart, p.features)
    want = halo.halo_exchange_reference(prog, feats)
    rprog = ref_halo.build_halo_program(r.graph, rpart)
    assert np.array_equal(want, ref_halo.halo_exchange_reference(rprog,
                                                                 feats))
    P, d = prog.num_machines, feats.shape[-1]
    ft = torch.from_numpy(feats)
    send = ft[torch.arange(P)[:, None], torch.from_numpy(prog.send_idx)
              .long()].reshape(P * prog.max_send, d)
    got = halo_fill(ft, send, *(torch.from_numpy(a) for a in (
        prog.recv_idx, prog.dest_idx, prog.recv_valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the JAX package's per-machine fill on the same buffer
    jfill = jax.vmap(ref_halo_fill, in_axes=(0, None, 0, 0, 0))(
        jnp.asarray(feats), jnp.asarray(send.numpy()),
        *(jnp.asarray(a) for a in (prog.recv_idx, prog.dest_idx,
                                   prog.recv_valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfill))
