"""Model parity: the port's GNN forward and gradients against the JAX
package's, from the same numpy parameters and inputs.

Tolerance 1e-5: both sides are f32 and differ only in the order of their
sums (matmuls, neighbor means, softmax denominators).  The fused GAT runs
the Pallas kernel in interpret mode on the JAX side and the edge-softmax
kernel's plain version + analytic backward on the port's side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph.csr import build_neighbor_table as ref_table
from repro.graph.datasets import sbm_graph as ref_sbm
from repro.models.gnn import agg as ref_agg
from repro.models.gnn.model import build_model as ref_build
from repro.models.gnn.model import cross_entropy_on_batch as ref_ce
from repro.models.gnn.model import f1_micro as ref_f1

from repro_torch.convert import params_from_jax
from repro_torch.graph.datasets import sbm_graph
from repro_torch.models.gnn import agg
from repro_torch.models.gnn.model import (build_model, cross_entropy_on_batch,
                                          f1_micro)
from repro_torch.utils.pytree import tree_leaves

TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    kw = dict(num_nodes=120, num_classes=5, feature_dim=12, avg_degree=6,
              seed=2)
    r, p = ref_sbm(**kw), sbm_graph(**kw)
    table, mask = ref_table(r.graph)
    batch = np.random.default_rng(0).choice(r.num_nodes, 24, replace=False)
    return r, p, table, mask, batch.astype(np.int32)


CASES = [("SBSBS", {}), ("GG", {}), ("GAT", {"fused_gat": True}),
         ("GAT", {}), ("APPNP", {"appnp_steps": 3}), ("BSBSBL", {})]


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=[a + ("-fused" if k.get("fused_gat") else "")
                              for a, k in CASES])
@pytest.mark.parametrize("layout", ["padded", "bcsr_kernel", "csr"])
def test_logits_and_grads_match(data, arch, kw, layout):
    r, p, table, mask, batch = data
    rm = ref_build(arch, 12, 5, hidden_dim=16, **kw)
    pm = build_model(arch, 12, 5, hidden_dim=16, **kw)
    rparams = rm.init(1)
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              device="cpu")
    ragg = ref_agg.build_agg_operands(r.graph, layout)
    pagg = agg.build_agg_operands(p.graph, layout, "cpu")
    jx = [jnp.asarray(a) for a in (r.features, table, mask, r.labels, batch)]
    tx = [torch.from_numpy(np.asarray(a))
          for a in (p.features, table, mask, p.labels, batch)]

    def jloss(prm):
        return ref_ce(rm.apply(prm, *jx[:3], agg=ragg), jx[3], jx[4])

    jl, jg = jax.value_and_grad(jloss)(rparams)
    leaves = [x.requires_grad_(True) for x in tree_leaves(pparams)]
    logits = pm.apply(pparams, *tx[:3], agg=pagg)
    tl = cross_entropy_on_batch(logits, tx[3], tx[4])
    tl.backward()
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(rm.apply(rparams, *jx[:3], agg=ragg)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=TOL, atol=TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jg), leaves):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)
    assert float(f1_micro(logits.detach(), tx[3], tx[4])) == pytest.approx(
        float(ref_f1(rm.apply(rparams, *jx[:3]), jx[3], jx[4])), abs=1e-6)


def test_stacked_apply_equals_per_graph_apply(data):
    """The machine stack is P independent forwards: stacking two parameter
    sets and two graphs gives each graph's own logits."""
    _, p, table, mask, _ = data
    model = build_model("SBSBS", 12, 5, hidden_dim=8)
    pa, pb = model.init(0, device="cpu"), model.init(1, device="cpu")
    stacked = {k: {n: torch.stack([pa[k][n], pb[k][n]]) for n in pa[k]}
               for k in pa}
    f = torch.from_numpy(p.features)
    t, m = torch.from_numpy(table), torch.from_numpy(mask)
    out = model.apply_stacked(stacked, torch.stack([f, f.flip(0)]),
                              torch.stack([t, t]), torch.stack([m, m]))
    torch.testing.assert_close(out[0], model.apply(pa, f, t, m), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(out[1], model.apply(pb, f.flip(0), t, m),
                               rtol=0, atol=1e-6)
