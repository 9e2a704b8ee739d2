"""The ``shard_map`` backend — one process per machine over gloo — against
the port's ``vmap`` backend and the JAX package's ``shard_map`` backend.

The four engine modes run at P = 2 and 4 on the CPU, each rank holding its
own machine, against the vmap backend on the same inputs:

* ``local`` with ``int8_ef`` (the all-gather of compressed payloads,
  dequantized and averaged on every rank as the vmap backend computes it):
  bit for bit — parameters, losses, scores;
* ``local`` (parameter all-reduce), ``sync`` (per-step gradient
  all-reduce) and ``halo`` with the int8 codec (per-step all-gather of the
  send buffer): within 1e-4, the reference's own bound between its two
  backends (``tests/test_engine.py``) — an all-reduce sums in another order
  than the vmap mean;
* every rank's collective operands priced as the trainer's accounting
  prices them: averaging payloads up + down, each halo buffer to the P−1
  other machines, gradients up + down (``sync`` mode's host-materialized
  halo rows move in no collective; the accounting prices their ideal
  bytes).

One run is held against the JAX package's ``shard_map`` backend (in a
subprocess with forced host devices, as ``tests/test_gnn_sharded.py``
runs it) within 1e-4; a checkpointed run resumes bit for bit on every rank
from the lead rank's file, whose layout is the vmap backend's; and one
SIGKILL chaos trial kills and resumes a two-rank run.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan as P
from repro_torch.graph.datasets import sbm_graph
from repro_torch.launch.mesh import launch_machines
from repro_torch.models.gnn.model import build_model
from repro_torch.utils.pytree import tree_leaves

TOL = 1e-4
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

# mode name: (canned plan, CommSpec codecs, SamplerSpec placement)
MODES = {
    "local": ("llcg", {}, "host"),
    "local_comp": ("llcg", {"compression": "int8_ef"}, "device"),
    "sync": ("ggs", {"host_halo": True}, "host"),
    "halo": ("ggs", {"halo_compression": "int8"}, "host"),
}


def _setting(mode, machines):
    kind, comm, placement = MODES[mode]
    data = sbm_graph(num_nodes=160, num_classes=4, feature_dim=8, seed=0)
    model = build_model("SBSBS", 8, 4, hidden_dim=16)
    cfg = P.DistConfig(num_machines=machines, rounds=2, local_k=2,
                       batch_size=8, server_batch_size=16, fanout=5,
                       partition_method="random", seed=0)
    plan = {"llcg": P.llcg_plan, "ggs": P.ggs_plan}[kind](cfg)
    plan = dataclasses.replace(
        plan, comm=dataclasses.replace(plan.comm, **comm),
        sampler=dataclasses.replace(plan.sampler, placement=placement))
    return data, model, plan


def _modes_rank(mesh, modes):
    """Every mode's run on this rank; the lead returns the Histories and
    every rank's collective operand bytes per run."""
    out = {}
    for mode in modes:
        mesh.wire_bytes.clear()
        data, model, plan = _setting(mode, mesh.size)
        hist = P.build_trainer(data, model, plan, backend="shard_map",
                               mesh=mesh).run()
        out[mode] = (hist, mesh.gather_wire_bytes())
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda m: f"P{m}")
def runs(request):
    machines = request.param
    shard = launch_machines(_modes_rank, machines, sorted(MODES),
                            device="cpu")
    vmap = {mode: P.build_trainer(*_setting(mode, machines),
                                  device="cpu").run() for mode in MODES}
    return machines, shard, vmap


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_vmap_backend(runs, mode):
    machines, shard, vmap = runs
    hist, _ = shard[mode]
    ref = vmap[mode]
    assert hist.meta["device"] == "cpu"
    assert hist.rounds == ref.rounds and hist.steps_cum == ref.steps_cum
    assert hist.bytes_cum == ref.bytes_cum
    ours = tree_leaves(hist.meta["final_params"])
    theirs = tree_leaves(ref.meta["final_params"])
    if mode == "local_comp":
        assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
        assert hist.meta["local_loss"] == ref.meta["local_loss"]
        assert hist.meta["corr_loss"] == ref.meta["corr_loss"]
        assert (hist.train_loss, hist.val_score) == (ref.train_loss,
                                                     ref.val_score)
        return
    assert max(float((a - b).abs().max()) for a, b in zip(ours, theirs)) \
        <= TOL
    for key in ("local_loss", "corr_loss"):
        np.testing.assert_allclose(hist.meta[key], ref.meta[key], rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(hist.train_loss, ref.train_loss, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_collective_bytes_equal_the_accounting(runs, mode):
    machines, shard, _ = runs
    hist, wire = shard[mode]
    assert len(wire) == machines
    total = lambda kind: sum(w.get(kind, 0) for w in wire)
    # up + down per machine for the averaging payloads and the gradients;
    # each machine's halo buffer reaches the P-1 others; sync mode's halo
    # rows are materialized on the host, priced at the ideal halo bytes
    priced = (2 * total("averaging") + 2 * total("gradients")
              + (machines - 1) * total("halo"))
    if mode == "sync":
        steps = hist.steps_cum[-1] // machines
        priced += steps * hist.meta["halo_bytes_per_step"]
    assert priced == hist.bytes_cum[-1]
    assert (total("halo") > 0) == (mode == "halo")
    assert (total("gradients") > 0) == (mode in ("sync", "halo"))


# --------------------------------------------------------------------------
# against the JAX package's shard_map backend
# --------------------------------------------------------------------------
_JAX_RUN = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json
import jax
import numpy as np
from repro.distributed.gnn_sharded import ShardedGNNConfig, ShardedGNNTrainer
from repro.graph import sbm_graph
from repro.models.gnn import build_model

cfg = ShardedGNNConfig(**json.loads(os.environ["CFG"]))
data = sbm_graph(num_nodes=160, num_classes=4, feature_dim=8, seed=0)
model = build_model("GG", data.feature_dim, data.num_classes, hidden_dim=16)
out = ShardedGNNTrainer(data, model, cfg).run()
print(json.dumps({"val": out["val_score"], "local": out["local_loss"],
                  "corr": out["corr_loss"],
                  "params": [np.asarray(x).ravel().tolist() for x in
                             jax.tree_util.tree_leaves(out["final_params"])]}))
"""


def test_sharded_trainer_matches_jax_shard_map_backend():
    from repro_torch.distributed import ShardedGNNConfig, ShardedGNNTrainer
    kw = dict(num_machines=2, rounds=2, local_k=2, batch_size=8, fanout=5,
              sampler_placement="device", seed=0)
    env = dict(os.environ, PYTHONPATH=SRC, CFG=json.dumps(kw),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_RUN], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    data = sbm_graph(num_nodes=160, num_classes=4, feature_dim=8, seed=0)
    model = build_model("GG", data.feature_dim, data.num_classes,
                        hidden_dim=16)
    got = ShardedGNNTrainer(data, model, ShardedGNNConfig(**kw),
                            device="cpu").run()
    np.testing.assert_allclose(got["local_loss"], want["local"], atol=TOL)
    np.testing.assert_allclose(got["corr_loss"], want["corr"], atol=TOL)
    np.testing.assert_allclose(got["val_score"], want["val"],
                               atol=1.0 / 32 + 1e-6)     # one eval node
    for a, b in zip(tree_leaves(got["final_params"]), want["params"]):
        np.testing.assert_allclose(a.numpy().ravel(), b, atol=TOL)


# --------------------------------------------------------------------------
# checkpoint and resume under shard_map
# --------------------------------------------------------------------------
def _resume_rank(mesh, ckpt_dir):
    data, model, plan = _setting("local_comp", mesh.size)
    plan = dataclasses.replace(plan, checkpoint=P.CheckpointSpec(
        dir=ckpt_dir, every=1, async_=False))
    full = P.build_trainer(data, model, plan, backend="shard_map",
                           mesh=mesh).run()
    resumed = P.build_trainer(data, model, plan, backend="shard_map",
                              mesh=mesh).run(resume_from=ckpt_dir,
                                             resume_step=1)
    # every rank returns its own final params: all must agree
    mine = torch.cat([x.reshape(-1) for x in
                      tree_leaves(resumed.meta["final_params"])])
    agree = mesh.all_gather([mine[None]], "check")[0]
    return full, resumed, bool((agree == agree[0]).all())


def test_resume_under_shard_map_is_bit_identical(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    full, resumed, agree = launch_machines(_resume_rank, 2,
                                           str(tmp_path / "ck"), device="cpu")
    assert agree
    for key in ("train_loss", "val_score", "bytes_cum", "steps_cum"):
        assert getattr(full, key) == getattr(resumed, key), key
    assert full.meta["local_loss"] == resumed.meta["local_loss"]
    for a, b in zip(tree_leaves(full.meta["final_params"]),
                    tree_leaves(resumed.meta["final_params"])):
        assert torch.equal(a, b)
    # the lead rank's file holds the machines' residuals in the vmap layout
    data, model, plan = _setting("local_comp", 2)
    trainer = P.build_trainer(data, model, plan, device="cpu")
    sampler = P.RoundSampler(data, model, plan, "cpu")
    program = P._PlanProgram(model, sampler, trainer.descs)
    template = program.snapshot_state(program.init_state(
        model.init(0, device="cpu")))
    tree, _ = CheckpointManager(str(tmp_path / "ck"), keep=0,
                                async_=False).restore(template, step=2)
    res = tree_leaves(tree["subs"]["local:True"]["residual"])
    assert all(r.shape[0] == 2 for r in res)
    assert any(bool(r.abs().max() > 0) for r in res)


def test_chaos_trial_under_shard_map():
    """A two-rank run SIGKILLed after round 1's checkpoint (the lead rank
    kills itself; the other rank dies with it) resumes bit-identical to an
    uninterrupted two-rank run."""
    from repro_torch.checkpoint.chaos import run_chaos
    run_chaos(backend="shard_map", machines=2, rounds=2, kill_round=1,
              device="cpu")
