"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* The three GNN engine cases (local, halo, halo int8) against the JAX
  package's ``run_gnn_engine_case``, run in a subprocess with 16 host
  devices: one halo exchange's all-gather bytes equal the JAX package's
  HLO count and ``HaloProgram.gathered_bytes_per_device``.
* The smoke configs of the four architectures of the JAX dry-run test
  trace ``train_4k`` on a fake (4, 4) group (K = S = 1, as the JAX
  test lowers them): ``ok``, FLOPs and
  inter-group bytes positive, the argument bytes equal to the local
  blocks summed from the rules.
* `train()` on a production mesh (stood in for by the group's (2, 2)):
  the same finite losses on every rank.
* The sharded prefill and decode step on the same group, four smoke
  configs (head_dim-sharded, KV-head-sharded and recurrent states),
  against the unsharded model within 1e-4.
* The sharded LLCG round on a real gloo group of 4 CPU ranks, (2, 2)
  ``data`` × ``model``, for the rwkv6 and gemma3 smoke configs: held to
  the unsharded round leaf by leaf by ``tests/test_torch_llcg_steps.py``'s
  rule (2e-4, elementwise, with its exception for Adam's first step), each
  rank's gradient of its group's first local step within GRAD_TOL of the
  leaf's largest (Adam's updates do not see a gradient's scale), the
  round's update within UPDATE_TOL of the unsharded one in norm, the
  losses at 1e-5, and each rank's counted bytes equal to the dry run's
  trace of the same case.

Every process group is destroyed when its case ends (the fake ones by
``run_case``, the gloo one by ``launch_machines``).
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import launch_machines
from repro_torch.models.transformer.model import LM

ROOT = pathlib.Path(__file__).resolve().parents[1]
K, S, LR, SLR = 2, 1, 1e-3, 5e-4
#: tests/test_torch_llcg_steps.py's rule
TOL, SIGN_FLIP_SHARE = 2e-4, 1e-3
#: a first-step gradient's tolerance, of its leaf's largest: f32 summed in
#: another order; and the round's update's, of its norm (sign flips)
GRAD_TOL, UPDATE_TOL = 1e-4, 1e-2
GLOO_ARCHS = ("rwkv6-1.6b", "gemma3-1b")
GLOO_CASE = dict(global_batch=4, seq_len=16)

_JAX_GNN = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import json
from repro.launch.dryrun import run_gnn_engine_case
out = {}
for mode, comp in (("local", "none"), ("halo", "none"), ("halo", "int8")):
    r = run_gnn_engine_case(16, mode=mode, halo_compression=comp)
    out[mode + "-" + comp] = {"ok": r.ok, "error": r.error,
                              "collective": r.collective, "meta": r.meta}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_gnn():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_GNN], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode,comp,want", [("local", "none", 0),
                                            ("halo", "none", 1_048_576),
                                            ("halo", "int8", 278_528)])
def test_gnn_engine_case_matches_jax(jax_gnn, mode, comp, want):
    res = dryrun.run_gnn_engine_case(16, mode=mode, halo_compression=comp)
    assert res.ok, res.error
    assert not dist.is_initialized()
    ref = jax_gnn[f"{mode}-{comp}"]
    assert ref["ok"], ref["error"]
    per = res.meta["all_gather_bytes_per_exchange"]
    # the JAX count is its HLO's all-gathers (its tuple-shaped all-reduces
    # escape its parser); the port counts every collective it calls
    assert per == want == ref["collective"]["all-gather"] \
        == ref["collective"]["total"]
    assert res.collective["all-reduce"] > 0
    if mode == "halo":
        assert per == res.meta["expected_all_gather_bytes"] \
            == ref["meta"]["expected_all_gather_bytes"]
        assert res.meta["halo_bytes_match"] and ref["meta"][
            "halo_bytes_match"]
        assert res.meta["exchange_bytes_per_step"] == \
            ref["meta"]["exchange_bytes_per_step"]
        # one all-gather a step, K steps
        assert res.meta["by_traffic"]["all-gather:halo"] == 4 * want


def _argument_bytes(cfg, mesh, gb, seq) -> int:
    """The round's arguments' local bytes, from the rules: each leaf's
    elements over the product of the axes that shard its dims."""
    sizes = mesh.shape

    def local(shape, spec):
        n = math.prod(shape)
        for entry in spec:
            for axis in (entry if isinstance(entry, tuple)
                         else (entry,) if entry else ()):
                n //= sizes[axis]
        return n

    shapes = LM(cfg).param_specs()
    G = sizes["data"]
    total = 0
    for with_group in (True, False):
        specs = sharding.param_pspecs(shapes, cfg, mesh,
                                      group_axis="data" if with_group
                                      else None)
        for (_, s), (_, p) in zip(sharding._paths(shapes),
                                  sharding._paths(specs)):
            shape = ((G,) if with_group else ()) + s.shape
            n = local(shape, p)
            # params_G and the local Adam moments; the server's moments
            total += n * (4 + 8) if with_group else n * 8
    lb = sharding.batch_pspec(mesh, stacked_group=True, extra_leading=1)
    cb = sharding.batch_pspec(mesh, extra_leading=1)
    total += 2 * 4 * local((G, 1, gb // G, seq), lb + (None,))
    total += 2 * 4 * local((1, gb, seq), cb + (None,))
    return total


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-moe-a2.7b",
                                  "zamba2-7b", "rwkv6-1.6b"])
def test_smoke_configs_trace_train_4k_on_a_fake_group(arch):
    cfg = get_smoke_config(arch)
    res = dryrun.run_case(arch, "train_4k", False, cfg_override=cfg,
                          mesh_shape=(4, 4), llcg_k=1, llcg_s=1)
    assert not dist.is_initialized()
    assert res.ok, res.error
    assert res.mesh == "4x4" and res.lower_s > 0
    assert res.flops > 0
    assert res.collective["inter_group"] > 0
    assert res.collective["intra_group"] > 0
    assert set(res.collective["by_span"]) == {"data", "model"}
    mesh = sharding.MeshSpec((4, 4), ("data", "model"))
    assert res.memory["argument_size_in_bytes"] == _argument_bytes(
        cfg, mesh, 256, 4096)
    assert res.memory["temp_size_in_bytes"] > 0


def test_a_real_group_is_refused():
    with dryrun.fake_group(2):
        with pytest.raises(RuntimeError, match="no process group"):
            with dryrun.fake_group(2):
                pass
        res = dryrun.run_case("gemma3-1b", "train_4k", False,
                              cfg_override=get_smoke_config("gemma3-1b"),
                              mesh_shape=(2, 1))
        assert not res.ok and "no process group" in res.error
    assert not dist.is_initialized()


def test_expert_hint_changes_no_number():
    """The dry run's expert-axis hint names the axis the sharded MoE sums
    its experts over, which the rules put on ``model`` either way."""
    from repro_torch.distributed.hints import get_hint, set_hint
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    runs = [dryrun.run_case("qwen3-moe-30b-a3b", "decode_32k", False,
                            cfg_override=cfg, mesh_shape=(2, 2),
                            expert_hint=hint) for hint in (False, True)]
    assert get_hint("expert_axis") == "model"
    set_hint("expert_axis", None)
    set_hint("expert_axis_size", 0)
    for r in runs:
        assert r.ok, r.error
    assert runs[0].collective == runs[1].collective
    assert runs[0].flops == runs[1].flops
    with pytest.raises(KeyError):
        set_hint("no_such_hint", None)


SERVE_ARCHS = ("gemma3-1b", "rwkv6-1.6b", "zamba2-7b", "qwen3-moe-30b-a3b")
SERVE_B, SERVE_T, SERVE_MAX = 4, 12, 16


def _serve_on_rank(arch: str):
    """The sharded prefill and one decode step on this rank against the
    unsharded ones, each state leaf against its block under the state
    rules: the largest error relative to max(1, max|unsharded|), and
    whether the positions are equal.  gemma3's cache puts head_dim on
    ``model`` (one KV head), qwen3's its KV heads; rwkv6's and zamba2's
    recurrent states are gathered and sliced back."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.steps import (build_decode_step,
                                               build_prefill_step)
    from repro_torch.utils.pytree import tree_map
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_smoke_config(arch)
    model = LM(cfg)
    coord = dict(zip(("data", "model"), mesh.get_coordinate()))
    block = lambda x, sp: sharding.local_shard(x, sp, mesh, coord)
    params = model.init(0, "cpu")
    specs = sharding.param_pspecs(model.param_specs(), cfg, mesh)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_T)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (SERVE_B,)).astype(np.int32))
    sspec = dryrun._state_pspecs(dryrun.state_specs(model, SERVE_B,
                                                    SERVE_MAX), cfg, mesh)
    bs = (sharding.batch_pspec(mesh),)
    local = tree_map(block, params, specs)
    logits, states = build_prefill_step(model, SERVE_MAX, mesh=mesh,
                                        state_specs=sspec)(
        local, {"tokens": block(toks, bs + (None,))})
    logits2, states2 = build_decode_step(model, SERVE_MAX, mesh=mesh,
                                         state_specs=sspec)(
        local, states, block(nxt, bs), SERVE_T)
    want, wstates = model.prefill(params, {"tokens": toks},
                                  max_seq=SERVE_MAX)
    want2, wstates2 = model.decode_step(params, wstates, nxt, SERVE_T,
                                        max_seq=SERVE_MAX)
    vocab = (specs["embed"][0] if cfg.tie_embeddings
             else specs["lm_head"][1])
    vspec = (bs[0], vocab)
    worst, positions = 0.0, True
    pairs = [(logits, block(want, vspec)), (logits2, block(want2, vspec))]
    for (_, got), (_, ref), (_, sp) in zip(
            sharding._paths(states2), sharding._paths(wstates2),
            sharding._paths(sspec)):
        if got.dtype.is_floating_point:
            pairs.append((got, block(ref, sp)))
        else:
            positions &= torch.equal(got, block(ref, sp))
    for got, ref in pairs:
        worst = max(worst, float((got.float() - ref.float()).abs().max())
                    / max(1.0, float(ref.abs().max())))
    return worst, positions


def _gloo_rounds(machine):
    """Both archs' sharded rounds, and four archs' sharded prefill and
    decode, on this rank (module-level: the spawned ranks import it)."""
    torch.manual_seed(0)
    out = {arch: dryrun.real_round(
        machine, get_smoke_config(arch), (2, 2), llcg_k=K, llcg_s=S, lr=LR,
        server_lr=SLR, device="cpu", tol=TOL, first_grads=True, **GLOO_CASE)
        for arch in GLOO_ARCHS}
    served = [None] * dist.get_world_size()
    dist.all_gather_object(served, {a: _serve_on_rank(a)
                                    for a in SERVE_ARCHS})
    out["serve"] = served
    trained = [None] * dist.get_world_size()
    dist.all_gather_object(trained, _train_on_rank())
    out["train"] = trained
    return out


def _train_on_rank():
    """``train()`` on a production mesh, the (16, 16) mesh stood in for by
    this group's (2, 2), checkpointing: each round's losses and
    ``comm_mb`` on this rank, and, on the ranks of group 0, whether the
    last checkpoint under ``model<m>`` restores the rank's block of the
    copy (None elsewhere)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.store import restore_checkpoint
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.utils.pytree import tree_leaves, tree_map
    where = [tempfile.mkdtemp(prefix="sharded-ckpt-")
             if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(where, src=0)
    real = ttrain.make_production_mesh
    ttrain.make_production_mesh = lambda multi_pod=False, device_type="cuda": \
        make_device_mesh((2, 2), ("data", "model"), device_type)
    try:
        params_G, metrics = ttrain.train(ttrain.TrainConfig(
            arch="rwkv6-1.6b", rounds=2, batch_per_group=2, seq_len=16,
            mesh="production", ckpt_dir=where[0]), device="cpu")
        mesh = ttrain.make_production_mesh()
    finally:
        ttrain.make_production_mesh = real
    coord = dict(zip(("data", "model"), mesh.get_coordinate()))
    restored = None
    if coord["data"] == 0:
        mine = tree_map(lambda x: x[0], params_G)
        back = restore_checkpoint(f"{where[0]}/model{coord['model']}",
                                  mine)[0]
        restored = all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(back), tree_leaves(mine)))
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(where[0], ignore_errors=True)
    return {"losses": [(h["local_loss"], h["corr_loss"])
                       for h in metrics["history"]],
            "comm_mb": [h["comm_mb"] for h in metrics["history"]],
            "restored": restored}


@pytest.fixture(scope="module")
def gloo_rounds():
    out = launch_machines(_gloo_rounds, 4, device="cpu")
    assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_round_on_gloo_matches_unsharded(gloo_rounds, arch):
    records = gloo_rounds[arch]
    assert len(records) == 4
    assert sorted((r["coord"]["data"], r["coord"]["model"])
                  for r in records) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in records:
        for key in ("local_loss", "corr_loss"):
            assert r["losses"][key] == pytest.approx(r["ref_losses"][key],
                                                     rel=1e-5)
        for name, leaf in r["leaves"].items():
            assert leaf["off"] <= SIGN_FLIP_SHARE * leaf["n"], (name, leaf)
            assert leaf["err"] <= 2 * (LR * K + SLR * S), (name, leaf)
            assert leaf["undetermined_ok"], (
                name, "an element differs whose first-step gradients are "
                      "all above the floor")
            assert leaf["grad_err"] <= GRAD_TOL, (name, leaf)
            assert leaf["update_err"] <= UPDATE_TOL, (name, leaf)
    trace = dryrun.run_case(arch, "train_4k", False,
                            cfg_override=get_smoke_config(arch),
                            mesh_shape=(2, 2), remat=False, **GLOO_CASE)
    assert trace.ok, trace.error
    want = {k: v for k, v in trace.collective.items()}
    for r in records:
        assert r["collective"] == want, r["coord"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_on_gloo_match_unsharded(gloo_rounds,
                                                            arch):
    """Every rank's logits (its vocab slice) and decode states (its blocks
    under the state rules) within 1e-4 of the unsharded model's, the
    cache positions equal."""
    for rank in gloo_rounds["serve"]:
        worst, positions = rank[arch]
        assert worst <= 1e-4 and positions, (arch, worst, positions)


def test_train_on_a_production_mesh_runs_the_sharded_round(gloo_rounds):
    """Every rank of the group trains the same rounds: finite losses,
    equal on every rank (each rank's loss is the global one), the paper's
    accounting of the whole model (2·G·its MB a round), and a checkpoint
    of every model block from group 0 that restores it."""
    runs = gloo_rounds["train"]
    assert len(runs) == 4 and len(runs[0]["losses"]) == 2
    shapes = LM(get_smoke_config("rwkv6-1.6b")).param_specs()
    mb = sum(math.prod(s.shape) * 4 for _, s in sharding._paths(shapes)) / 1e6
    for run in runs:
        assert run["losses"] == runs[0]["losses"]
        assert all(math.isfinite(x) for pair in run["losses"] for x in pair)
        assert run["comm_mb"] == pytest.approx([4 * mb, 8 * mb])
    assert sorted(r["restored"] for r in runs
                  if r["restored"] is not None) == [True, True]
