"""The LM cell's whole run at a small size on the CPU (the harness's look
for a card skipped): correct as it stands, not correct with each fault
planted under the timed path; the reference's scan against the step-by-step
recurrence; the port's round step against the reference; the reference
imports neither the program nor JAX."""
import copy
import subprocess
import sys
import time

import pytest
import torch

from llcg_bench import faults_lm, harness
from llcg_bench.drivers import common, lm_rounds
from llcg_bench.reference import lm_rwkv6 as ref_lm

SEED = 2 ** 31 + 12345
CELL = "rwkv6-1.6b-train.llcg-long"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Small runs of many small ops: two threads each, so that test workers
    sharing the cores do not oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_limits() -> dict:
    """The cell's limits, with ``corr_gap`` at 1e-4: at 2 layers and 27
    tokens two Adam steps of the wrong sign move the correction loss ~1%
    (9.7e-3), under the cell's limit, which is set from 24 layers at 4,096
    tokens, where they move it by more than half (1.57)."""
    return dict(harness.find_cell(CELL).limits, corr_gap=1e-4)


def tiny_cell(limits=None) -> harness.Cell:
    """The cell's files with the model cut to ``get_smoke_config(
    "rwkv6-1.6b")`` (2 layers of d_model 256 in 4 heads, channel mix 512,
    vocabulary 512, float32) and sequences of 27 tokens (not a multiple of
    the scan's chunk), 2 checked and compared rounds."""
    cell = harness.find_cell(CELL)
    conf = copy.deepcopy(cell.config)
    conf["model"].update(num_layers=2, d_model=256, d_ff=512, vocab_size=512)
    conf["dtype"] = "float32"
    traffic = dict(cell.traffic, seq_len=27, check_rounds=2,
                   reference_rounds=2)
    return harness.Cell("tiny-lm", conf, traffic,
                        tiny_limits() if limits is None else limits, [], [])


@pytest.fixture(scope="module")
def planted():
    """Each fault's readings, from one reference."""
    cell = tiny_cell()
    res = lm_rounds.calibrate(cell, SEED, "cpu", 0.0,
                              [None, *faults_lm.FAULTS])
    return {r["fault"]: (harness.decide(r["readings"], cell.limits), r)
            for r in res}


def test_small_run_is_correct():
    cell = tiny_cell()
    out = lm_rounds.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    assert out["rounds"] >= 1
    ok, checks = harness.decide(out["readings"], cell.limits)
    assert ok, checks
    e2e = lm_rounds.end_to_end(out)
    assert e2e["wire_MB_per_round"] * 1e6 == 2 * 2 * 4 * out["facts"][
        "parameters"]
    work = out["ctx"]
    assert len(work["work"]["linear_scan"]) == 2 * 5 * 2   # remat: twice
    assert len(work["work"]["linear_scan_bwd"]) == 5 * 2


def test_calibration_as_it_stands_is_correct(planted):
    (ok, checks), _ = planted[None]
    assert ok, checks


@pytest.mark.parametrize("fault", faults_lm.FAULTS)
def test_planted_fault_is_not_correct(planted, fault):
    (ok, checks), _ = planted[fault]
    assert not ok, checks


@pytest.mark.parametrize("t", [1, 16, 37])
def test_reference_scan_is_the_step_recurrence(t):
    gen = torch.Generator().manual_seed(t)
    n, d = 3, 8
    q, k, v = (torch.randn(n, t, d, generator=gen, dtype=torch.float64)
               for _ in range(3))
    log_w = -torch.exp(torch.empty(n, t, d, dtype=torch.float64).uniform_(
        -5, 2, generator=gen))
    u = torch.randn(n, d, generator=gen, dtype=torch.float64)
    want = ref_lm.scan_steps(q, k, v, log_w, u)
    got = ref_lm.scan(q, k, v, log_w, u)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_tiny_cell_is_the_smoke_config():
    from repro_torch.configs import get_smoke_config
    got, want = lm_rounds.model_config(tiny_cell().config), \
        get_smoke_config("rwkv6-1.6b")
    for key in ("num_layers", "d_model", "num_heads", "d_ff", "vocab_size",
                "dtype", "norm_eps", "tie_embeddings"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.layer_plan() == want.layer_plan()


def test_round_step_against_the_reference():
    """The port's round step at the smoke config (one round, G=2, K=2,
    S=1, T=27) and the reference from the same seeded weights and
    batches: each token's loss of the step's first forward and machine
    0's first gradient against the float64 first step, the losses and the
    mean's change within float32 reorderings, and the
    server's gradient at the program's mean."""
    cell = tiny_cell()
    prog = lm_rounds.Program(cell, SEED, "cpu")
    b = prog.batches()
    losses = prog.round(b)
    server = prog.first["server"]
    mean1 = prog._change(server["params"].items())
    first = {k: x[0, 0] for k, x in b["local"].items()}
    nll64, grad64 = ref_lm.first_step(prog.params0, first,
                                      prog.mcfg.norm_eps, "cpu")
    nll1 = prog.first["nll1"].double()
    assert float((nll1 - nll64).norm() / nll64.norm()) < 1e-6
    parts = lm_rounds.layer_gaps(prog.first["local"]["tensors"], grad64)
    assert len(parts) == 2 * (len(grad64) - 3) + 3   # 2 layers a stack
    assert max(d / r for d, r in parts.values()) < 1e-4
    ref = ref_lm.llcg_rounds(prog.params0, [b], prog.mcfg.norm_eps,
                             cell.traffic["lr"], cell.traffic["server_lr"],
                             "cpu", at_mean=server["params"])
    keep = list(ref["corr_grad1_at"])
    assert common.worst_leaf_gap(server["grads"], ref["corr_grad1_at"],
                                 keep) < 1e-5
    assert common.relative_gap(losses, [ref["local_loss"][0],
                                        ref["corr_loss"][0]]) < 1e-6
    assert common.worst_leaf_gap(mean1, ref["mean1_change"],
                                 common.kept_leaves(ref["mean1_change"])) \
        < 1e-3


def test_first_step_by_block_is_the_whole_step():
    """The reference's first step a block at a time, fed the stream and
    the output gradients of its own whole step, gives the whole step's
    token losses and gradients (float64, the smoke config's size)."""
    cell = tiny_cell()
    prog = lm_rounds.Program(cell, SEED, "cpu")
    batch = {k: x[0, 0] for k, x in prog.batches()["local"].items()}
    eps = prog.mcfg.norm_eps
    nll64, grad64 = ref_lm.first_step(prog.params0, batch, eps, "cpu")
    wide = {k: v.double().requires_grad_(True)
            for k, v in prog.params0.items()}
    stream = [ref_lm.embed(wide, batch["tokens"])]
    for p in ref_lm.layers(wide):
        stream.append(ref_lm.block(p, stream[-1], eps))
    nll = ref_lm.head_nll(wide, stream[-1], batch["labels"], eps)
    cot = dict(enumerate(torch.autograd.grad(nll.mean(), stream)))
    got = {}
    slots = ref_lm.layer_slots(prog.params0)
    for piece, out, grads, d_in in ref_lm.first_step_by_block(
            prog.params0, batch, [h.detach() for h in stream], cot, eps,
            "cpu"):
        if piece == "head":
            assert torch.allclose(out, nll64.double(), rtol=1e-12)
            assert torch.allclose(d_in, cot[len(slots)], rtol=1e-12)
        elif piece != "embed":
            assert torch.allclose(out, stream[piece + 1], rtol=1e-12)
            assert torch.allclose(d_in, cot[piece], rtol=1e-12,
                                  atol=1e-18)
            grads = {slots[piece][n]: g for n, g in grads.items()}
        got.update(grads)
    assert len(got) == len(slots) * len(slots[0]) + 3
    for key, want in grad64.items():
        if key.startswith("units/"):
            for slot, g in got.items():
                if slot[0] == key:
                    _, u, c = slot
                    assert torch.allclose(g, want[u, c], rtol=1e-9,
                                          atol=1e-15), (key, u, c)
        else:
            assert torch.allclose(got[key], want, rtol=1e-9,
                                  atol=1e-15), key


def test_reference_imports_neither_the_program_nor_jax():
    code = ("import sys; import llcg_bench.reference.lm_rwkv6; "
            "from llcg_bench import harness; "
            "print(','.join(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', *harness.FORBIDDEN_MODULES})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(harness.ROOT), check=True)
    assert out.stdout.strip() == ""
