"""The GNN cell's whole run at a small size on the CPU (the harness's look
for a card skipped): correct as it stands, not correct with each fault
planted under the timed path, not correct for the control."""
import time

import pytest
import torch

from llcg_bench import faults, harness
from llcg_bench.drivers import gnn_rounds
from llcg_bench.tests import tiny

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs of many small ops: one thread each, so that test workers
    sharing the cores do not oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def planted():
    """Each fault's readings, from one set-up and one reference."""
    cell = tiny.gnn_cell()
    res = gnn_rounds.calibrate(cell, SEED, "cpu", 0.0, list(faults.FAULTS))
    return {r["fault"]: harness.decide(r["readings"], cell.limits)
            for r in res}


def test_small_run_is_correct():
    cell = tiny.gnn_cell()
    out = gnn_rounds.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    assert out["rounds"] >= 1
    ok, checks = harness.decide(out["readings"], cell.limits)
    assert ok, checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_is_not_correct(planted, fault):
    ok, checks = planted[fault]
    assert not ok, checks


def test_control_is_not_correct():
    cell = tiny.gnn_cell()
    ok, checks = harness.decide(
        gnn_rounds.control(cell, SEED, "cpu")["readings"], cell.limits)
    assert not ok, checks


def test_reference_judged_at_its_own_parameters_reads_itself():
    """``judge_at`` at the reference's own round-1 parameters gives back
    the reference's own server gradient and validation loss."""
    from llcg_bench.reference import gnn as ref_gnn
    cell = tiny.gnn_cell()
    g = gnn_rounds.make_graph(cell.config, SEED, "cpu")
    ref = gnn_rounds.reference(cell, g, SEED, "cpu")
    at = gnn_rounds.judged(cell, ref, ref)
    assert at["corr_grad1_at"] == ref["corr_grad1"]
    assert at["val_loss_at"] == ref["val_loss"][0]
    assert ref_gnn.norms({"x": torch.tensor([3.0, 4.0])}) == {"x": 5.0}


def test_another_server_batch_is_not_correct(monkeypatch):
    """A server batch other than the reference's draw reads in
    ``draw_gap``."""
    from repro_torch.core import plan
    orig = plan.RoundSampler.sample_correction

    def shifted(self):
        out = orig(self)
        return dict(out, corr_batches=out["corr_batches"].roll(1, dims=1)
                    .flip(0))
    monkeypatch.setattr(plan.RoundSampler, "sample_correction", shifted)
    cell = tiny.gnn_cell()
    out = gnn_rounds.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    assert out["readings"]["draw_gap"] > 0
    assert not harness.decide(out["readings"], cell.limits)[0]
