"""Discovery by name, the window, the no-JAX check and the readers."""
import time

import pytest

from llcg_bench import harness, readers


def test_cells_resolve_their_files_by_name():
    man = harness.manifest()
    for w in man["workloads"]:
        cell = harness.find_cell(w["name"], man)
        assert cell.traffic == harness.data_file("traffic", w["traffic"])
        assert cell.config["name"] == w["config"]
        assert harness.driver(cell).__name__.endswith(
            cell.traffic["driver"])
    with pytest.raises(KeyError):
        harness.find_cell("no-such-cell", man)


def test_a_metric_is_reported_in_the_cells_it_lists():
    assert harness.reports({"name": "setup_s"}, "c")
    assert harness.reports({"workloads": ["c"], "moves": "x"}, "c")
    assert not harness.reports({"workloads": ["d"], "moves": "x"}, "c")


def test_readers_load_by_name():
    for m in harness.manifest()["per_layer"]:
        assert harness.reader(m["name"])({}) is None


@pytest.mark.parametrize("modules, bad", [
    ({"repro_torch", "repro_torch.core.plan", "jaxtyping", "numpy"}, []),
    ({"repro", "repro_torch"}, ["repro"]),
    ({"repro.core.engine"}, ["repro"]),
    ({"jax.numpy", "jaxlib.xla_client"}, ["jax", "jaxlib"]),
    ({"flax.linen", "reprox"}, ["flax"]),
])
def test_forbidden_modules_compare_top_level_names_whole(modules, bad):
    assert harness.forbidden_modules(modules) == bad


def test_timed_schedule_runs_warm_rounds_then_the_window():
    w = harness.Window(0.05, False, "cpu")
    sched = harness.TimedSchedule(4, 1000, 3, w)
    seen = 0
    for k in sched:
        assert k == 4
        time.sleep(0.01)
        w.round_done()
        seen += 1
    assert w.closed and 3 < seen < 1000
    assert w.rounds == seen - 3
    assert sum(w.round_times()) == pytest.approx(w.wall_s)
    assert w.wall_s >= 0.05
    assert len(set(sched)) == 1 and sched[10] == 4


def test_decide_needs_every_reading_within_its_limit():
    ok, checks = harness.decide({"a": 1.0, "b": 2.0}, {"a": 1.5, "b": 2.0})
    assert ok and checks["a"] == {"value": 1.0, "limit": 1.5}
    assert not harness.decide({"a": 1.0}, {"a": 0.5})[0]
    assert not harness.decide({"a": float("nan")}, {"a": 0.5})[0]
    assert not harness.decide({"a": 1.0}, {})[0]


def test_percentile_interpolates():
    assert harness.percentile([1, 2, 3, 4, 5], 0.9) == pytest.approx(4.6)
    assert harness.percentile([7.0], 0.9) == 7.0


def _ctx():
    dev = [("spmm_csr_kernel(int)", 0, 1_000_000),
           ("void elementwise", 500_000, 2_000_000),
           ("Memcpy HtoD", 3_000_000, 3_500_000)]
    return {"device": dev, "kernels": dev[:2], "busy_s": 2.5e-3,
            "window_s": 0.01, "rounds": 2, "flops_per_round": 67e9,
            "precision": "float32",
            "work": {"spmm_csr": [(3.35e9, 0.0)]}}


def test_readers_on_a_small_trace():
    ctx = _ctx()
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    assert readers.launches_per_round(ctx) == 1.0
    assert readers.mfu(ctx) == pytest.approx(100.0 * 134e9 / 0.01 / 67e12)
    # two rounds of a 1 ms bound against 1 ms of device time
    assert readers.roofline(ctx, "spmm_csr_kernel", "spmm_csr") == \
        pytest.approx(200.0)
    assert readers.roofline(ctx, "quantize_rows_kernel", "spmm_csr") is None
    assert readers.idle_share({"window_s": 1.0}) is None
