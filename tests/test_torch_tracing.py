"""The port's spans (``repro_torch.utils.logging``): what a span records
when the tracer is off, enabled and under a running ``torch.profiler``,
and the spans of the LLCG and GGS round loops.

The card test at the end profiles two rounds of a small plan on the GPU
and skips without one; run it there with
``PYTHONPATH=src python -m pytest -q tests/test_torch_tracing.py``.
"""
import collections
import dataclasses
import time
import types

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch.core import plan as P
from repro_torch.graph.datasets import sbm_graph
from repro_torch.models.gnn.model import build_model
from repro_torch.utils import logging as tracer

PHASES = ("round.draw", "round.local", "round.average", "round.correction",
          "round.evaluate")
STEPS = ("step.forward", "step.backward", "step.optimizer")
SPAN_NAMES = {"round", *PHASES, *STEPS}


@pytest.fixture(autouse=True)
def clean_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


def test_off_a_span_records_nothing_and_still_times():
    with tracer.Timer("outer") as outer:
        with tracer.Timer("inner") as inner:
            time.sleep(0.002)
    assert tracer.spans() == []
    assert outer.elapsed >= inner.elapsed >= 0.002
    for s in (outer, inner):
        assert s.parent is None and s.start_ns is None
        assert s.start_event is None


def test_enabled_spans_record_names_parents_and_the_round():
    tracer.enable()
    with tracer.Timer("round", round=7) as root:
        with tracer.Timer("round.local") as local:
            with tracer.Timer("step.forward") as fwd:
                pass
        with tracer.Timer("round.evaluate") as ev:
            pass
    with tracer.Timer("lm.round") as alone:
        pass
    tracer.disable()
    with tracer.Timer("after"):
        pass
    got = tracer.spans()
    assert [s.name for s in got] == ["step.forward", "round.local",
                                     "round.evaluate", "round", "lm.round"]
    assert fwd.parent is local and local.parent is root
    assert ev.parent is root and root.parent is None
    assert alone.parent is None and alone.round is None
    assert {s.round for s in got[:4]} == {7}
    for s in got:
        assert s.start_ns <= s.end_ns and s.elapsed >= 0
        assert s.start_event is None          # no CUDA in this process
    assert root.start_ns <= local.start_ns <= fwd.start_ns
    assert fwd.end_ns <= local.end_ns <= ev.start_ns <= root.end_ns
    tracer.reset()
    assert tracer.spans() == []


def _profiled(fn):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        fn()
    finally:
        prof.stop()
    return prof


@pytest.mark.parametrize("enabled", [False, True])
def test_a_running_profiler_records_spans(enabled):
    """Recording follows the profiler whatever ``enable()`` says while it
    runs, and stops with it unless the tracer is enabled."""
    if enabled:
        tracer.enable()

    def body():
        with tracer.Timer("round", round=1):
            with tracer.Timer("round.local"):
                torch.ones(4).add_(1)

    _profiled(body)
    assert [s.name for s in tracer.spans()] == ["round.local", "round"]
    with tracer.Timer("later"):
        pass
    assert len(tracer.spans()) == (3 if enabled else 2)


def test_under_the_profiler_a_span_is_a_host_event_and_no_annotation():
    def body():
        with tracer.Timer("round", round=1):
            with tracer.Timer("round.correction"):
                torch.ones(8).mul_(2)

    prof = _profiled(body)
    buffered = {s.name: s for s in tracer.spans()}
    host = {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.name() in buffered}
    assert set(host) == set(buffered)
    for name, e in host.items():
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert abs(e.start_ns() - buffered[name].start_ns) < 1_000_000
    for evt in prof.events():
        if evt.name in buffered:
            assert not evt.is_user_annotation


def _plan_setting(kind, placement="host", rounds=2, k=3, s=2):
    data = sbm_graph(num_nodes=160, num_classes=3, feature_dim=8, seed=0)
    model = build_model("SBSBS", 8, 3, hidden_dim=16)
    cfg = P.DistConfig(num_machines=2, rounds=rounds, local_k=k,
                       correction_steps=s, batch_size=8,
                       server_batch_size=16, fanout=4,
                       partition_method="random", seed=0)
    plan = {"llcg": P.llcg_plan, "ggs": P.ggs_plan}[kind](cfg)
    return data, model, dataclasses.replace(
        plan, sampler=dataclasses.replace(plan.sampler, placement=placement))


def _by_round(spans):
    """``{round: Counter of the names under that round's span}``."""
    roots = {id(s): s.round for s in spans if s.name == "round"}
    out = collections.defaultdict(collections.Counter)
    for s in spans:
        node = s
        while node is not None and id(node) not in roots:
            node = node.parent
        if node is not None:
            out[roots[id(node)]][s.name] += 1
    return dict(out)


@pytest.mark.parametrize("kind, phases, steps", [
    ("llcg", PHASES, 3 + 2),
    ("ggs", ("round.draw", "round.local", "round.evaluate"), 3),
])
def test_round_loop_spans_each_phase_once_and_every_step(kind, phases,
                                                         steps):
    """K + S forward, backward and optimizer steps a LLCG round (the S
    server steps under the correction), K a GGS round; one span per
    phase, each carrying its round."""
    data, model, plan = _plan_setting(kind)
    tracer.enable()
    P.build_trainer(data, model, plan, device="cpu").run()
    tracer.disable()
    got = tracer.spans()
    want = collections.Counter({"round": 1, **{p: 1 for p in phases},
                                **{s: steps for s in STEPS}})
    assert _by_round(got) == {1: want, 2: want}
    assert all(s.round in (1, 2) for s in got)
    for s in got:
        if s.name in STEPS:
            assert s.parent.name in ("round.local", "round.correction")
        elif s.name != "round":
            assert s.parent.name == "round"
    if kind == "llcg":
        server = [s for s in got if s.name == "step.optimizer"
                  and s.parent.name == "round.correction"]
        assert len(server) == 2 * 2


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: spans time on the card's events")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _device_profile(data, model, plan):
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        P.build_trainer(data, model, plan, device="cuda").run()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def _kernels(names):
    return [n for n in names
            if not n.startswith(("Memcpy", "Memset", "memcpy", "memset"))]


@pytest.mark.gpu
def test_spans_add_no_device_event_and_nest_on_the_card(cuda, monkeypatch):
    """Two LLCG rounds with the device draw on its side stream, profiled
    with the spans and with them held off: the same kernels, no device
    event named as a span, and each span's device interval inside its
    parent's."""
    data, model, plan = _plan_setting("llcg", placement="device")
    P.build_trainer(data, model, plan, device="cuda").run()     # warm
    traced = _device_profile(data, model, plan)
    spans = tracer.spans()
    tracer.reset()
    with monkeypatch.context() as m:
        m.setattr(tracer, "_profiler",
                  types.SimpleNamespace(_is_profiler_enabled=False))
        plain = _device_profile(data, model, plan)
    assert tracer.spans() == []
    assert not SPAN_NAMES & set(traced)
    assert len(_kernels(traced)) == len(_kernels(plain)) > 0
    want = collections.Counter({"round": 1, **{p: 1 for p in PHASES},
                                **{s: 3 + 2 for s in STEPS}})
    # round 1 prefetches round 2's draw; the last round has none to make
    last = want - collections.Counter(["round.draw"])
    assert _by_round(spans) == {1: want, 2: last}
    nested = [s for s in spans if s.parent is not None]
    assert nested
    for s in spans:
        assert s.start_event is not None and s.end_event is not None
        assert s.start_event.elapsed_time(s.end_event) >= 0
    for s in nested:
        p = s.parent
        assert p.start_event.elapsed_time(s.start_event) >= 0, s.name
        assert s.end_event.elapsed_time(p.end_event) >= 0, s.name
