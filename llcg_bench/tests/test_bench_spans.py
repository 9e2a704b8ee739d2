"""The span readers (``llcg_bench/spans.py`` and the seven ``*_ms.llcg``
metrics) on a synthetic span buffer: the window's rounds only, each
reader's mean a round, and None without device intervals."""
import types

import pytest

from llcg_bench import harness, spans

#: device ms of each span in a window round: (parent, name, ms)
ROUND = [("round", "round.local", 200.0),
         ("round.local", "step.backward", 30.0),
         ("round.local", "step.optimizer", 2.0),
         ("round", "round.average", 0.5),
         ("round", "round.correction", 100.0),
         ("round.correction", "step.backward", 40.0),
         ("round.correction", "step.optimizer", 1.0),
         ("round", "round.evaluate", 40.0),
         ("round", "round.draw", 9.0)]
METRICS = {"local_ms.llcg": 200.0, "backward_ms.llcg": 70.0,
           "optimizer_ms.llcg": 3.0, "average_ms.llcg": 0.5,
           "correction_ms.llcg": 100.0, "evaluate_ms.llcg": 40.0,
           "draw_ms.llcg": 9.0}


class Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def span(name, parent, ms, timed=True):
    return types.SimpleNamespace(
        name=name, parent=parent, start_event=Event(0.0) if timed else None,
        end_event=Event(ms) if timed else None)


def buffer(rounds, scale=1.0, timed=True):
    """``rounds`` rounds as the tracer keeps them (children close first),
    each round's spans scaled by ``scale`` times its number."""
    out = [span("round.draw", None, 7.0, timed)]     # the prefetch before
    for r in range(1, rounds + 1):
        f = scale * r
        root = span("round", None, 500.0 * f, timed)
        made = {"round": root}
        for parent, name, ms in ROUND:
            made[name] = span(name, made[parent], ms * f, timed)
            out.append(made[name])
        out.append(root)
    return out


@pytest.fixture
def buffered(monkeypatch):
    def put(buf):
        monkeypatch.setattr(spans, "_buffer", lambda: buf)
    return put


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_each_reader_reads_its_mean_over_the_window_rounds(buffered, metric):
    """Rounds 1..4 in the buffer, the window the last 2 (3 and 4): the
    mean of 3 and 4 times a round's value, the rounds before left out."""
    buffered(buffer(4))
    got = harness.reader(metric)({"rounds": 2})
    assert got == pytest.approx(METRICS[metric] * 3.5)


@pytest.mark.parametrize("case", ["no_events", "too_few_rounds", "empty",
                                  "no_rounds"])
def test_readers_find_nothing_without_the_window(buffered, case):
    ctx = {"rounds": 3}
    if case == "no_events":
        buffered(buffer(3, timed=False))
    elif case == "too_few_rounds":
        buffered(buffer(2))
    elif case == "empty":
        buffered([])
    else:
        buffered(buffer(3))
        ctx = {}
    for metric in METRICS:
        assert harness.reader(metric)(ctx) is None


def test_the_window_holds_every_span_under_its_rounds():
    buf = buffer(3)
    got = spans.window_spans({"rounds": 2}, buf)
    assert len(got) == 2 * (len(ROUND) + 1)
    assert buf[0] not in got                 # the draw before any round
    assert all(s in got for s in buf[-2 * (len(ROUND) + 1):])
