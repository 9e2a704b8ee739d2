"""The general harness: the manifest, discovery by name, the measured
window, the profiler trace and its reduction, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name:

* ``configs/<config>.json``  — the configuration as it is run;
* ``traffic/<traffic>.json`` — the mix: its ``driver`` (a module of
  ``drivers/``) and the parameters that driver reads;
* ``limits/<cell>.json``     — the limit of every number that decides
  ``correct`` (with the readings it was set from);
* ``metrics/<metric>.py``    — the reader of a per-layer metric: a
  ``read(ctx)`` that returns the value, or None where it finds nothing.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that may not be loaded in a run: JAX and the JAX
#: package (compared as whole names; the port's own name is another).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# --------------------------------------------------------------------------
# manifest and discovery
# --------------------------------------------------------------------------
def manifest(root: pathlib.Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def data_file(kind: str, name: str) -> Dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict            # the configuration file's content
    traffic: Dict           # the traffic file's content
    limits: Dict            # limit per compared number (may be empty)
    end_to_end: List[Dict]  # the manifest entries this cell reports
    per_layer: List[Dict]


def reports(metric: Dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells its
    ``workloads`` list names, every cell without one."""
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, man: Optional[Dict] = None) -> Cell:
    man = man if man is not None else manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = data_file("traffic", w["traffic"])
    lim_path = HERE / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    e2e = [m for m in man["end_to_end"] if reports(m, name)]
    per_layer = [m for m in man["per_layer"] if reports(m, name)]
    return Cell(name=name, config=config, traffic=traffic,
                limits=limits.get("limits", {}), end_to_end=e2e,
                per_layer=per_layer)


def driver(cell: Cell):
    return importlib.import_module(
        f"llcg_bench.drivers.{cell.traffic['driver']}")


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"llcg_bench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    each module compared by its part before the first dot, whole."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN_MODULES))


# --------------------------------------------------------------------------
# the measured window
# --------------------------------------------------------------------------
class Window:
    """Times ``seconds`` of back-to-back rounds on the host clock.

    ``begin()`` opens it (and starts the profiler when tracing);
    ``round_done()`` marks the end of a round; ``expired()`` says, at the
    start of a round, whether the window is over — then it closes: the last
    round's end is the window's end and the profiler stops there.  Every
    round that started inside the window is counted whole."""

    def __init__(self, seconds: float, trace: bool, device):
        self.seconds = float(seconds)
        self.trace = trace
        self.device = device
        self.t0 = None
        self.ends: List[float] = []
        self.closed = False
        self.prof = None

    def begin(self) -> None:
        self._sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self._cuda():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        self.t0 = time.perf_counter()

    def round_done(self) -> None:
        if self.t0 is not None and not self.closed:
            self.ends.append(time.perf_counter())

    def expired(self) -> bool:
        if self.closed:
            return True
        if self.t0 is None or time.perf_counter() - self.t0 < self.seconds:
            return False
        self.close()
        return True

    def close(self) -> None:
        if self.closed:
            return
        self._sync()
        self.closed = True
        if self.prof is not None:
            self.prof.stop()

    @property
    def rounds(self) -> int:
        return len(self.ends)

    @property
    def wall_s(self) -> float:
        return (self.ends[-1] - self.t0) if self.ends else float("nan")

    def round_times(self) -> List[float]:
        prev, out = self.t0, []
        for t in self.ends:
            out.append(t - prev)
            prev = t
        return out

    def _cuda(self) -> bool:
        import torch
        return torch.device(self.device).type == "cuda"

    def _sync(self) -> None:
        if self._cuda():
            import torch
            torch.cuda.synchronize()


class TimedSchedule(list):
    """A round schedule whose iteration runs ``warm`` rounds, opens the
    window and then runs rounds until it has expired.  Indexing and
    ``len`` are the list's (a long one), so a round loop that looks ahead
    sees the next round's length."""

    def __init__(self, k: int, limit: int, warm: int, window: Window):
        super().__init__([k] * limit)
        self.warm, self.window = warm, window

    def __iter__(self):
        if self.window.closed:
            yield from list.__iter__(self)
            return
        for i, k in enumerate(list.__iter__(self)):
            if i == self.warm:
                self.window.begin()
            elif i > self.warm and self.window.expired():
                return
            yield k


def percentile(xs: List[float], q: float) -> float:
    """The ``q`` quantile of ``xs`` by linear interpolation between the
    order statistics (numpy's default rule)."""
    s = sorted(xs)
    if not s:
        return float("nan")
    pos = (len(s) - 1) * q
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------
def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def trace_context(window: Window) -> Dict:
    """The window's profiler trace reduced to what the readers use:
    ``device`` (name, start, end) of every device operation, ``kernels``
    (the launches, copies left out), ``busy_s`` (the union of the device
    intervals), the window's length and rounds, and the breakdown."""
    import torch
    ctx: Dict[str, Any] = {"window_s": window.wall_s,
                           "rounds": window.rounds,
                           "round_times": window.round_times()}
    if window.prof is None:
        return ctx
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in window.prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (e.name(), s, s + e.duration_ns())
        (dev if e.device_type() == cuda else host).append(item)
    dev.sort(key=lambda x: x[1])
    merged: List[List[int]] = []
    for _, s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_ns = sum(t - s for s, t in merged)
    ctx.update(device=dev, busy_s=busy_ns / 1e9,
               kernels=[x for x in dev if not _is_copy(x[0])])
    by_name = collections.Counter()
    for name, s, t in dev:
        by_name[name] += t - s
    top = by_name.most_common(10)
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    host.sort(key=lambda x: x[1])
    starts = [h[1] for h in host]
    idle = []
    for length, a, b in gaps[:10]:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        label = "host: no op recorded"
        for name, s, t in reversed(host[max(0, i - 20000):i]):
            if t >= mid:
                label = name
                break
        idle.append([label[:120], length / 1e9])
    ctx["breakdown"] = {"device_ops": [[n[:120], ns / 1e9] for n, ns in top],
                        "idle_gaps": idle}
    return ctx


# --------------------------------------------------------------------------
# the result
# --------------------------------------------------------------------------
def decide(readings: Dict[str, float], limits: Dict[str, float]
           ) -> Tuple[bool, Dict[str, Dict]]:
    """``correct`` — every number the cell's limits name read, finite and
    within its limit — and those numbers with their limits.  A cell with
    no limits is not correct."""
    checks, ok = {}, bool(limits)
    for name, lim in limits.items():
        value = readings.get(name)
        good = (value is not None and math.isfinite(value) and value <= lim)
        ok = ok and good
        checks[name] = {"value": value, "limit": lim}
    return ok, checks


def print_result(result: Dict, checks: Dict[str, Dict]) -> None:
    """The checks as the last lines on standard error, then the result as
    the last line of standard output, the checks under its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
