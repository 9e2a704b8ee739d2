"""The reductions the per-layer metric files share.  Each takes the run's
context (``harness.trace_context`` plus what the driver adds: the FLOPs of
a round, the precision, and per kernel the ``(bytes, operations)`` of each
launch a round needs) and returns the value, or None where the trace has
nothing to read."""
from __future__ import annotations

from typing import Dict, Optional

from llcg_bench.peaks import OPS_PER_S, bound_seconds


def idle_share(ctx: Dict) -> Optional[float]:
    """Percent of the window in which no operation ran on the device."""
    if not ctx.get("device") or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def mfu(ctx: Dict) -> Optional[float]:
    """Percent of the precision's peak that the round's model FLOPs reach
    over the window's wall time."""
    if not ctx.get("rounds") or not ctx.get("window_s") \
            or "flops_per_round" not in ctx:
        return None
    rate = ctx["flops_per_round"] * ctx["rounds"] / ctx["window_s"]
    return 100.0 * rate / OPS_PER_S[ctx["precision"]]


def launches_per_round(ctx: Dict) -> Optional[float]:
    """Kernels that ran on the device a round (copies and fills left
    out)."""
    if not ctx.get("kernels") or not ctx.get("rounds"):
        return None
    return len(ctx["kernels"]) / ctx["rounds"]


def roofline(ctx: Dict, kernel: str, work: str) -> Optional[float]:
    """Percent: the least time the chip could take for the round's launches
    of ``kernel`` (``ctx["work"][work]``), over their device time in the
    trace, whose kernel names hold ``kernel``."""
    launches = ctx.get("work", {}).get(work)
    if not launches or not ctx.get("kernels"):
        return None
    ns = sum(t - s for name, s, t in ctx["kernels"] if kernel in name)
    if ns <= 0:
        return None
    least = sum(bound_seconds(b, o, ctx["precision"]) for b, o in launches)
    return 100.0 * least * ctx["rounds"] / (ns / 1e9)
