"""The program's spans of the window's rounds, read from the port's tracer
(``repro_torch.utils.logging``): device milliseconds a round per span name.

In a traced run the profiler runs only inside the window, and a running
profiler turns the port's span recording on, so the tracer's buffer holds
the window's rounds.  The window's rounds are the last ``ctx["rounds"]``
``round`` spans; a span belongs to the round whose ``round`` span it lies
under.  A span's device time is its two CUDA events' ``elapsed_time``,
read after the window has closed and synchronized.  A program without the
tracer, a buffer without the window's rounds, or spans without CUDA events
read None.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def _buffer() -> Optional[List]:
    try:
        from repro_torch.utils import logging as tracer
    except ImportError:
        return None
    spans = getattr(tracer, "spans", None)    # the tracer came later
    return spans() if spans else None


def window_spans(ctx: Dict, buffer: Optional[List]) -> List:
    """The spans of ``buffer`` under the window's ``round`` spans (those
    included), or none where it does not hold the window's rounds."""
    rounds = ctx.get("rounds")
    if not rounds or not buffer:
        return []
    roots = [s for s in buffer if s.name == "round"]
    if len(roots) < rounds:
        return []
    roots = {id(s) for s in roots[-rounds:]}
    out = []
    for s in buffer:
        node = s
        while node is not None and id(node) not in roots:
            node = node.parent
        if node is not None:
            out.append(s)
    return out


def device_ms_per_round(ctx: Dict, name: str) -> Optional[float]:
    """The summed device milliseconds of the window's spans named ``name``
    over the window's rounds; None where no such span has device
    events."""
    times = [s.start_event.elapsed_time(s.end_event)
             for s in window_spans(ctx, _buffer())
             if s.name == name and s.end_event is not None]
    return sum(times) / ctx["rounds"] if times else None
