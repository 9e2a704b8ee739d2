"""Minimal structured logging, and the port's one timing primitive: the
span (:class:`Timer`).

Loggers under ``repro_torch`` share one stderr handler, configured at the
first :func:`get_logger` call.

A :class:`Timer` always measures its wall-clock ``elapsed``.  While the
tracer is on — after :func:`enable`, or while a ``torch.profiler`` runs —
it also records itself as a span in a bounded in-memory buffer
(:func:`spans`): its name, the round it belongs to, its parent span, its
host start and end on the Unix-epoch clock the profiler's events carry
(``time.time_ns()``), and, once CUDA is initialized, a timing
``torch.cuda.Event`` recorded on the current stream at entry and at exit.
Nothing reads an event while the program runs: a reader synchronizes and
calls ``start_event.elapsed_time(end_event)`` afterwards.  Under the
profiler each span is also a host event of the trace
(``torch._C._profiler._RecordFunctionFast``).  It is never a
``torch.profiler.record_function``: those ranges are user annotations,
which the profiler copies onto the device timeline as device events, and
a trace's device time and kernel count would then take them in.  When the
tracer is off a span costs one flag check: no event, no profiler call, no
synchronization.
"""
from __future__ import annotations

import collections
import logging
import sys
import time

import torch
import torch.autograd.profiler as _profiler

_CONFIGURED = False
#: Spans the buffer keeps; the oldest go first.
_MAX_SPANS = 1 << 16
_SPANS: collections.deque = collections.deque(maxlen=_MAX_SPANS)
_ENABLED = False
_OPEN: list = []                # the open recorded spans, innermost last


def get_logger(name: str = "repro_torch") -> logging.Logger:
    """The logger ``name`` (give it a ``repro_torch.`` prefix to reach the
    shared handler)."""
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S"))
        root = logging.getLogger("repro_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name)


def enable() -> None:
    """Record spans from now on (a running profiler records them anyway)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Stop recording spans outside a running profiler."""
    global _ENABLED
    _ENABLED = False


def spans() -> list:
    """The recorded spans, each :class:`Timer` as it closed, oldest first."""
    return list(_SPANS)


def reset() -> None:
    """Empty the span buffer."""
    _SPANS.clear()


class Timer:
    """Context-manager span; ``Timer.elapsed`` is its wall clock in seconds.

    ``round`` marks the span that opens a round: the spans opened inside it
    carry its value as their ``round``.  Recorded spans (see the module
    docstring) set ``parent``, ``start_ns``/``end_ns`` and, with CUDA up,
    ``start_event``/``end_event``; the others leave them None.
    """

    def __init__(self, name: str, round=None):
        self.name = name
        self.round = round
        self.parent = None
        self.elapsed = 0.0
        self.start_ns = self.end_ns = None
        self.start_event = self.end_event = None
        self._host_event = None
        self._recording = False

    def __enter__(self):
        if _ENABLED or _profiler._is_profiler_enabled:
            self._open()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self._recording:
            self._close()
        return False

    def _open(self) -> None:
        self._recording = True
        if _OPEN:
            self.parent = _OPEN[-1]
            if self.round is None:
                self.round = self.parent.round
        _OPEN.append(self)
        if _profiler._is_profiler_enabled:
            self._host_event = torch._C._profiler._RecordFunctionFast(
                self.name)
            self._host_event.__enter__()
        if torch.cuda.is_initialized():
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record()
        self.start_ns = time.time_ns()

    def _close(self) -> None:
        self.end_ns = time.time_ns()
        if self.start_event is not None:
            self.end_event = torch.cuda.Event(enable_timing=True)
            self.end_event.record()
        if self._host_event is not None:
            self._host_event.__exit__(None, None, None)
            self._host_event = None
        _OPEN.remove(self)
        _SPANS.append(self)
