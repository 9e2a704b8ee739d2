"""Minimal structured logging + wall-clock timing used by launchers and
benchmarks — the port's copy of the JAX package's ``utils/logging.py``.

Loggers under ``repro_torch`` share one stderr handler, configured at the
first :func:`get_logger` call.
"""
from __future__ import annotations

import logging
import sys
import time

_CONFIGURED = False


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


class Timer:
    """Context-manager wall clock; ``Timer.elapsed`` in seconds."""

    def __init__(self, label: str = ""):
        self.label = label
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
