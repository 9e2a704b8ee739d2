"""Global sharding hints that the sharded model code reads, as the JAX
package's ``distributed/hints.py``.

The model stays mesh-agnostic; the dry run sets these before it traces.
``expert_axis`` names the mesh axis over which the sharded MoE sums its
experts' partial outputs (None: the ``model`` axis, which is where the
rules put the experts either way, so the hint changes no number);
``expert_axis_size`` is that axis's size (0 when unset).
"""
from __future__ import annotations

from typing import Optional

_HINTS = {"expert_axis": None, "expert_axis_size": 0}


def set_hint(name: str, value: Optional[str]) -> None:
    if name not in _HINTS:
        raise KeyError(name)
    _HINTS[name] = value


def get_hint(name: str) -> Optional[str]:
    return _HINTS[name]
