"""The scan kernels' roofline shares: ``readers.roofline`` with the bound
taken at float32's peak, the precision the scan computes in, whatever the
configuration's."""
from __future__ import annotations

from typing import Dict, Optional

from llcg_bench.peaks import bound_seconds


def share(ctx: Dict, kernel: str, work: str) -> Optional[float]:
    """Percent: the least time for the round's launches of ``kernel``
    (``ctx["work"][work]``) over their device time in the trace."""
    launches = ctx.get("work", {}).get(work)
    if not launches or not ctx.get("kernels"):
        return None
    ns = sum(t - s for name, s, t in ctx["kernels"] if kernel in name)
    if ns <= 0:
        return None
    least = sum(bound_seconds(b, o, "float32") for b, o in launches)
    return 100.0 * least * ctx["rounds"] / (ns / 1e9)
