"""Per-layer metric round_p90_ms.llcg: the 90th percentile of the rounds'
host-clock times in the window (a window of ~20 rounds has too few rounds
beyond its 90th percentile for an end-to-end tail)."""
from llcg_bench.harness import percentile


def read(ctx):
    times = ctx.get("round_times")
    return percentile(times, 0.9) * 1e3 if times else None
