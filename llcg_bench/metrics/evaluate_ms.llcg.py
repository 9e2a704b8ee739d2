"""Per-layer metric evaluate_ms.llcg: device ms a round in the full-
graph evaluation (the ``round.evaluate`` spans;
``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "round.evaluate")
