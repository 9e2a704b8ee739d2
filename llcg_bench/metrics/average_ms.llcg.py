"""Per-layer metric average_ms.llcg: device ms a round in the parameter
average (the ``round.average`` spans; ``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "round.average")
