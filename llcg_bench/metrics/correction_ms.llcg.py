"""Per-layer metric correction_ms.llcg: device ms a round in the S
server corrections (the ``round.correction`` spans;
``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "round.correction")
