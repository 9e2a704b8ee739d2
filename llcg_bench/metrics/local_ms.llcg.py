"""Per-layer metric local_ms.llcg: device ms a round in the machines' K
local steps (the ``round.local`` spans; ``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "round.local")
