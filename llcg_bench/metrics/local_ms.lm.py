"""Per-layer metric local_ms.lm: device ms a round in the G machines' K
local steps of the LM round (the ``round.local`` spans of
``distributed/steps.py``; ``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "round.local")
