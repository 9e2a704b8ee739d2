"""Per-layer metric correction_ms.lm: device ms a round in the S server
corrections of the LM round (the ``round.correction`` spans of
``distributed/steps.py``; ``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "round.correction")
