"""Per-layer metric optimizer_ms.lm: device ms a round in the LM round's
Adam steps, local and server (the ``step.optimizer`` spans of
``distributed/steps.py``; ``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "step.optimizer")
