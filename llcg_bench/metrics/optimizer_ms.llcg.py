"""Per-layer metric optimizer_ms.llcg: device ms a round in the
optimizer steps, local and server (the ``step.optimizer`` spans;
``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "step.optimizer")
