"""Per-layer metric backward_ms.llcg: device ms a round in the backward
passes of the local and the server steps (the ``step.backward`` spans;
``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "step.backward")
