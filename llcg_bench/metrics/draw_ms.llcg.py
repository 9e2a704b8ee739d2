"""Per-layer metric draw_ms.llcg: device ms a round in the next round's
device draw, on its side stream (the ``round.draw`` spans;
``llcg_bench.spans``)."""
from llcg_bench.spans import device_ms_per_round


def read(ctx):
    return device_ms_per_round(ctx, "round.draw")
