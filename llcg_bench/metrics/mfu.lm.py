"""Per-layer metric mfu.lm: see ``llcg_bench.readers.mfu`` (the round's
model FLOPs from ``llcg_bench.bounds_lm``, no recomputation counted)."""
from llcg_bench.readers import mfu as read  # noqa: F401
