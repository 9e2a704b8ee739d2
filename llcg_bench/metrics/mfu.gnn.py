"""Per-layer metric mfu.gnn: see ``llcg_bench.readers.mfu``."""
from llcg_bench.readers import mfu as read  # noqa: F401
