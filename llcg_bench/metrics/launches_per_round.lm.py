"""Per-layer metric launches_per_round.lm: see ``llcg_bench.readers.launches_per_round``."""
from llcg_bench.readers import launches_per_round as read  # noqa: F401
