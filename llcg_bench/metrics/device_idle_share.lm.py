"""Per-layer metric device_idle_share.lm: see ``llcg_bench.readers.idle_share``."""
from llcg_bench.readers import idle_share as read  # noqa: F401
