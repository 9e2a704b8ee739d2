"""Launch helpers: preemption-safe resume of plan runs."""
