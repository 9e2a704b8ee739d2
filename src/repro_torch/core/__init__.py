"""LLCG core: schedules, the per-machine round, the engine and the
TrainPlan API."""
