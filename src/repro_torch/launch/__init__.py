"""Launch helpers: preemption-safe resume of plan runs
(:mod:`repro_torch.launch.train`) and the machine groups of the
``shard_map`` backend (:mod:`repro_torch.launch.mesh`)."""
