"""Launch helpers: the LM trainer and preemption-safe resume of plan runs
(:mod:`repro_torch.launch.train`), the machine groups of the ``shard_map``
backend and the trainer's host mesh (:mod:`repro_torch.launch.mesh`)."""
