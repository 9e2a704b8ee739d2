"""LLCG core: schedules, the per-machine round, the engine, the TrainPlan
API, the paper's strategies and the Section-4 estimators.

* :mod:`repro_torch.core.plan`       — the composable TrainPlan API, lowered
  by one entry point (:func:`build_trainer`) onto the round engine.
* :mod:`repro_torch.core.strategies` — PSGD-PA (Alg. 1), LLCG (Alg. 2), GGS
  and the single-machine reference as one-line canned plans.
* :mod:`repro_torch.core.theory`     — estimators for κ²_A, κ²_X, σ²_bias,
  σ²_var and the Theorem-1 residual bound.
"""
from repro_torch.core.schedules import (
    KBucketing, local_epoch_schedule, num_rounds_for_budget,
)
from repro_torch.core.machine import (
    MachineStep, make_machine_step, make_eval_fn, make_loss_fn,
    make_local_round,
)
from repro_torch.core.engine import (
    EngineConfig, EngineState, History, ResumePoint, RoundInputs,
    RoundProgram, pad_inputs_to_bucket, run_schedule,
)
from repro_torch.core.plan import (
    BACKENDS,
    BUCKET_MODES,
    PHASE_KINDS,
    PLACEMENTS,
    CheckpointSpec,
    CommSpec,
    CompileSpec,
    LocalSpec,
    PlanTrainer,
    RoundPhase,
    RoundSampler,
    SamplerSpec,
    ScheduleSpec,
    ServerSpec,
    TrainPlan,
    averaging,
    build_trainer,
    correction,
    ggs_plan,
    halo_exchange,
    llcg_plan,
    local_steps,
    lower_plan,
    psgd_pa_plan,
    single_machine_plan,
)
from repro_torch.core.strategies import (
    run_psgd_pa,
    run_llcg,
    run_ggs,
    run_single_machine,
    DistConfig,
)
from repro_torch.core.theory import (
    DiscrepancyEstimate,
    estimate_discrepancies,
    theorem1_residual,
)

__all__ = [
    "BACKENDS",
    "BUCKET_MODES",
    "PHASE_KINDS",
    "PLACEMENTS",
    "CheckpointSpec",
    "CommSpec",
    "CompileSpec",
    "LocalSpec",
    "PlanTrainer",
    "RoundPhase",
    "RoundSampler",
    "SamplerSpec",
    "ScheduleSpec",
    "ServerSpec",
    "TrainPlan",
    "averaging",
    "build_trainer",
    "correction",
    "ggs_plan",
    "halo_exchange",
    "llcg_plan",
    "local_steps",
    "lower_plan",
    "psgd_pa_plan",
    "single_machine_plan",
    "KBucketing",
    "local_epoch_schedule",
    "num_rounds_for_budget",
    "pad_inputs_to_bucket",
    "MachineStep",
    "make_machine_step",
    "make_eval_fn",
    "make_loss_fn",
    "make_local_round",
    "EngineConfig",
    "EngineState",
    "ResumePoint",
    "RoundInputs",
    "RoundProgram",
    "run_schedule",
    "History",
    "run_psgd_pa",
    "run_llcg",
    "run_ggs",
    "run_single_machine",
    "DistConfig",
    "DiscrepancyEstimate",
    "estimate_discrepancies",
    "theorem1_residual",
]
