"""Checkpointing: the params store (train→serve export), the async
full-state manager (exact resume) and the SIGKILL chaos harness."""
from repro_torch.checkpoint.manager import (
    CheckpointManager, CheckpointRefused, TraceCounter, digest_json,
    trace_signature,
)
from repro_torch.checkpoint.store import (
    check_cast, latest_step, load_params, restore_checkpoint,
    save_checkpoint, sweep_tmp_files,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_params", "sweep_tmp_files", "check_cast",
           "CheckpointManager", "CheckpointRefused", "TraceCounter",
           "digest_json", "trace_signature"]
