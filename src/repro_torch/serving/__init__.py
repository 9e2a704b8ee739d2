"""Serving: backend-agnostic schedulers + per-workload backends.

:mod:`repro_torch.serving.core`    — queue / bucketing; wave + slot scheduling.
:mod:`repro_torch.serving.engine`  — autoregressive LM prefill/decode backend.
:mod:`repro_torch.serving.gnn`     — partitioned-graph GNN embedding backend.
"""
