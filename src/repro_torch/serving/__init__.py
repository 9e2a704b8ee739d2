"""Serving: the wave scheduler and the LM backend.

:mod:`repro_torch.serving.core`    — queue / bucketing / wave scheduling.
:mod:`repro_torch.serving.engine`  — autoregressive LM prefill/decode backend.
"""
