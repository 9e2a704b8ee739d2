"""The paper's experimental settings as synthetic analogs, and the
architecture registry: ``get_config(arch_id)`` resolves one of the ten
transformer-family ``ModelConfig``\\ s (copies of the JAX package's data-only
modules), ``get_long_context_config`` its long-context serving variant
where one exists, ``get_smoke_config`` its tiny same-family variant for CPU
tests, and ``shape_supported`` which (arch × shape) pairs the dry run
takes; the shapes and input specs live in :mod:`repro_torch.configs.shapes`.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

from repro_torch.configs.shapes import (SHAPES, InputShape, TensorSpec,
                                        decode_token_specs,
                                        prefill_batch_specs,
                                        train_batch_specs)
from repro_torch.models.transformer.config import ModelConfig, reduced_variant

_MODULES: Dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "gemma3-1b": "gemma3_1b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-7b": "zamba2_7b",
    "stablelm-12b": "stablelm_12b",
    "internvl2-2b": "internvl2_2b",
    "starcoder2-15b": "starcoder2_15b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg = mod.CONFIG
    cfg.validate()
    return cfg


def get_long_context_config(arch_id: str) -> Optional[ModelConfig]:
    """The long-context (500k-token decode) serving variant, as the JAX
    package's: a sub-quadratic stack (recurrent, windowed or hybrid) is
    its own; gemma3's is its module's ``LONG_CONTEXT_CONFIG`` (the global
    layers windowed too); a full-attention or encoder-only stack has none
    (None)."""
    cfg = get_config(arch_id)
    if not cfg.supports_decode():
        return None
    if cfg.subquadratic():
        return cfg
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    lc = getattr(mod, "LONG_CONTEXT_CONFIG", None)
    if lc is not None:
        lc.validate()
    return lc


def get_smoke_config(arch_id: str, **overrides) -> ModelConfig:
    return reduced_variant(get_config(arch_id), **overrides)


def shape_supported(arch_id: str, shape_name: str) -> bool:
    """Which (arch × shape) pairs run, by the JAX package's skip rules: an
    encoder-only stack has no decode, and ``long_500k`` needs a
    long-context variant."""
    cfg = get_config(arch_id)
    shp = SHAPES[shape_name]
    if shp.kind == "decode" and not cfg.supports_decode():
        return False
    if shp.name == "long_500k":
        return get_long_context_config(arch_id) is not None
    return True
