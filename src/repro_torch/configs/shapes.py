"""The four assigned input shapes and each step's input specs, as the JAX
package's ``configs/shapes.py``.

Where the JAX package returns ``jax.ShapeDtypeStruct``\\ s for
``jax.jit(...).lower()``, the port returns :class:`TensorSpec` records —
a shape and a torch dtype, nothing allocated — which the dry run
(:mod:`repro_torch.launch.dryrun`) turns into fake tensors.  The trees
are the JAX package's, leaf for leaf, frontends included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.models.transformer.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, the port's ``ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """Per-machine (unstacked) train batch specs."""
    i32 = torch.int32
    if cfg.frontend == "audio":
        return {
            "frames": TensorSpec((batch, seq, cfg.frontend_dim),
                                 _DTYPES[cfg.dtype]),
            "labels": TensorSpec((batch, seq), i32),
            "mask_positions": TensorSpec((batch, seq), i32),
        }
    if cfg.frontend == "vision":
        n_text = seq - cfg.num_prefix_tokens
        return {
            "patches": TensorSpec((batch, cfg.num_prefix_tokens,
                                   cfg.frontend_dim), _DTYPES[cfg.dtype]),
            "tokens": TensorSpec((batch, n_text), i32),
            "labels": TensorSpec((batch, n_text), i32),
        }
    return {
        "tokens": TensorSpec((batch, seq), i32),
        "labels": TensorSpec((batch, seq), i32),
    }


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    specs = train_batch_specs(cfg, batch, seq)
    specs.pop("labels", None)
    specs.pop("mask_positions", None)
    return specs


def decode_token_specs(batch: int) -> Dict:
    return {
        "token": TensorSpec((batch,), torch.int32),
        "position": TensorSpec((), torch.int32),
    }
