"""The SiLU-GLU feed-forward block, as the JAX package's
``models/transformer/mlp.py`` (its GELU branch, for encoders, comes with
the first port path that runs it: ROADMAP.md Queue 1 item 13.2)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.config import ModelConfig


def init_mlp_params(cfg: ModelConfig, rng) -> Dict[str, torch.Tensor]:
    """f32 CPU tensors drawn from ``rng`` (a :class:`TorchRng`), in the JAX
    package's order: gate, up, down."""
    if cfg.act != "silu":
        raise ValueError(f"{cfg.name}: the {cfg.act!r} MLP is not ported "
                         "yet (ROADMAP.md Queue 1 item 13.2); the port has "
                         "the SiLU-GLU")
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape):
        return rng.standard_normal(shape) / math.sqrt(shape[0])

    return {"w_gate": dense((d, f)), "w_up": dense((d, f)),
            "w_down": dense((f, d))}


def mlp_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    if "w_gate" not in params:
        raise ValueError("the GELU MLP is not ported yet (ROADMAP.md Queue 1 "
                         "item 13.2)")
    dt = x.dtype
    g = F.silu(x @ params["w_gate"].to(dt))
    u = x @ params["w_up"].to(dt)
    return (g * u) @ params["w_down"].to(dt)
