"""Dense feed-forward blocks, as the JAX package's
``models/transformer/mlp.py``: the SiLU-GLU (``act="silu"``), else the
non-gated GELU (starcoder2, the encoders)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.config import ModelConfig


def init_mlp_params(cfg: ModelConfig, rng) -> Dict[str, torch.Tensor]:
    """f32 CPU tensors drawn from ``rng`` (a :class:`TorchRng`), in the JAX
    package's order: gate, up, down for the GLU; up, down for the GELU."""
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape):
        return rng.standard_normal(shape) / math.sqrt(shape[0])

    if cfg.act == "silu":
        return {"w_gate": dense((d, f)), "w_up": dense((d, f)),
                "w_down": dense((f, d))}
    return {"w_up": dense((d, f)), "w_down": dense((f, d))}


def mlp_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    dt = x.dtype
    if "w_gate" in params:
        g = F.silu(x @ params["w_gate"].to(dt))
        u = x @ params["w_up"].to(dt)
        return (g * u) @ params["w_down"].to(dt)
    # jax.nn.gelu's default is the tanh approximation; torch's is erf
    h = F.gelu(x @ params["w_up"].to(dt), approximate="tanh")
    return h @ params["w_down"].to(dt)
