"""Dense feed-forward blocks, as the JAX package's
``models/transformer/mlp.py``: the SiLU-GLU (``act="silu"``), else the
non-gated GELU (starcoder2, the encoders).  Split over ``model``
(:mod:`.parallel`), ``w_gate``/``w_up`` are column-parallel and ``w_down``
row-parallel: one all-reduce completes the output."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.parallel import UNSHARDED


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


def mlp_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                tp=UNSHARDED) -> torch.Tensor:
    dt = x.dtype
    xin = tp.col(x, "w_up")
    if "w_gate" in params:
        g = F.silu(xin @ params["w_gate"].to(dt))
        u = xin @ params["w_up"].to(dt)
        return tp.row((g * u) @ params["w_down"].to(dt), "w_down")
    # jax.nn.gelu's default is the tanh approximation; torch's is erf
    h = F.gelu(xin @ params["w_up"].to(dt), approximate="tanh")
    return tp.row(h @ params["w_down"].to(dt), "w_down")
