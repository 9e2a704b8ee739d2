"""Block-level init/forward/decode dispatch.

A *block* is one residual layer.  The port has the ``rwkv6`` kind — RWKV6
time-mix + channel-mix, each with its own pre-norm.  Every other kind of the
JAX package (``full``, ``swa``, ``moe``, ``moe_swa``, ``mamba2``,
``shared_attn``) raises ``ValueError``: it is ROADMAP Queue 1 item 13's
work.

``block_forward`` returns ``(h, aux)`` (aux: the MoE load-balance loss,
zero here); ``block_prefill`` ``(h, state, aux)``; ``block_decode``
``(h, new_state)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.transformer import rwkv6 as R6
from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.norms import rms_norm


def _unported(kind: str) -> ValueError:
    return ValueError(f"block kind {kind!r} is not ported yet (ROADMAP.md "
                      "Queue 1 item 13); the port has 'rwkv6'")


def init_block_params(kind: str, cfg: ModelConfig, rng) -> Dict:
    d = cfg.d_model
    if kind == "rwkv6":
        return {"ln1": torch.zeros(d), "ln2": torch.zeros(d),
                **R6.init_rwkv6_params(cfg, rng)}
    raise _unported(kind)


def block_forward(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, _, _ = R6.rwkv6_time_mix(params, x, cfg)
        h = h + att
        x = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, _ = R6.rwkv6_channel_mix(params, x)
        return h + ffn, aux
    raise _unported(kind)


def init_block_state(kind: str, cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict:
    if kind == "rwkv6":
        return R6.init_rwkv6_state(cfg, batch, dtype, device)
    raise _unported(kind)


def block_prefill(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Forward + state construction.  Returns (h, state, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, x_att, h_t = R6.rwkv6_time_mix(params, x, cfg)
        h = h + att
        x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, x_ffn = R6.rwkv6_channel_mix(params, x2)
        return h + ffn, {"x_att": x_att, "x_ffn": x_ffn, "h": h_t}, aux
    raise _unported(kind)


def block_decode(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  h: (B, 1, d)."""
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, x_att, h_t = R6.rwkv6_decode_time_mix(params, x, cfg, state)
        h = h + att
        x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, _ = R6.rwkv6_channel_mix(params, x2, state["x_ffn"])
        return h + ffn, {"x_att": x_att, "x_ffn": x2, "h": h_t}
    raise _unported(kind)
