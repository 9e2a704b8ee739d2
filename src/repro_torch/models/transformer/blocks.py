"""Block-level init/forward/prefill/decode dispatch.

A *block* is one residual layer.  The port has five kinds:

  full        — pre-norm GQA attention (causal) + pre-norm MLP (the GLU,
                or the GELU MLP under ``act="gelu"``), an append KV cache
                of ``max_seq`` slots.
  swa         — the same with sliding-window attention
                (``cfg.sliding_window``) and a ring KV cache of
                ``min(sliding_window, max_seq)`` slots.
  rwkv6       — RWKV6 time-mix + channel-mix, each with its own pre-norm.
  mamba2      — pre-norm Mamba2 (SSD) mixer (no separate FFN — Mamba style).
  shared_attn — Zamba2's shared transformer block: concat(h, emb0)
                (2·d_model, emb0 the layer stack's input embeddings) through
                its RMSNorm and full causal attention back to d_model, then
                its own pre-norm GLU MLP.  One parameter set serves every
                application (the caller passes it), each with its own KV
                cache.

The JAX package's MoE kinds (``moe``, ``moe_swa``) raise ``ValueError``
(ROADMAP.md Queue 1 item 13.3); so does its non-causal encoder attention,
which only the audio frontend reaches (item 13.2b: the port's ``LM``
refuses that frontend).

``block_forward`` returns ``(h, aux)`` (aux: the MoE load-balance loss,
zero here); ``block_prefill`` ``(h, state, aux)``; ``block_decode``
``(h, new_state)``.  ``max_seq`` sizes the attention caches and
``position`` (an int, or a (B,) tensor of per-row positions) indexes them;
the recurrent kinds read neither.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import mamba2 as M2
from repro_torch.models.transformer import mlp as FF
from repro_torch.models.transformer import rwkv6 as R6
from repro_torch.models.transformer.attention import CacheSpec
from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.norms import rms_norm

_DENSE = ("full", "swa")


def _unported(kind: str) -> ValueError:
    if kind in ("moe", "moe_swa"):
        return ValueError(f"block kind {kind!r} is not ported yet (ROADMAP.md "
                          "Queue 1 item 13.3, MoE)")
    return ValueError(f"unknown block kind {kind!r}")


def _window(kind: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.sliding_window if kind == "swa" else None


def init_block_params(kind: str, cfg: ModelConfig, rng) -> Dict:
    d = cfg.d_model
    if kind in _DENSE:
        return {"ln1": torch.zeros(d), "attn": A.init_attn_params(cfg, rng),
                "ln2": torch.zeros(d), "mlp": FF.init_mlp_params(cfg, rng)}
    if kind == "rwkv6":
        return {"ln1": torch.zeros(d), "ln2": torch.zeros(d),
                **R6.init_rwkv6_params(cfg, rng)}
    if kind == "mamba2":
        return {"ln": torch.zeros(d),
                "mamba": M2.init_mamba2_params(cfg, rng)}
    if kind == "shared_attn":
        return {"ln": torch.zeros(2 * d),
                "attn": A.init_attn_params(cfg, rng, d_model=2 * d),
                "ln2": torch.zeros(d), "mlp": FF.init_mlp_params(cfg, rng)}
    raise _unported(kind)


def _shared_attn_in(params: Dict, h: torch.Tensor, emb0: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(torch.cat([h, emb0], dim=-1), params["ln"], cfg.norm_eps)


def _mlp_out(params: Dict, h: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """``h`` plus the pre-norm (``ln2``) MLP of it: the second half of the
    dense and shared blocks."""
    x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
    return h + FF.mlp_forward(params["mlp"], x2, cfg)


def block_forward(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig,
                  emb0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in _DENSE:
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        h = h + A.attn_forward(params["attn"], x, cfg,
                               window=_window(kind, cfg))
        return _mlp_out(params, h, cfg), aux
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, _, _ = R6.rwkv6_time_mix(params, x, cfg)
        h = h + att
        x = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, _ = R6.rwkv6_channel_mix(params, x)
        return h + ffn, aux
    if kind == "mamba2":
        x = rms_norm(h, params["ln"], cfg.norm_eps)
        return h + M2.mamba2_forward(params["mamba"], x, cfg), aux
    if kind == "shared_attn":
        x = _shared_attn_in(params, h, emb0, cfg)
        h = h + A.attn_forward(params["attn"], x, cfg)
        return _mlp_out(params, h, cfg), aux
    raise _unported(kind)


def cache_spec_for(kind: str, cfg: ModelConfig,
                   max_seq: int) -> Optional[CacheSpec]:
    """The attention cache of a kind, or None for the recurrent kinds."""
    if kind in ("full", "shared_attn"):
        return CacheSpec("full", max_seq)
    if kind == "swa":
        return CacheSpec("ring", min(cfg.sliding_window, max_seq))
    return None


def init_block_state(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device) -> Dict:
    spec = cache_spec_for(kind, cfg, max_seq)
    if spec is not None:
        return A.init_cache(cfg, batch, spec, dtype, device)
    if kind == "mamba2":
        return M2.init_mamba2_state(cfg, batch, dtype, device)
    if kind == "rwkv6":
        return R6.init_rwkv6_state(cfg, batch, dtype, device)
    raise _unported(kind)


def block_prefill(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig,
                  max_seq: int, emb0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Forward + state construction.  Returns (h, state, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in _DENSE:
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, cache = A.attn_prefill(params["attn"], x, cfg,
                                    cache_spec_for(kind, cfg, max_seq),
                                    window=_window(kind, cfg))
        return _mlp_out(params, h + att, cfg), cache, aux
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, x_att, h_t = R6.rwkv6_time_mix(params, x, cfg)
        h = h + att
        x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, x_ffn = R6.rwkv6_channel_mix(params, x2)
        return h + ffn, {"x_att": x_att, "x_ffn": x_ffn, "h": h_t}, aux
    if kind == "mamba2":
        x = rms_norm(h, params["ln"], cfg.norm_eps)
        y, state = M2.mamba2_prefill(params["mamba"], x, cfg)
        return h + y, state, aux
    if kind == "shared_attn":
        x = _shared_attn_in(params, h, emb0, cfg)
        att, cache = A.attn_prefill(params["attn"], x, cfg,
                                    cache_spec_for(kind, cfg, max_seq))
        return _mlp_out(params, h + att, cfg), cache, aux
    raise _unported(kind)


def block_decode(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig,
                 state: Dict, position, max_seq: int,
                 emb0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  h: (B, 1, d); ``position`` an int or a (B,) int
    tensor (:func:`attention.attn_decode`)."""
    if kind in _DENSE:
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, cache = A.attn_decode(params["attn"], x, cfg, state, position,
                                   cache_spec_for(kind, cfg, max_seq),
                                   window=_window(kind, cfg))
        return _mlp_out(params, h + att, cfg), cache
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, x_att, h_t = R6.rwkv6_decode_time_mix(params, x, cfg, state)
        h = h + att
        x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, _ = R6.rwkv6_channel_mix(params, x2, state["x_ffn"])
        return h + ffn, {"x_att": x_att, "x_ffn": x2, "h": h_t}
    if kind == "mamba2":
        x = rms_norm(h, params["ln"], cfg.norm_eps)
        y, state = M2.mamba2_decode(params["mamba"], x, cfg, state)
        return h + y, state
    if kind == "shared_attn":
        x = _shared_attn_in(params, h, emb0, cfg)
        att, cache = A.attn_decode(params["attn"], x, cfg, state, position,
                                   cache_spec_for(kind, cfg, max_seq))
        return _mlp_out(params, h + att, cfg), cache
    raise _unported(kind)
