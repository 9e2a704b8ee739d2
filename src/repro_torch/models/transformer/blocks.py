"""Block-level init/forward/prefill/decode dispatch.

A *block* is one residual layer.  The kinds:

  full        — pre-norm GQA attention (causal) + pre-norm MLP (the GLU,
                or the GELU MLP under ``act="gelu"``), an append KV cache
                of ``max_seq`` slots.
  swa         — the same with sliding-window attention
                (``cfg.sliding_window``) and a ring KV cache of
                ``min(sliding_window, max_seq)`` slots.
  moe         — ``full`` with the MoE (:mod:`.moe`) in place of the MLP.
  moe_swa     — ``swa`` with the MoE in place of the MLP.
  rwkv6       — RWKV6 time-mix + channel-mix, each with its own pre-norm.
  mamba2      — pre-norm Mamba2 (SSD) mixer (no separate FFN — Mamba style).
  shared_attn — Zamba2's shared transformer block: concat(h, emb0)
                (2·d_model, emb0 the layer stack's input embeddings) through
                its RMSNorm and full causal attention back to d_model, then
                its own pre-norm GLU MLP.  One parameter set serves every
                application (the caller passes it), each with its own KV
                cache.

``block_forward(..., causal=False)`` is the encoder's bidirectional
attention (no mask, no window; the audio frontend's stack).

``block_forward`` returns ``(h, aux)`` (aux: the MoE load-balance loss,
zero for the other kinds); ``block_prefill`` ``(h, state, aux)``;
``block_decode`` ``(h, new_state)``, the MoE's aux dropped.  ``max_seq``
sizes the attention caches and ``position`` (an int, or a (B,) tensor of
per-row positions) indexes them; the recurrent kinds read neither.  The
MoE routes a prefill's and an int position's batch as one group, and with
a (B,) position each row alone (:mod:`.moe`, "Groups").

Every function takes ``tp``, the rank's view of the layer's split over a
mesh (:mod:`.parallel`; the identity on one device), and hands each part
its subtree's view; a prefill's state is laid out by the state rules.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import mamba2 as M2
from repro_torch.models.transformer import mlp as FF
from repro_torch.models.transformer import moe as MOE
from repro_torch.models.transformer import rwkv6 as R6
from repro_torch.models.transformer.attention import CacheSpec
from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.norms import rms_norm
from repro_torch.models.transformer.parallel import UNSHARDED

_MOE = ("moe", "moe_swa")
_ATTN = ("full", "swa") + _MOE


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown block kind {kind!r}")


def _window(kind: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.sliding_window if kind in ("swa", "moe_swa") else None


def init_block_params(kind: str, cfg: ModelConfig, rng) -> Dict:
    d = cfg.d_model
    if kind in _ATTN:
        p = {"ln1": torch.zeros(d), "attn": A.init_attn_params(cfg, rng),
             "ln2": torch.zeros(d)}
        if kind in _MOE:
            p["moe"] = MOE.init_moe_params(cfg, rng)
        else:
            p["mlp"] = FF.init_mlp_params(cfg, rng)
        return p
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
    raise _unknown(kind)


def _shared_attn_in(params: Dict, h: torch.Tensor, emb0: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(torch.cat([h, emb0], dim=-1), params["ln"], cfg.norm_eps)


def _mlp_out(params: Dict, h: torch.Tensor, cfg: ModelConfig,
             tp=UNSHARDED) -> torch.Tensor:
    """``h`` plus the pre-norm (``ln2``) MLP of it: the second half of the
    dense and shared blocks."""
    x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
    return h + FF.mlp_forward(params["mlp"], x2, cfg, tp["mlp"])


def _ffn_out(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig,
             groups: int = 1, tp=UNSHARDED
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second half of an attention block: ``h`` plus its pre-norm MLP,
    or its pre-norm MoE routed in ``groups`` groups, and the MoE's aux
    (zero for the MLP)."""
    if kind not in _MOE:
        return (_mlp_out(params, h, cfg, tp),
                torch.zeros((), dtype=torch.float32, device=h.device))
    x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
    y, aux = MOE.moe_forward(params["moe"], x2, cfg, groups, tp["moe"])
    return h + y, aux


def _encoder_attn(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  tp=UNSHARDED) -> torch.Tensor:
    """Bidirectional attention: no mask and no window, RoPE at
    ``arange(s)``, the f32 softmax cast back to ``x``'s dtype."""
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)
    q, k, v = A._project_qkv(params, x, cfg, positions, tp)
    probs = torch.softmax(A._gqa_scores(q, k, cfg), dim=-1).to(x.dtype)
    return A._gqa_output(probs, v, params, cfg, b, s, tp)


def block_forward(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig,
                  emb0: Optional[torch.Tensor] = None, causal: bool = True,
                  tp=UNSHARDED) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in _ATTN:
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        if causal:
            att = A.attn_forward(params["attn"], x, cfg,
                                 window=_window(kind, cfg), tp=tp["attn"])
        else:
            att = _encoder_attn(params["attn"], x, cfg, tp["attn"])
        return _ffn_out(kind, params, h + att, cfg, tp=tp)
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, _, _ = R6.rwkv6_time_mix(params, x, cfg, tp=tp)
        h = h + att
        x = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, _ = R6.rwkv6_channel_mix(params, x, tp=tp)
        return h + ffn, aux
    if kind == "mamba2":
        x = rms_norm(h, params["ln"], cfg.norm_eps)
        return h + M2.mamba2_forward(params["mamba"], x, cfg,
                                     tp["mamba"]), aux
    if kind == "shared_attn":
        x = _shared_attn_in(params, h, emb0, cfg)
        h = h + A.attn_forward(params["attn"], x, cfg, tp=tp["attn"])
        return _mlp_out(params, h, cfg, tp), aux
    raise _unknown(kind)


def cache_spec_for(kind: str, cfg: ModelConfig,
                   max_seq: int) -> Optional[CacheSpec]:
    """The attention cache of a kind, or None for the recurrent kinds."""
    if kind in ("full", "moe", "shared_attn"):
        return CacheSpec("full", max_seq)
    if kind in ("swa", "moe_swa"):
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
    raise _unknown(kind)


def block_prefill(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig,
                  max_seq: int, emb0: Optional[torch.Tensor] = None,
                  tp=UNSHARDED) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Forward + state construction.  Returns (h, state, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in _ATTN:
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, cache = A.attn_prefill(params["attn"], x, cfg,
                                    cache_spec_for(kind, cfg, max_seq),
                                    window=_window(kind, cfg), tp=tp["attn"])
        h, aux = _ffn_out(kind, params, h + att, cfg, tp=tp)
        return h, cache, aux
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, x_att, h_t = R6.rwkv6_time_mix(params, x, cfg, tp=tp)
        h = h + att
        x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, x_ffn = R6.rwkv6_channel_mix(params, x2, tp=tp)
        # the state of every head, then the rank's block of it
        hs = h_t.shape[-1]
        h_t = tp.gather(h_t.reshape(h.shape[0], -1, hs, hs), 1,
                        "w_r").reshape(-1, hs, hs)
        return h + ffn, tp.to_state({"x_att": x_att, "x_ffn": x_ffn,
                                     "h": h_t}), aux
    if kind == "mamba2":
        x = rms_norm(h, params["ln"], cfg.norm_eps)
        y, state = M2.mamba2_prefill(params["mamba"], x, cfg, tp["mamba"])
        return h + y, tp.to_state(state), aux
    if kind == "shared_attn":
        x = _shared_attn_in(params, h, emb0, cfg)
        att, cache = A.attn_prefill(params["attn"], x, cfg,
                                    cache_spec_for(kind, cfg, max_seq),
                                    tp=tp["attn"])
        return _mlp_out(params, h + att, cfg, tp), cache, aux
    raise _unknown(kind)


def block_decode(kind: str, params: Dict, h: torch.Tensor, cfg: ModelConfig,
                 state: Dict, position, max_seq: int,
                 emb0: Optional[torch.Tensor] = None, tp=UNSHARDED
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  h: (B, 1, d); ``position`` an int or a (B,) int
    tensor (:func:`attention.attn_decode`), with which the MoE routes
    each row alone."""
    if kind in _ATTN:
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, cache = A.attn_decode(params["attn"], x, cfg, state, position,
                                   cache_spec_for(kind, cfg, max_seq),
                                   window=_window(kind, cfg), tp=tp["attn"])
        groups = h.shape[0] if isinstance(position, torch.Tensor) else 1
        return _ffn_out(kind, params, h + att, cfg, groups, tp)[0], cache
    if kind == "rwkv6":
        x = rms_norm(h, params["ln1"], cfg.norm_eps)
        att, x_att, h_t = R6.rwkv6_decode_time_mix(params, x, cfg, state,
                                                   tp)
        h = h + att
        x2 = rms_norm(h, params["ln2"], cfg.norm_eps)
        ffn, _ = R6.rwkv6_channel_mix(params, x2, state["x_ffn"], tp)
        return h + ffn, {"x_att": x_att, "x_ffn": x2,
                         "h": tp.to_state({"h": h_t})["h"]}
    if kind == "mamba2":
        x = rms_norm(h, params["ln"], cfg.norm_eps)
        y, state = M2.mamba2_decode(params["mamba"], x, cfg, state,
                                    tp["mamba"])
        return h + y, tp.to_state(state)
    if kind == "shared_attn":
        x = _shared_attn_in(params, h, emb0, cfg)
        att, cache = A.attn_decode(params["attn"], x, cfg, state, position,
                                   cache_spec_for(kind, cfg, max_seq),
                                   tp=tp["attn"])
        return _mlp_out(params, h + att, cfg, tp), cache
    raise _unknown(kind)
