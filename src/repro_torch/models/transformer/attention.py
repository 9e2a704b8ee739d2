"""GQA attention with RoPE and a full KV cache, as the JAX package's
``models/transformer/attention.py``.

Three entry points, pure functions over a params dict:

* :func:`attn_forward` — full-sequence causal attention.
* :func:`attn_prefill` — the same, and the KV cache for decoding.
* :func:`attn_decode`  — one token against the cache.

GQA reshapes Q to (…, kv_heads, q_per_kv, hd) so the einsums contract per
KV group; scores are masked with −1e30 and the softmax taken in f32, as in
the JAX package.  The JAX attention is einsums, not a Pallas kernel, so
the port keeps it in torch ops.  The ``"ring"`` cache of sliding-window
stacks, ``kv_cache_dtype="int8"``, ``qk_norm`` and ``logit_softcap``
belong to the full/swa stacks and raise ``ValueError`` (ROADMAP.md Queue 1
item 13.2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.rope import apply_rope, rope_angles

_NO_POS = -(10 ** 9)        # a cache slot's position before it is written


def _unported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP.md Queue 1 item "
                      "13.2)")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.qk_norm:
        raise _unported(f"{cfg.name}: qk_norm")
    if cfg.logit_softcap > 0:
        raise _unported(f"{cfg.name}: logit_softcap")
    if cfg.kv_cache_dtype == "int8":
        raise _unported(f"{cfg.name}: the int8 KV cache")


def init_attn_params(cfg: ModelConfig, rng, d_model: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """f32 CPU tensors drawn from ``rng`` (a :class:`TorchRng`) in the JAX
    package's order; ``d_model`` overrides the input width (zamba2's shared
    block takes 2·d_model), the output is ``cfg.d_model`` wide."""
    _check_supported(cfg)
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def dense(shape):
        return rng.standard_normal(shape) / math.sqrt(shape[0])

    return {"wq": dense((d, h * hd)), "wk": dense((d, kv * hd)),
            "wv": dense((d, kv * hd)), "wo": dense((h * hd, cfg.d_model))}


def _project_qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    _check_supported(cfg)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(b, s, h, hd)
    k = (x @ params["wk"].to(dt)).reshape(b, s, kv, hd)
    v = (x @ params["wv"].to(dt)).reshape(b, s, kv, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,Kv,hd) → scores (B,Kv,G,S,T)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(hd)


def _gqa_output(probs: torch.Tensor, v: torch.Tensor, params: Dict,
                cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return out @ params["wo"].to(out.dtype)


def _attend(params: Dict, q, k, v, valid: torch.Tensor, cfg: ModelConfig,
            dtype) -> torch.Tensor:
    """Masked (−1e30) f32 softmax over the keys, then the output
    projection; ``valid`` broadcasts against the (S, T) score axes."""
    b, s = q.shape[:2]
    scores = _gqa_scores(q, k.to(q.dtype)).float().masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return _gqa_output(probs, v.to(dtype), params, cfg, b, s)


def attn_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """Causal attention over the full sequence."""
    return _causal(params, x, cfg)[0]


def _causal(params: Dict, x: torch.Tensor, cfg: ModelConfig):
    """Causal attention's output, and the keys, values and positions it
    attended to."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    mask = positions[None, :] <= positions[:, None]
    return _attend(params, q, k, v, mask, cfg, x.dtype), k, v, positions


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheSpec:
    kind: str          # "full" (the port's one kind; "ring": item 13.2)
    length: int        # max_seq


def _check_spec(spec: CacheSpec) -> None:
    if spec.kind != "full":
        raise _unported(f"the {spec.kind!r} KV cache")


def init_cache(cfg: ModelConfig, batch: int, spec: CacheSpec, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Empty cache: zero k/v in ``dtype`` and every slot's position
    −10⁹ (never valid)."""
    _check_supported(cfg)
    _check_spec(spec)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, spec.length, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((spec.length,), _NO_POS, dtype=torch.int32,
                              device=device)}


def attn_prefill(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 spec: CacheSpec) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention and the cache of its keys and values, in
    ``x``'s dtype, padded to ``spec.length`` slots."""
    _check_spec(spec)
    s = x.shape[1]
    if s > spec.length:
        raise ValueError(f"a prefill of {s} tokens exceeds the cache's "
                         f"{spec.length} slots")
    out, k, v, positions = _causal(params, x, cfg)
    pad = spec.length - s
    pos = torch.cat([positions.to(torch.int32),
                     torch.full((pad,), _NO_POS, dtype=torch.int32,
                                device=x.device)])
    return out, {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
                 "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)),
                 "pos": pos}


def attn_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                cache: Dict, position: int, spec: CacheSpec
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); ``position`` the token's index,
    which is also its cache slot.  The cache is not modified: the new one
    is a copy with slot ``position`` written, as the JAX package's
    ``dynamic_update_slice``."""
    _check_spec(spec)
    position = int(position)
    if not 0 <= position < spec.length:
        raise ValueError(f"position {position} is outside the cache's "
                         f"{spec.length} slots")
    q, k, v = _project_qkv(params, x, cfg,
                           torch.tensor([position], device=x.device))
    new = {name: cache[name].clone() for name in ("k", "v", "pos")}
    new["k"][:, position] = k[:, 0].to(new["k"].dtype)
    new["v"][:, position] = v[:, 0].to(new["v"].dtype)
    new["pos"][position] = position
    valid = (new["pos"] >= 0) & (new["pos"] <= position)
    return _attend(params, q, new["k"], new["v"], valid, cfg,
                   x.dtype), new
