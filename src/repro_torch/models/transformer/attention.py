"""GQA attention with RoPE, sliding windows and KV caches, as the JAX
package's ``models/transformer/attention.py``.

Three entry points, pure functions over a params dict:

* :func:`attn_forward` — full-sequence causal attention; ``window`` bounds
  the lookback of sliding-window layers.
* :func:`attn_prefill` — the same, and the KV cache for decoding.
* :func:`attn_decode`  — one token against the cache.  Full-attention
  layers keep an append cache of ``max_seq`` slots; sliding-window layers
  a ring of ``min(window, max_seq)`` slots, position ``p`` at slot
  ``p % length``.

GQA reshapes Q to (…, kv_heads, q_per_kv, hd) so the einsums contract per
KV group; ``qk_norm`` RMS-normalizes q and k before RoPE, ``logit_softcap``
squashes the scores with ``c·tanh(s/c)`` before the mask; scores are
masked with −1e30 and the softmax taken in f32, as in the JAX package.
``kv_cache_dtype="int8"`` stores k and v as int8 with an f32 scale per
(row, slot, head) (:func:`_quantize`, the JAX package's own rounding, not
the int8 wire codec of ``kernels/quantize.py``).  The JAX attention is
einsums, not a Pallas kernel, so the port keeps it in torch ops.

Split over ``model`` (``tp``, :mod:`.parallel`): ``wq``/``wk``/``wv`` are
column-parallel over heads and ``wo`` row-parallel, so a rank attends with
its own heads.  A head count the axis does not divide keeps its projection
whole: with the query heads split and the KV heads not, a rank reads the
KV heads its query heads use; with neither split the attention is
replicated.  A cache holds the rank's KV heads where they are split, else
is laid out by the state rules, whose ``head_dim`` split decodes with
partial scores (:func:`_attend_split_hd`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.norms import rms_norm
from repro_torch.models.transformer.parallel import UNSHARDED
from repro_torch.models.transformer.rope import apply_rope, rope_angles

_NO_POS = -(10 ** 9)        # a cache slot's position before it is written


def init_attn_params(cfg: ModelConfig, rng, d_model: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """f32 CPU tensors drawn from ``rng`` (a :class:`TorchRng`) in the JAX
    package's order; ``d_model`` overrides the input width (zamba2's shared
    block takes 2·d_model), the output is ``cfg.d_model`` wide.  The
    ``qk_norm`` scales are zeros and draw nothing."""
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def dense(shape):
        return rng.standard_normal(shape) / math.sqrt(shape[0])

    p = {"wq": dense((d, h * hd)), "wk": dense((d, kv * hd)),
         "wv": dense((d, kv * hd)), "wo": dense((h * hd, cfg.d_model))}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd)
        p["k_norm"] = torch.zeros(hd)
    return p


def _reads_some_kv(tp) -> bool:
    """The query heads are split over ``model`` and the KV heads are not:
    a rank reads the KV heads of its query heads."""
    return tp.sharded("wq") and not tp.sharded("wk")


def _kv_heads_read(n_q: int, cfg: ModelConfig, rank: int) -> slice:
    """The KV heads that query heads ``rank·n_q …`` read."""
    per = cfg.num_heads // cfg.num_kv_heads
    first = rank * n_q
    return slice(first // per, (first + n_q - 1) // per + 1)


def _project_qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, tp=UNSHARDED,
                 every_kv: bool = False):
    """q, k, v of ``x`` (B, S, d); ``positions`` (S,) or, a row each,
    (B, S).  Split over ``model``, the rank's heads (module docstring);
    where a rank reads some KV heads, ``every_kv`` projects all of them
    (a cache's) instead."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    xin = tp.col(x, "wq")
    q = (xin @ params["wq"].to(dt)).reshape(b, s, -1, hd)
    src, wk, wv = xin, params["wk"], params["wv"]
    if _reads_some_kv(tp):
        if every_kv:
            src = x
        else:
            heads = _kv_heads_read(q.shape[2], cfg, tp.rank)
            cols = torch.arange(heads.start * hd, heads.stop * hd,
                                device=x.device)
            wk, wv = tp.take(wk, cols, 1), tp.take(wv, cols, 1)
    k = (src @ wk.to(dt)).reshape(b, s, -1, hd)
    v = (src @ wv.to(dt)).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, tp.col(params["q_norm"], "wq"), cfg.norm_eps)
        k = rms_norm(k, params["k_norm"] if every_kv else
                     tp.col(params["k_norm"], "wq"), cfg.norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _read_by_q(k: torch.Tensor, v: torch.Tensor, n_q: int,
               cfg: ModelConfig, tp):
    """Of every KV head, those this rank's ``n_q`` query heads read."""
    if not _reads_some_kv(tp):
        return k, v
    heads = _kv_heads_read(n_q, cfg, tp.rank)
    return k[:, :, heads], v[:, :, heads]


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,Kv,hd) → f32 scores (B,Kv,G,S,T).  The
    products are in q's dtype; as in the JAX package, dividing by the
    numpy-float64 √hd promotes them to f32 (a bf16 stream's too)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(hd)
    if cfg.logit_softcap > 0:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    return scores


def _gqa_output(probs: torch.Tensor, v: torch.Tensor, params: Dict,
                cfg: ModelConfig, b: int, s: int, tp=UNSHARDED
                ) -> torch.Tensor:
    out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(b, s, -1)
    return tp.row(out @ params["wo"].to(out.dtype), "wo")


def _attend(params: Dict, q, k, v, valid: torch.Tensor, cfg: ModelConfig,
            dtype, tp=UNSHARDED) -> torch.Tensor:
    """Masked (−1e30) f32 softmax over the keys, then the output
    projection; ``valid`` broadcasts against the (B,Kv,G,S,T) scores."""
    b, s = q.shape[:2]
    scores = _gqa_scores(q, k.to(q.dtype), cfg).masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return _gqa_output(probs, v.to(dtype), params, cfg, b, s, tp)


def _attend_split_hd(params: Dict, q, k, v, valid: torch.Tensor,
                     cfg: ModelConfig, dtype, tp) -> torch.Tensor:
    """:func:`_attend` against a cache whose ``head_dim`` is split over
    ``model`` (decode only): every query head (gathered where they are
    split) contracted over the rank's slice of ``head_dim``, the partial
    scores summed (one all-reduce), the rank's slice of every head's
    output gathered, then the output projection of that replicated
    output."""
    b, s = q.shape[:2]
    hd = cfg.resolved_head_dim
    if tp.sharded("wq"):
        q = tp.col_out(q, "wq", dim=2)
    kv = k.shape[2]
    qs = tp.local_slice(q, -1)
    qg = qs.reshape(b, s, kv, q.shape[2] // kv, qs.shape[-1])
    part = torch.einsum("bskgd,btkd->bkgst", qg, k.to(q.dtype)).float()
    scores = tp.all_reduce(part) / math.sqrt(hd)
    if cfg.logit_softcap > 0:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    probs = torch.softmax(scores.masked_fill(~valid, -1e30),
                          dim=-1).to(dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(dtype))
    out = tp.all_gather(out, -1).reshape(b, s, cfg.num_heads * hd)
    return tp.row_in(out, params["wo"], "wo")


def _causal(params: Dict, x: torch.Tensor, cfg: ModelConfig,
            window: Optional[int], tp=UNSHARDED, every_kv: bool = False):
    """Causal (optionally windowed) attention's output, and the keys,
    values and positions it attended to (every KV head with
    ``every_kv``, :func:`_project_qkv`)."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions, tp, every_kv)
    qpos, kpos = positions[:, None], positions[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    ka, va = _read_by_q(k, v, q.shape[2], cfg, tp) if every_kv else (k, v)
    return _attend(params, q, ka, va, mask, cfg, x.dtype, tp), k, v, \
        positions


def attn_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 window: Optional[int] = None, tp=UNSHARDED) -> torch.Tensor:
    """Causal (optionally windowed) attention over the full sequence."""
    return _causal(params, x, cfg, window, tp)[0]


# --------------------------------------------------------------------------
# KV caches
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheSpec:
    kind: str          # "full" | "ring"
    length: int        # max_seq for full, min(window, max_seq) for ring

    def __post_init__(self):
        if self.kind not in ("full", "ring"):
            raise ValueError(f"unknown KV cache kind {self.kind!r}; the "
                             "caches are 'full' and 'ring'")


def _quantized(cfg: ModelConfig) -> bool:
    return cfg.kv_cache_dtype == "int8"


def init_cache(cfg: ModelConfig, batch: int, spec: CacheSpec, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Empty cache: zero k/v in ``dtype`` (int8 codes and zero f32 scales
    per (row, slot, head) under ``kv_cache_dtype="int8"``) and every
    slot's position −10⁹ (never valid)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, spec.length, kv, hd)
    pos = torch.full((spec.length,), _NO_POS, dtype=torch.int32,
                     device=device)
    if _quantized(cfg):
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], device=device),
                "v_scale": torch.zeros(shape[:3], device=device),
                "pos": pos}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": pos}


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head_dim axis: scale ``max|x| / 127``
    floored at 1e-8, codes rounded half to even (as ``jnp.round``) and
    clipped to ±127."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def attn_prefill(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 spec: CacheSpec, window: Optional[int] = None, tp=UNSHARDED
                 ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention and the cache of its keys and values, in
    ``x``'s dtype (or int8).  A full cache pads to ``spec.length`` slots; a
    ring keeps the last ``min(s, length)`` positions, position ``p`` at
    slot ``p % length``, the other slots at position −10⁹.  Split over
    ``model``, the rank's block of the cache (module docstring)."""
    b, s = x.shape[:2]
    L = spec.length
    out, k, v, positions = _causal(params, x, cfg, window, tp, every_kv=True)
    pos = torch.full((L,), _NO_POS, dtype=torch.int32, device=x.device)
    if spec.kind == "ring":
        take = min(s, L)
        slots = positions[-take:] % L
        cache_k = k.new_zeros((b, L) + k.shape[2:])
        cache_v = v.new_zeros((b, L) + v.shape[2:])
        cache_k[:, slots] = k[:, -take:]
        cache_v[:, slots] = v[:, -take:]
        pos[slots] = positions[-take:].to(torch.int32)
    else:
        if s > L:
            raise ValueError(f"a prefill of {s} tokens exceeds the cache's "
                             f"{L} slots")
        pad = L - s
        cache_k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        cache_v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos[:s] = positions.to(torch.int32)
    if _quantized(cfg):
        kq, ks = _quantize(cache_k)
        vq, vs = _quantize(cache_v)
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "pos": pos}
    else:
        cache = {"k": cache_k, "v": cache_v, "pos": pos}
    # split KV heads are the rank's block already
    return out, cache if tp.sharded("wk") else tp.to_state(cache)


def attn_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                cache: Dict, position: Union[int, torch.Tensor],
                spec: CacheSpec, window: Optional[int] = None, tp=UNSHARDED
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d).  ``position`` is the token's index:
    an int shared by every row (a wave), or a (B,) int tensor, each row's
    own (a slot pool), whose cache then holds positions per row, ``pos``
    (B, L) (an (L,) one is taken as every row's).  Each row writes slot
    ``position`` (``position % L`` in a ring) and attends to the slots
    whose position lies in ``(position − w, position]``, ``w`` the window
    (a ring's length without one).  The cache is not modified: the new
    one is a copy, as the JAX package's ``dynamic_update_slice``.  Split
    over ``model``, the cache is the rank's block (module docstring)."""
    b = x.shape[0]
    L = spec.length
    per_row = isinstance(position, torch.Tensor)
    if per_row:
        position = position.to(device=x.device, dtype=torch.long)
        # a full cache's slot clamps to the last, as dynamic_update_slice
        slot = position % L if spec.kind == "ring" else \
            position.clamp(0, L - 1)
        at = (torch.arange(b, device=x.device), slot)
        cur = position[:, None]                           # (B, 1)
        angles_at = cur
    else:
        position = int(position)
        if spec.kind == "full" and not 0 <= position < L:
            raise ValueError(f"position {position} is outside the cache's "
                             f"{L} slots")
        slot = position % L
        at = (slice(None), slot)
        cur = position
        angles_at = torch.tensor([position], device=x.device)
    q, k, v = _project_qkv(params, x, cfg, angles_at, tp, every_kv=True)
    split_hd = tp.state_dim("k") == 3
    mine = (lambda t: tp.local_slice(t, -1)) if split_hd else (lambda t: t)
    new = {name: t.clone() for name, t in cache.items() if name != "pos"}
    if _quantized(cfg):
        (kq, new["k_scale"][at]), (vq, new["v_scale"][at]) = \
            _quantize(k[:, 0]), _quantize(v[:, 0])
        new["k"][at], new["v"][at] = mine(kq), mine(vq)
        cache_k = _dequantize(new["k"], new["k_scale"], x.dtype)
        cache_v = _dequantize(new["v"], new["v_scale"], x.dtype)
    else:
        new["k"][at] = mine(k[:, 0]).to(new["k"].dtype)
        new["v"][at] = mine(v[:, 0]).to(new["v"].dtype)
        cache_k, cache_v = new["k"], new["v"]
    if per_row:
        pos = cache["pos"].expand(b, L).clone()
        pos[at] = position.to(torch.int32)
    else:
        pos = cache["pos"].clone()
        pos[slot] = position
    new["pos"] = pos
    valid = (pos >= 0) & (pos <= cur)
    if spec.kind == "ring" or window is not None:
        w = window if window is not None else L
        valid &= pos > cur - w
    if per_row:
        valid = valid[:, None, None, None, :]
    if split_hd:
        return _attend_split_hd(params, q, cache_k, cache_v, valid, cfg,
                                x.dtype, tp), new
    cache_k, cache_v = _read_by_q(cache_k, cache_v, q.shape[2], cfg, tp)
    return _attend(params, q, cache_k, cache_v, valid, cfg, x.dtype,
                   tp), new
