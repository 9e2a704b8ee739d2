"""RWKV6 "Finch" block — attention-free with data-dependent decay.

Time-mixing: token-shift interpolation feeds five projections
(r, k, v, g, w); the decay w_t is data-dependent through a low-rank adapter;
the WKV state update is the strict-output gated linear recurrence with the
per-head bonus ``u``:

    h_t = diag(w_t) h_{t−1} + k_t v_tᵀ
    y_t = r_tᵀ h_{t−1} + (r_t · (u ⊙ k_t)) v_t

followed by per-head GroupNorm and a SiLU(g) gate.  Channel-mixing is the
RWKV squared-ReLU FFN with its own token shift.  Decode state per layer:
(x_prev_att, x_prev_ffn, h).

The prefill's scan goes through :func:`repro_torch.kernels.ops.linear_scan`
— on the card, the hand-written scan kernel and, in training, its gradient
kernel — in chunks of ``_CHUNK`` steps, where the JAX package takes 64: the
chunk form scales keys by ``1/P = exp(−Σ log_w)`` over a chunk, which
overflows f32 once a chunk's summed decay passes ~88.7.  The decay is
clamped at |log_w| ≤ e² ≈ 7.39 a step, so 8 steps sum to at most 59.1 and
no reachable decay overflows; in chunks of 64, training rwkv6-1.6b at lr
3e-4 passes that sum within a few steps (``chip_smoke.py`` T4 prints it)
and the scan goes NaN.  Where the chunk-64 form is finite the chunk
changes only the order of f32 sums.

Split over ``model`` (``tp``, :mod:`.parallel`): ``w_r``/``w_k``/``w_v``/
``w_g`` and ``w_ck`` are column-parallel, ``w_o`` and ``w_cv``
row-parallel, so a rank's time mix runs the scan on its own heads (its
channels of the decay, the bonus and the group norm's scale) and one
all-reduce completes each mix.  Decode steps a replicated state: the
column-parallel outputs are gathered, the output is row-parallel.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.norms import group_norm
from repro_torch.models.transformer.parallel import UNSHARDED
from repro_torch.models.transformer.scan_common import scan_decode_step

_HEAD = 64          # RWKV6 head size
_LORA = 64          # decay adapter rank
_CHUNK = 8          # scan chunk: 8 × e² < 88.7, the f32 limit of 1/P


def _nheads(cfg: ModelConfig) -> int:
    return cfg.d_model // _HEAD


def init_rwkv6_params(cfg: ModelConfig, rng) -> Dict[str, torch.Tensor]:
    """f32 CPU tensors drawn from ``rng`` (a :class:`TorchRng`)."""
    d = cfg.d_model

    def dense(shape, fan_in):
        return rng.standard_normal(shape) / np.sqrt(fan_in)

    mix = lambda: rng.random(d) * 0.5 + 0.25
    return {
        # time mixing
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(), "mu_g": mix(), "mu_w": mix(),
        "w_r": dense((d, d), d), "w_k": dense((d, d), d), "w_v": dense((d, d), d),
        "w_g": dense((d, d), d), "w_o": dense((d, d), d),
        "w_decay_base": -5.0 + 3.0 * rng.random(d),
        "w_decay_a": dense((d, _LORA), d),
        "w_decay_b": dense((_LORA, d), _LORA),
        "u_bonus": rng.standard_normal(d) * 0.3,
        "gn_scale": torch.ones(d),
        # channel mixing
        "mu_ck": mix(), "mu_cr": mix(),
        "w_ck": dense((d, cfg.d_ff), d),
        "w_cv": dense((cfg.d_ff, d), cfg.d_ff),
        "w_cr": dense((d, d), d),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """xx_t = x_{t-1} (first slot from x_prev or zero)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _decay(params: Dict, xw: torch.Tensor) -> torch.Tensor:
    """log w_t = −exp(base + lora(x)) ∈ (−∞, 0) — data-dependent decay."""
    lora = torch.tanh(xw @ params["w_decay_a"].to(xw.dtype)) \
        @ params["w_decay_b"].to(xw.dtype)
    return -torch.exp(torch.clamp(params["w_decay_base"][None, None]
                                  + lora.float(), -8.0, 2.0))


def _time_mix_inputs(params, x, xx):
    lerp = lambda mu: x + (xx - x) * mu[None, None].to(x.dtype)
    return (lerp(params["mu_r"]), lerp(params["mu_k"]), lerp(params["mu_v"]),
            lerp(params["mu_g"]), lerp(params["mu_w"]))


def _bonus(u: torch.Tensor, b: int, nh: int) -> torch.Tensor:
    return u.reshape(1, nh, _HEAD).expand(b, nh, _HEAD).reshape(b * nh, _HEAD)


def rwkv6_time_mix(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                   x_prev=None, h0=None, tp=UNSHARDED):
    """x: (B,T,d).  Returns (out (B,T,d), x[:, -1:], h_T (B·nh, 64, 64));
    split over ``model``, h_T holds the rank's heads."""
    b, t, d = x.shape
    dt = x.dtype
    xx = _token_shift(x, x_prev)
    xr, xk, xv, xg, xw = _time_mix_inputs(params, x, xx)
    r = tp.col(xr, "w_r") @ params["w_r"].to(dt)
    k = tp.col(xk, "w_k") @ params["w_k"].to(dt)
    v = tp.col(xv, "w_v") @ params["w_v"].to(dt)
    g = F.silu(tp.col(xg, "w_g") @ params["w_g"].to(dt))
    c = r.shape[-1]                                      # the rank's channels
    if c % _HEAD:
        raise ValueError(f"rwkv6: {_nheads(cfg)} heads do not split over "
                         f"the model axis")
    nh = c // _HEAD
    log_w = tp.pick(_decay(params, xw), "w_r")           # (B,T,c) f32

    def heads(arr):                                      # (B,T,d)→(B·nh,T,hd)
        return arr.reshape(b, t, nh, _HEAD).transpose(1, 2) \
                  .reshape(b * nh, t, _HEAD)

    u = _bonus(tp.pick(params["u_bonus"], "w_r"), b, nh)
    y, h_t = ops.linear_scan(heads(r).float(), heads(k).float(),
                             heads(v).float(), heads(log_w), h0=h0, chunk=_CHUNK,
                             strict=True, u=u)
    y = y.reshape(b, nh, t, _HEAD).transpose(1, 2).reshape(b, t, c)
    y = group_norm(y.to(dt), tp.pick(params["gn_scale"], "w_r"), nh,
                   cfg.norm_eps)
    out = tp.row((y * g) @ params["w_o"].to(dt), "w_o")
    return out, x[:, -1:], h_t


def rwkv6_channel_mix(params: Dict, x: torch.Tensor, x_prev=None,
                      tp=UNSHARDED):
    dt = x.dtype
    xx = _token_shift(x, x_prev)
    lerp = lambda mu: x + (xx - x) * mu[None, None].to(dt)
    xk, xr = lerp(params["mu_ck"]), lerp(params["mu_cr"])
    kk = torch.square(F.relu(tp.col(xk, "w_ck") @ params["w_ck"].to(dt)))
    rr = torch.sigmoid(xr @ params["w_cr"].to(dt))
    return rr * tp.row(kk @ params["w_cv"].to(dt), "w_cv"), x[:, -1:]


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    nh = _nheads(cfg)
    return {
        "x_att": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                             device=device),
        "x_ffn": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                             device=device),
        "h": torch.zeros((batch * nh, _HEAD, _HEAD), dtype=torch.float32,
                         device=device),
    }


def rwkv6_decode_time_mix(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                          state: Dict, tp=UNSHARDED):
    """x: (B,1,d).  Returns (out (B,1,d), new x_att, new h); split over
    ``model``, ``state["h"]`` is the rank's block and the new h whole."""
    b, _, d = x.shape
    nh = _nheads(cfg)
    dt = x.dtype
    xx = state["x_att"]
    xr, xk, xv, xg, xw = _time_mix_inputs(params, x, xx)
    r = tp.col_out(xr @ params["w_r"].to(dt), "w_r")[:, 0]
    k = tp.col_out(xk @ params["w_k"].to(dt), "w_k")[:, 0]
    v = tp.col_out(xv @ params["w_v"].to(dt), "w_v")[:, 0]
    g = F.silu(tp.col_out(xg @ params["w_g"].to(dt), "w_g")[:, 0])
    log_w = _decay(params, xw)[:, 0]                     # (B,d)

    hshape = lambda arr: arr.reshape(b * nh, _HEAD)
    y, h = scan_decode_step(hshape(r).float(), hshape(k).float(),
                            hshape(v).float(), hshape(log_w),
                            tp.from_state(state["h"], "h"), strict=True,
                            u=_bonus(params["u_bonus"], b, nh))
    y = y.reshape(b, 1, d).to(dt)
    y = group_norm(y, params["gn_scale"], nh, cfg.norm_eps)
    out = tp.row_in(y * g[:, None], params["w_o"], "w_o")
    return out, x, h
