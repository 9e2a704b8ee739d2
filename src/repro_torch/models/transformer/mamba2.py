"""Mamba2 (SSD) block — the zamba2 backbone — as the JAX package's
``models/transformer/mamba2.py``.

A fused input projection gives (z gate, x, B, C, Δt); a short causal
depthwise conv runs over (x, B, C), then the SSD scan, a gated RMSNorm
over the whole d_inner (n_groups = 1) and the output projection.  The scan
is the shared chunked linear recurrence with

    q = C,   k = Δt·B,   v = x_head,   log_w = Δt·A   (one scalar per head)

i.e. a (d_state × head_dim) state per head.  The decay goes to the scan as
it is, (B·H, T), not broadcast over d_state: the scan's scalar-decay route
(the kernel's segsum form on the card), which stays finite where the JAX
package's factored form overflows (ROADMAP.md Queue 3).  Decode carries
(conv tail, h).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.norms import rms_norm
from repro_torch.models.transformer.scan_common import (chunked_scan,
                                                        scan_decode_step)


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = ssm.num_heads or d_inner // ssm.head_dim
    return d_inner, n_heads, ssm.head_dim, ssm.state_dim, ssm.conv_kernel


def init_mamba2_params(cfg: ModelConfig, rng) -> Dict[str, torch.Tensor]:
    """f32 CPU tensors drawn from ``rng`` (a :class:`TorchRng`) in the JAX
    package's order: Δt's initial values, then w_in, conv_w, w_out."""
    d = cfg.d_model
    d_inner, n_heads, _, ds, ck = _dims(cfg)
    d_proj = 2 * d_inner + 2 * ds + n_heads

    def dense(shape, fan_in):
        return rng.standard_normal(shape) / math.sqrt(fan_in)

    dt_init = torch.exp(rng.uniform(math.log(1e-3), math.log(1e-1),
                                    (n_heads,)))
    return {
        "w_in": dense((d, d_proj), d),
        "conv_w": rng.standard_normal((ck, d_inner + 2 * ds)) * 0.2,
        "conv_b": torch.zeros(d_inner + 2 * ds),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads)),
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "d_skip": torch.ones(n_heads),
        "norm": torch.zeros(d_inner),
        "w_out": dense((d_inner, d), d_inner),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """(z, x, B, C, Δt) of the fused projection."""
    d_inner, n_heads, _, ds, _ = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner, ds, ds, n_heads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, T, C) with kernel (K, C), then SiLU."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:xp.shape[1] - (k - 1 - i)] * w[i] for i in range(k))
    return F.silu(out + b)


def _gate_out(params: Dict, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The gated RMSNorm over d_inner and the output projection."""
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["w_out"].to(y.dtype)


def mamba2_prefill(params: Dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The block's forward and its decode state: the conv's input tail
    (the last K−1 steps, zeros before the prompt) and the scan's final
    ``h`` — the JAX package's ``blocks._mamba2_prefill``.  x: (B, T, d)."""
    bsz, t, _ = x.shape
    d_inner, n_heads, hd, ds, ck = _dims(cfg)
    dt_x = x.dtype
    z, xs, bmat, cmat, dt_raw = _split_proj(cfg, x @ params["w_in"].to(dt_x))
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"].to(dt_x),
                            params["conv_b"].to(dt_x))
    xs, bmat, cmat = torch.split(conv_out, [d_inner, ds, ds], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])          # (B,T,H)
    a = -torch.exp(params["a_log"].float())                      # (H,) < 0
    # heads lead: (B,H,T,·) → (B·H, T, ·); B and C shared by the heads
    dt_h = dt.transpose(1, 2)                                    # (B,H,T)
    xh = xs.reshape(bsz, t, n_heads, hd)
    q = cmat.float()[:, None].expand(bsz, n_heads, t, ds)
    k = dt_h[..., None] * bmat.float()[:, None]
    v = xh.float().transpose(1, 2)
    y, h_t = chunked_scan(q.reshape(bsz * n_heads, t, ds),
                          k.reshape(bsz * n_heads, t, ds),
                          v.reshape(bsz * n_heads, t, hd),
                          (dt_h * a[:, None]).reshape(bsz * n_heads, t),
                          chunk=cfg.ssm.chunk)
    y = y.reshape(bsz, n_heads, t, hd).transpose(1, 2)
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    out = _gate_out(params, y.reshape(bsz, t, d_inner).to(dt_x), z, cfg)
    tail = F.pad(conv_in, (0, 0, max(0, ck - 1 - t), 0))[:, -(ck - 1):]
    return out, {"conv": tail, "h": h_t}


def mamba2_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    return mamba2_prefill(params, x, cfg)[0]


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------
def init_mamba2_state(cfg: ModelConfig, batch: int, dtype,
                      device) -> Dict[str, torch.Tensor]:
    d_inner, n_heads, hd, ds, ck = _dims(cfg)
    return {"conv": torch.zeros((batch, ck - 1, d_inner + 2 * ds),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch * n_heads, ds, hd), dtype=torch.float32,
                             device=device)}


def mamba2_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d).  One step of the conv and the recurrence
    (:func:`scan_decode_step`, the decay broadcast over d_state)."""
    bsz = x.shape[0]
    d_inner, n_heads, hd, ds, _ = _dims(cfg)
    dt_x = x.dtype
    z, xs, bmat, cmat, dt_raw = _split_proj(
        cfg, x[:, 0] @ params["w_in"].to(dt_x))
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)                # (B, C)
    window = torch.cat([state["conv"].to(conv_in.dtype),
                        conv_in[:, None]], dim=1)                # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window,
                                   params["conv_w"].to(dt_x))
                      + params["conv_b"].to(dt_x))
    xs, bmat, cmat = torch.split(conv_out, [d_inner, ds, ds], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])          # (B,H)
    log_w = dt * -torch.exp(params["a_log"].float())
    xh = xs.reshape(bsz, n_heads, hd)
    q = cmat.float()[:, None].expand(bsz, n_heads, ds).reshape(-1, ds)
    k = (dt[..., None] * bmat.float()[:, None]).reshape(-1, ds)
    lw = log_w[..., None].expand(bsz, n_heads, ds).reshape(-1, ds)
    y, h = scan_decode_step(q, k, xh.reshape(-1, hd).float(), lw,
                            state["h"])
    y = y.reshape(bsz, n_heads, hd) + \
        params["d_skip"][None, :, None] * xh.float()
    out = _gate_out(params, y.reshape(bsz, d_inner).to(dt_x), z, cfg)
    return out[:, None], {"conv": window[:, 1:], "h": h}
