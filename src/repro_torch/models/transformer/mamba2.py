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

Split over ``model`` (``tp``, :mod:`.parallel`), a rank runs its own heads:
the fused projection's and the conv's columns are split across the
segments (z, x, B, C, Δt), so each is gathered whole and the rank takes its
heads' columns (and B, C, which every head reads); the gated RMSNorm over
``d_inner`` sums its squares over the ranks; ``w_out`` is row-parallel.
Decode steps a replicated state: the projection's output and the conv's
weights are gathered, the output is row-parallel.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.norms import rms_norm
from repro_torch.models.transformer.parallel import UNSHARDED
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
              cfg: ModelConfig, tp=UNSHARDED) -> torch.Tensor:
    """The gated RMSNorm over d_inner and the output projection; split,
    the rank's channels normalised by the statistic of all of them."""
    if not tp.sharded("w_out"):
        y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
        return y @ params["w_out"].to(y.dtype)
    yz = y * F.silu(z)
    sq = yz.float().square().sum(dim=-1, keepdim=True)
    var = tp.enter(tp.reduce(sq)) / _dims(cfg)[0]
    inv = (1.0 / torch.sqrt(var + cfg.norm_eps)).to(yz.dtype)
    y = yz * inv * (1.0 + params["norm"]).to(yz.dtype)
    return tp.row(y @ params["w_out"].to(y.dtype), "w_out")


def _rank_params(params: Dict, cfg: ModelConfig, tp):
    """The rank's heads' parameters (all of them unsplit): the fused
    projection's and the conv's columns of its heads (every segment's)
    and of B and C, and its heads' per-head and per-channel leaves.
    Returns (params, first head, heads)."""
    d_inner, n_heads, hd, ds, _ = _dims(cfg)
    if not tp.sharded("w_out"):
        return params, 0, n_heads
    if n_heads % tp.size:
        raise ValueError(f"mamba2: {n_heads} heads do not split over "
                         f"{tp.size} model ranks")
    h_loc = n_heads // tp.size
    h0 = tp.rank * h_loc
    c0, c = h0 * hd, h_loc * hd
    span = lambda a, n: torch.arange(a, a + n, device=params["w_in"].device)
    cols = torch.cat([span(c0, c), span(d_inner + c0, c),
                      span(2 * d_inner, 2 * ds),
                      span(2 * d_inner + 2 * ds + h0, h_loc)])
    conv_cols = torch.cat([span(c0, c), span(d_inner, 2 * ds)])
    heads = span(h0, h_loc)
    whole = lambda name: tp.gather(params[name], 1, name)
    return {"w_in": tp.take(whole("w_in"), cols, 1),
            "conv_w": tp.take(whole("conv_w"), conv_cols, 1),
            "conv_b": tp.take(params["conv_b"], conv_cols, 0),
            "dt_bias": tp.take(params["dt_bias"], heads, 0),
            "a_log": tp.take(params["a_log"], heads, 0),
            "d_skip": tp.take(params["d_skip"], heads, 0),
            "norm": tp.take(params["norm"], span(c0, c), 0),
            "w_out": params["w_out"]}, h0, h_loc


def mamba2_prefill(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                   tp=UNSHARDED, state: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The block's forward and its decode state: the conv's input tail
    (the last K−1 steps, zeros before the prompt) and the scan's final
    ``h`` — the JAX package's ``blocks._mamba2_prefill``.  x: (B, T, d).
    Split over ``model``, the rank's heads; the state (``state=True``)
    is every head's."""
    bsz, t, _ = x.shape
    _, _, hd, ds, ck = _dims(cfg)
    params, _, n_heads = _rank_params(params, cfg, tp)
    d_inner = n_heads * hd                       # the rank's channels
    dt_x = x.dtype
    z, xs, bmat, cmat, dt_raw = torch.split(
        tp.col(x, "w_out") @ params["w_in"].to(dt_x),
        [d_inner, d_inner, ds, ds, n_heads], dim=-1)
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
    out = _gate_out(params, y.reshape(bsz, t, d_inner).to(dt_x), z, cfg, tp)
    if not state:
        return out, {}
    tail = F.pad(conv_in, (0, 0, max(0, ck - 1 - t), 0))[:, -(ck - 1):]
    if tp.sharded("w_out"):                      # every head's
        tail = torch.cat([tp.gather(tail[..., :d_inner], -1, "w_out"),
                          tail[..., d_inner:]], dim=-1)
        h_t = tp.gather(h_t.reshape(bsz, n_heads, ds, hd), 1,
                        "w_out").reshape(-1, ds, hd)
    return out, {"conv": tail, "h": h_t}


def mamba2_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                   tp=UNSHARDED) -> torch.Tensor:
    return mamba2_prefill(params, x, cfg, tp, state=False)[0]


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
                  state: Dict, tp=UNSHARDED) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d).  One step of the conv and the recurrence
    (:func:`scan_decode_step`, the decay broadcast over d_state).  Split
    over ``model``, ``state`` is the rank's block and the new one whole."""
    bsz = x.shape[0]
    d_inner, n_heads, hd, ds, _ = _dims(cfg)
    dt_x = x.dtype
    z, xs, bmat, cmat, dt_raw = _split_proj(
        cfg, tp.col_out(x[:, 0] @ params["w_in"].to(dt_x), "w_in"))
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)                # (B, C)
    window = torch.cat([tp.from_state(state["conv"], "conv")
                        .to(conv_in.dtype), conv_in[:, None]], dim=1)
    conv_w = tp.col_out(params["conv_w"], "conv_w")
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, conv_w.to(dt_x))
                      + params["conv_b"].to(dt_x))
    xs, bmat, cmat = torch.split(conv_out, [d_inner, ds, ds], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])          # (B,H)
    log_w = dt * -torch.exp(params["a_log"].float())
    xh = xs.reshape(bsz, n_heads, hd)
    q = cmat.float()[:, None].expand(bsz, n_heads, ds).reshape(-1, ds)
    k = (dt[..., None] * bmat.float()[:, None]).reshape(-1, ds)
    lw = log_w[..., None].expand(bsz, n_heads, ds).reshape(-1, ds)
    y, h = scan_decode_step(q, k, xh.reshape(-1, hd).float(), lw,
                            tp.from_state(state["h"], "h"))
    y = y.reshape(bsz, n_heads, hd) + \
        params["d_skip"][None, :, None] * xh.float()
    y = rms_norm(y.reshape(bsz, d_inner).to(dt_x) * F.silu(z),
                 params["norm"], cfg.norm_eps)
    out = tp.row_in(y, params["w_out"], "w_out")
    return out[:, None], {"conv": window[:, 1:], "h": h}
