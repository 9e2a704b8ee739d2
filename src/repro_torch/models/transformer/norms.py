"""Normalization layers (pure functions, f32 statistics), as the JAX
package's ``models/transformer/norms.py``: statistics in f32, outputs in
the input's dtype."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics and the normalize-multiply kept in the
    input dtype; ``scale`` is stored as ``1 + scale``."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = (1.0 / torch.sqrt(var + eps)).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) / torch.sqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, num_groups: int,
               eps: float = 1e-6) -> torch.Tensor:
    """Per-head group norm used by RWKV6's output."""
    *lead, d = x.shape
    x32 = x.float().reshape(*lead, num_groups, d // num_groups)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) / torch.sqrt(var + eps)
    out = out.reshape(*lead, d) * scale
    return out.to(x.dtype)
