"""Rotary position embeddings, as the JAX package's
``models/transformer/rope.py``."""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (..., head_dim/2) for integer positions."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); cos/sin: (seq, head_dim/2), one
    angle per position shared by every row, or (batch, seq, head_dim/2),
    each row at its own positions (a slot pool's decode step); either is
    broadcast over the heads axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
