"""Pieces every reference shares: Adam, TF32 rounding for the control,
and the median."""
from __future__ import annotations

from typing import Dict, List

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, nearest even): the
    operand precision of a float32 product with TF32 on.  The gradient
    passes through unchanged."""
    with torch.no_grad():
        bits = x.float().contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        low = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (low - x).detach() if x.requires_grad else low


class Precision:
    """How the reference computes its products: float32 (``control=False``)
    or, as the control, with every product's operands in TF32."""

    def __init__(self, control: bool = False):
        self.control = control

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return tf32(x) if self.control else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.cast(a), self.cast(b))

    def ein(self, eq: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.cast(x) for x in xs))


class Adam:
    """Adam (no weight decay) over a flat dict of tensors, moments in f32,
    the bias corrections taken in float32."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.step = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        """One step, written into ``params``."""
        self.step += 1
        t = torch.tensor(float(self.step), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        with torch.no_grad():
            for name, g in grads.items():
                g = g.float()
                m = self.m.get(name)
                if m is None:
                    m = self.m[name] = torch.zeros_like(g)
                    self.v[name] = torch.zeros_like(g)
                v = self.v[name]
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g * g)
                u = -(self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))
                params[name].add_(u.to(params[name].dtype))


def median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
