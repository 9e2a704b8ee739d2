"""Learning-rate schedules (callables step -> lr), the JAX package's
``optim/schedules.py``.

Each schedule takes the step as a Python int or a tensor and returns a 0-d
float32 tensor, computed in float32 as the reference computes it.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_lr(lr: float):
    def sched(step):
        del step
        return torch.tensor(lr, dtype=torch.float32)
    return sched


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def sched(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return sched


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                         floor: float = 0.0):
    def sched(step):
        s = _f32(step)
        warm = peak * s / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, cos)
    return sched
