"""Initialization RNG over a CPU ``torch.Generator``.

The counterpart of the JAX package's ``JaxRng``: the same small
Generator-like surface (``standard_normal``/``random``/``uniform``/
``fork``) that the init functions use.  Draws are made on the CPU whatever
the model's device, so one seed gives the same weights on the card and on
the CPU; the caller moves them afterwards.  ``jax.random`` cannot be
replayed in torch, so parity with the JAX package goes through carried-over
weights (:func:`repro_torch.convert.lm_params_from_jax`), not through init.
"""
from __future__ import annotations

import torch


class TorchRng:
    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cpu").manual_seed(int(seed))

    def fork(self) -> "TorchRng":
        """An independent stream, seeded by a draw from this one."""
        return TorchRng(int(torch.randint(0, 2 ** 62, (), generator=self.gen)))

    @staticmethod
    def _shape(shape):
        return (shape,) if isinstance(shape, int) else tuple(shape)

    def standard_normal(self, shape=()) -> torch.Tensor:
        return torch.randn(self._shape(shape), generator=self.gen)

    def random(self, shape=()) -> torch.Tensor:
        return torch.rand(self._shape(shape), generator=self.gen)

    def uniform(self, low=0.0, high=1.0, shape=()) -> torch.Tensor:
        return low + (high - low) * self.random(shape)
