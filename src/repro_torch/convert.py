"""Carry parameters across from the JAX package.

The JAX package's params are a nested dict of arrays; pass them as numpy
(``jax.tree_util.tree_map(np.asarray, model.init(seed))``) and get the
port's nested dict of tensors, bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(np_params: Dict, device="cuda"
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {name: array}}`` → ``{layer: {name: Tensor}}`` on
    ``device`` (the GPU unless the caller passes another)."""
    return {layer: {name: torch.from_numpy(np.array(a, copy=True)).to(device)
                    for name, a in leaves.items()}
            for layer, leaves in np_params.items()}
