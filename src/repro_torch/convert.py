"""Carry parameters across from the JAX package.

The JAX package's params are a nested dict of arrays; pass them as numpy
(``jax.tree_util.tree_map(np.asarray, model.init(seed))``) and get the
port's nested dict of tensors, bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(np_params: Any, device="cuda") -> Any:
    """A nested dict of numpy arrays → the same dict of tensors on
    ``device`` (the GPU unless the caller passes another), bit for bit, at
    any nesting depth: the GNN's ``{layer: {name: array}}`` and the JAX
    ``LM.init`` tree alike (whose ``units`` leaves are ``(n_units, count,
    …)`` stacks in both packages)."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    return torch.from_numpy(np.array(np_params, copy=True)).to(device)


#: the LM's entry point; the same conversion
lm_params_from_jax = params_from_jax
