"""Pluggable compression codecs for the inter-machine collectives — the port
of the JAX package's ``comm/compress.py``.

LLCG's axis of merit is communication cost, and the accounting prices the
format that actually crosses the wire.  Two knobs on
:class:`repro_torch.core.plan.CommSpec`:

``compression``       — averaging rounds.  Each machine compresses its
    parameter *delta* (new params − round input) before the collective;
    the receivers dequantize and average.  ``int8_ef`` additionally carries
    a per-machine error-feedback residual (``EngineState.comm_residual``):
    the quantization error of round r is added back into the delta of
    round r+1.
``halo_compression``  — halo (GGS) rounds.  The cut-node feature send
    buffer is quantized row-wise (one f32 scale per node row) before the
    exchange and dequantized after.  Features are static within a round, so
    deterministic round-half-up is used and ``int8_ef`` is not a halo codec.

Wire formats priced by :func:`wire_row_bytes` / :func:`averaging_payload_bytes`:

=========  =============================================================
``none``   f32 as-is.
``bf16``   values cast to bfloat16 (round to nearest even, as JAX) —
           2 bytes/value, no side data.
``int8``   stochastic-rounding symmetric int8 — 1 byte/value + one f32
           scale per row (halo: per node row; averaging: per parameter
           leaf per machine).
``int8_ef`` same wire format as ``int8``; the residual never leaves the
           machine so it costs no bytes.
=========  =============================================================

The quantize/dequantize ops are the CUDA kernels of
:mod:`repro_torch.kernels.quantize` (their plain versions on the CPU).

**Uniforms.**  Torch cannot replay ``jax.random``, and a CUDA generator
draws other bits than a CPU one from the same seed, so stochastic rounding
draws from one explicit source, :class:`UniformStream`: a CPU
``torch.Generator`` seeded with the engine's ``comm_seed``, one
``(P, Σ numel)`` draw per averaging round, split per leaf in
:func:`repro_torch.utils.pytree.tree_leaves` order (the JAX package's leaf
order) and copied to the device in one transfer.  A run on the card and a
run on the CPU therefore see the same uniforms.  The engine takes any
object with the same ``reset`` / ``draw`` methods in its place; the parity
tests pass one that returns the JAX package's fold-chain draws.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import (dequantize_int8_rows,
                                     dequantize_int8_rows_many,
                                     quantize_int8_rows)
from repro_torch.utils.pytree import (tree_leaves, tree_map,
                                      tree_unflatten)

COMPRESSIONS = ("none", "bf16", "int8", "int8_ef")
HALO_COMPRESSIONS = ("none", "bf16", "int8")

# one f32 scale rides with every int8 row
_SCALE_BYTES = 4


def check_compression(name: str, halo: bool = False) -> str:
    """Validate a codec name (the spec-validation idiom of core.plan)."""
    allowed = HALO_COMPRESSIONS if halo else COMPRESSIONS
    if name not in allowed:
        kind = "halo_compression" if halo else "compression"
        raise ValueError(f"{kind} must be one of {allowed}, got {name!r}")
    return name


# --------------------------------------------------------------------------
# Wire-format byte pricing (the single source for the accounting)
# --------------------------------------------------------------------------
def wire_row_bytes(d: int, dtype=np.float32, compression: str = "none") -> float:
    """Bytes one ``d``-wide feature row occupies on the wire."""
    if compression == "none":
        return float(d * np.dtype(dtype).itemsize)
    if compression == "bf16":
        return float(d * 2)
    return float(d + _SCALE_BYTES)          # int8 values + per-row f32 scale


def _size_itemsize(x) -> Tuple[int, int]:
    if isinstance(x, torch.Tensor):
        return x.numel(), x.element_size()
    return int(x.size), int(x.dtype.itemsize)


def averaging_payload_bytes(params: Any, compression: str = "none") -> float:
    """Bytes one machine's compressed parameter delta occupies on the wire.

    Per-leaf scales (one f32 per parameter leaf per machine) for the int8
    codecs; for ``none`` this equals ``utils.pytree.tree_bytes`` exactly.
    Leaves may be tensors or numpy arrays.
    """
    sizes = [_size_itemsize(x) for x in tree_leaves(params)]
    if compression == "none":
        return float(sum(n * b for n, b in sizes))
    if compression == "bf16":
        return float(sum(n * 2 for n, _ in sizes))
    return float(sum(n + _SCALE_BYTES for n, _ in sizes))


# --------------------------------------------------------------------------
# Stochastic-rounding uniforms
# --------------------------------------------------------------------------
class UniformStream:
    """The uniforms of stochastic rounding, one draw per averaging round.

    A CPU ``torch.Generator`` seeded with ``seed``; :meth:`reset` restarts
    it (the engine's ``init_state`` does, so runs are reproducible).
    """

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.reset()

    def reset(self) -> None:
        self._gen = torch.Generator().manual_seed(self.seed)

    def get_state(self) -> torch.Tensor:
        """The generator's position (a uint8 tensor) — what a checkpoint
        carries so a resumed run draws the uniforms the uninterrupted one
        would."""
        return self._gen.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self._gen.set_state(state.detach().cpu())

    def draw(self, num_machines: int, sizes: Sequence[int], device
             ) -> List[torch.Tensor]:
        """One ``(num_machines, n)`` f32 block per leaf size ``n``, drawn
        as a single ``(num_machines, Σ n)`` tensor on the host and moved to
        ``device`` in one copy."""
        u = torch.rand((num_machines, int(sum(sizes))), generator=self._gen)
        return list(torch.split(u.to(device), list(sizes), dim=1))


# --------------------------------------------------------------------------
# Parameter-delta codecs (averaging rounds)
# --------------------------------------------------------------------------
def compress_tree(delta: Any, compression: str,
                  u: Optional[Sequence[torch.Tensor]] = None,
                  stacked: bool = False) -> Tuple[Any, Optional[Any]]:
    """Compress a parameter-delta tree → ``(payload, scales)``.

    ``stacked=True`` means leaves carry a leading machine axis and get
    per-machine scales.  ``u`` holds one uniform block per leaf in
    :func:`tree_leaves` order, shaped ``(rows, leaf numel / rows)``
    (:meth:`UniformStream.draw`); ``u=None`` means deterministic rounding.
    ``scales`` is None for ``none``/``bf16``.
    """
    if compression == "none":
        return delta, None
    if compression == "bf16":
        return tree_map(lambda x: x.to(torch.bfloat16), delta), None
    payloads, scales = [], []
    for i, leaf in enumerate(tree_leaves(delta)):
        rows = leaf.shape[0] if stacked else 1
        flat = leaf.reshape(rows, -1)
        q, s = quantize_int8_rows(flat, None if u is None
                                  else u[i].reshape(flat.shape))
        payloads.append(q.reshape(leaf.shape))
        scales.append(s)
    return tree_unflatten(delta, payloads), tree_unflatten(delta, scales)


def decompress_tree(payload: Any, scales: Optional[Any],
                    compression: str) -> Any:
    """Inverse of :func:`compress_tree` — an f32 tree (rows are read off the
    scale leaf, so a stacked payload dequantizes per machine).  Every leaf
    dequantizes in one grouped call, in :func:`tree_leaves` order: one
    kernel launch on the card."""
    if compression == "none":
        return payload
    if compression == "bf16":
        return tree_map(lambda x: x.float(), payload)
    qs, ss = tree_leaves(payload), tree_leaves(scales)
    # a stacked leaf (P, …) with its (P, 1) scales goes as it is: row p is
    # machine p's slice; anything else is reshaped to rows first
    rows = [(q, s) if q.dim() and s.shape == (q.shape[0], 1)
            else (q.reshape(s.numel(), -1), s.reshape(-1, 1))
            for q, s in zip(qs, ss)]
    outs = dequantize_int8_rows_many([q for q, _ in rows],
                                     [s for _, s in rows])
    return tree_unflatten(payload, [o if o.shape == q.shape
                                    else o.reshape(q.shape)
                                    for o, q in zip(outs, qs)])


# --------------------------------------------------------------------------
# Feature-buffer codecs (halo rounds)
# --------------------------------------------------------------------------
def compress_features(x: torch.Tensor, compression: str
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Compress a ``(rows, d)`` feature send buffer → ``(payload, scales)``.

    Deterministic round-half-up, one f32 scale per row for int8.
    """
    if compression == "none":
        return x, None
    if compression == "bf16":
        return x.to(torch.bfloat16), None
    return quantize_int8_rows(x)


def decompress_features(payload: torch.Tensor,
                        scales: Optional[torch.Tensor],
                        compression: str) -> torch.Tensor:
    """Inverse of :func:`compress_features` — f32 ``(rows, d)``.  Accepts
    a ``(…, rows, d)`` payload too (flattened to rows)."""
    if compression == "none":
        return payload
    if compression == "bf16":
        return payload.float()
    d = payload.shape[-1]
    out = dequantize_int8_rows(payload.reshape(-1, d), scales.reshape(-1, 1))
    return out.reshape(payload.shape)
