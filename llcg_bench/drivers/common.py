"""Helpers the drivers share: flattening parameter trees, the worst-leaf
comparison, memory and device facts."""
from __future__ import annotations

import gc
import math
from typing import Dict, Iterable, Optional

import torch

from llcg_bench.reference.common import median

#: A leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone (Adam's first step is +-lr whatever the
#: gradient): it is left out of the gradient and change comparisons.
ZERO_GRADIENT_SHARE = 1e-3


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tree.items()}


def kept_leaves(ref_grad: Dict[str, float]) -> Iterable[str]:
    med = median(list(ref_grad.values()))
    return [k for k, v in ref_grad.items() if v >= ZERO_GRADIENT_SHARE * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str]) -> Dict[str, float]:
    """Per leaf, the gap between the program's and the reference's norm,
    over the larger of that leaf's reference norm and the median leaf's
    (inf where the program's is missing or not finite)."""
    keep = list(keep)
    med = median([ref[k] for k in keep])
    out = {}
    for k in keep:
        gap = abs(prog.get(k, float("nan")) - ref[k]) / max(ref[k], med,
                                                             1e-30)
        out[k] = gap if math.isfinite(gap) else float("inf")
    return out


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Iterable[str]) -> float:
    """The largest of :func:`leaf_gaps`."""
    return max(leaf_gaps(prog, ref, keep).values(), default=float("inf"))


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 keep: Iterable[str], count: int = 4) -> list:
    """The ``count`` leaves with the largest gaps, ``[name, program norm,
    reference norm]``, for the run's record."""
    keep = list(keep)
    med = median([ref[k] for k in keep])
    gap = lambda k: abs(prog.get(k, float("nan")) - ref[k]) / max(
        ref[k], med, 1e-30)
    return [[k, prog.get(k), ref[k]]
            for k in sorted(keep, key=gap, reverse=True)[:count]]


def relative_gap(prog, ref) -> float:
    worst = 0.0
    for a, b in zip(prog, ref):
        gap = abs(a - b) / max(abs(b), 1e-30)
        if not math.isfinite(gap):
            return float("inf")
        worst = max(worst, gap)
    return worst


def generator(seed: int, device) -> torch.Generator:
    dev = torch.device(device)
    g = torch.Generator(device=dev.type if dev.type == "cpu" else dev)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def peak_bytes(device) -> Optional[int]:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return None
