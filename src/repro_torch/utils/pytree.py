"""Helpers over the port's parameter trees: nested ``dict``s of tensors.

The JAX package keeps parameters as pytrees; the port keeps them as plain
nested dicts (``{"sage0": {"w_self": Tensor, ...}, ...}``), so a tree map
is a dict comprehension and the leaves are ``torch.Tensor`` (or numpy
arrays on the host, which :func:`tree_bytes` also accepts).
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in insertion order (the order every tree map visits)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` in visit order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_bytes(tree: Any) -> int:
    """Total bytes — what PSGD-PA / LLCG send per communication round."""
    total = 0
    for x in tree_leaves(tree):
        if hasattr(x, "element_size"):          # torch.Tensor
            total += int(x.numel() * x.element_size())
        else:                                   # numpy array
            total += int(x.size * x.dtype.itemsize)
    return total
