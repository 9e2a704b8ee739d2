"""Helpers over the port's parameter trees: nested ``dict``s of tensors.

The JAX package keeps parameters as pytrees; the port keeps them as plain
nested dicts (``{"sage0": {"w_self": Tensor, ...}, ...}``), so a tree map
is a dict comprehension and the leaves are ``torch.Tensor`` (or numpy
arrays on the host, which :func:`tree_bytes` also accepts).

Checkpoints walk richer trees — optimizer states are ``NamedTuple`` objects,
the engine's snapshot nests dicts, tuples and ``None`` — so
:func:`map_with_paths` / :func:`flatten_with_paths` name every leaf by the
path the JAX package's ``tree_flatten_with_path`` gives it: dict keys
(sorted), ``NamedTuple`` fields by name, tuple and list entries by index,
joined by ``/``; ``None`` holds no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in sorted-key order — the order of JAX's ``tree_flatten``,
    so leaf ``i`` is the same leaf in both packages (the compressed codecs
    key their per-leaf random draws by it)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def tree_bytes(tree: Any) -> int:
    """Total bytes — what PSGD-PA / LLCG send per communication round."""
    total = 0
    for x in tree_leaves(tree):
        if hasattr(x, "element_size"):          # torch.Tensor
            total += int(x.numel() * x.element_size())
        else:                                   # numpy array
            total += int(x.size * x.dtype.itemsize)
    return total


def tree_sub(a: Any, b: Any) -> Any:
    """a - b, leafwise."""
    return tree_map(lambda x, y: x - y, a, b)


def tree_dot(a: Any, b: Any) -> float:
    """<a, b> summed over every leaf in :func:`tree_leaves` order, as a
    Python float: each leaf's f32 dot product added to an f32 total, as
    ``float(tree_dot(...))`` gives in the JAX package."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = torch.vdot(x.reshape(-1).float(), y.reshape(-1).float())
        total = d if total is None else total + d
    return 0.0 if total is None else float(total)


def tree_average(trees: List[Any]) -> Any:
    """Average a list of trees — the paper's line 12 parameter averaging:
    the leafwise sum in list order, times ``1 / len(trees)``."""
    acc = trees[0]
    for t in trees[1:]:
        acc = tree_map(lambda x, y: x + y, acc, t)
    scale = 1.0 / len(trees)
    return tree_map(lambda x: x * scale, acc)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """A tree of ``tree``'s structure whose leaves are ``fn(path, leaf)``,
    ``path`` being the JAX package's ``/``-joined key of the leaf (module
    docstring), after ``prefix``."""
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, tree[k], join(k)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f), join(f))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_paths(fn, x, join(i))
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the JAX package's flatten order."""
    out: List[Tuple[str, Any]] = []
    map_with_paths(lambda k, x: out.append((k, x)), tree)
    return out
