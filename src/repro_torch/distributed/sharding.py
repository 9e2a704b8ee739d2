"""Parameter and batch partition rules, as the JAX package's
``distributed/sharding.py``.

A *spec* is a tuple with one entry per tensor dim: a mesh axis name,
``None`` (not sharded) or a tuple of axis names (sharded over their
product, the first the slowest) — the contents of a JAX
``PartitionSpec``, so the two packages' rules compare directly.  A *mesh*
is anything with axis names and sizes: a :class:`MeshSpec` (the rules need
no process group) or a ``torch.distributed.device_mesh.DeviceMesh``.

Rules are keyed by a leaf's path (its final name and whether it sits under
a MoE subtree) and padded with ``None`` for the stacking dims (``units`` →
(n_units, cnt, …), ``rem`` → (cnt, …)) and for the optional leading LLCG
group dim.  Experts go on ``model`` when their count divides its size
(expert parallelism: qwen3's 128 on 16), else they are tensor-parallel
(``d_ff`` sharded: qwen2's 60).  A dim that its axes do not divide stays
whole (:func:`_fix_divisibility`).

:func:`shard_slices` / :func:`local_shard` cut a rank's block out of a
whole tensor; the port's sharded program runs on such blocks
(:mod:`repro_torch.distributed.tensor_parallel`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.models.transformer.config import ModelConfig

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis sizes without devices or a process group (the
    counterpart of ``jax.sharding.AbstractMesh``)."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`MeshSpec` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshSpec):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def group_axis_for(mesh) -> str:
    """The LLCG machine-boundary axis: 'pod' on multi-pod, else 'data'."""
    return "pod" if "pod" in axis_names(mesh) else "data"


def data_axes_for(mesh, with_group: bool) -> Tuple[str, ...]:
    """Axes over which a *global* batch is sharded."""
    if "pod" in axis_names(mesh):
        return ("pod", "data")
    return ("data",)


def _rule_for(path_names, leaf_ndim: int, cfg: ModelConfig, mesh,
              model_axis: str = "model") -> Spec:
    name = path_names[-1]
    in_moe = "moe" in path_names
    in_shared_moe = in_moe and "shared" in path_names
    m = model_axis
    msize = axis_sizes(mesh)[model_axis]

    if name in ("embed",):
        return (m, None)
    if name in ("lm_head",):
        return (None, m)
    # attention projections shard along the head axis only; a head count
    # that the model axis does not divide replicates the projection
    if name == "wq":
        return (None, m) if cfg.num_heads % msize == 0 else (None, None)
    if name in ("wk", "wv"):
        return (None, m) if cfg.num_kv_heads % msize == 0 else (None, None)
    if name == "wo":
        return (m, None) if cfg.num_heads % msize == 0 else (None, None)
    if name == "w_in":
        return (None, m)
    if name == "w_out":
        return (m, None)
    if name in ("w_gate", "w_up", "w_down") and in_moe and not in_shared_moe:
        ep = cfg.moe is not None and cfg.moe.num_experts % msize == 0
        if name == "w_down":        # (E, f, d)
            return (m, None, None) if ep else (None, m, None)
        return (m, None, None) if ep else (None, None, m)  # (E, d, f)
    if name in ("w_gate", "w_up"):
        return (None, m)
    if name == "w_down":
        return (m, None)
    if name == "router":
        return (None, None)
    if name == "conv_w":
        return (None, m)
    if name in ("w_r", "w_k", "w_v", "w_g", "w_ck"):
        return (None, m)
    if name in ("w_o", "w_cv"):
        return (m, None)
    # everything else (norms, biases, per-head scalars, frontend
    # projectors, decay adapters) is small: replicated
    return tuple([None] * min(leaf_ndim, 2))[:leaf_ndim] or ()


def _stack_depth(path_names) -> int:
    if not path_names:
        return 0
    if path_names[0] == "units":
        return 2
    if path_names[0] == "rem":
        return 1
    return 0


def _paths(tree: Any, prefix: Tuple[str, ...] = ()):
    """``(path names, leaf)`` of a nested dict, keys sorted as JAX's
    ``tree_flatten_with_path`` orders a dict's."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _map_paths(fn, tree: Any, prefix: Tuple[str, ...] = ()) -> Any:
    """``fn(path names, leaf)`` over a nested dict, its structure (empty
    dicts included) kept."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_pspecs(param_shapes: Any, cfg: ModelConfig, mesh,
                 group_axis: Optional[str] = None) -> Any:
    """Spec tree matching ``param_shapes`` (an unstacked parameter tree:
    nested dicts of anything with a ``shape``).  ``group_axis`` prepends
    the LLCG group dim's axis (params stacked (G, …))."""
    def one(names, leaf):
        shape = tuple(leaf.shape)
        depth = _stack_depth(names)
        nd = len(shape) - depth
        base = tuple(_rule_for(names, nd, cfg, mesh))[:max(nd, 0)]
        base = base + (None,) * (max(nd, 0) - len(base))
        # never shard a dim that the mesh axis does not divide (checked on
        # the true per-dim sizes, before the group dim is prepended)
        base = _fix_divisibility((None,) * depth + base, shape, mesh)
        return ((group_axis,) if group_axis else ()) + tuple(base)
    return _map_paths(one, param_shapes)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fix_divisibility(spec, shape, mesh) -> Spec:
    sizes = axis_sizes(mesh)
    fixed = []
    for axis_name, dim in zip(spec, shape):
        if axis_name is None:
            fixed.append(None)
        else:
            total = math.prod(sizes[a] for a in _axes_of(axis_name))
            fixed.append(axis_name if dim % total == 0 else None)
    return tuple(fixed)


def batch_pspec(mesh, stacked_group: bool = False,
                extra_leading: int = 0) -> Spec:
    """Spec for (…, B, S[, d]) batch leaves.

    stacked_group: leading G dim on the group axis, batch dim on the
    remaining data axes.  extra_leading: K/S microbatch dims (replicated).
    """
    names = axis_names(mesh)
    if stacked_group:
        g = group_axis_for(mesh)
        rest = tuple(a for a in ("pod", "data") if a in names and a != g)
        # a one-axis tuple is that axis, as ``PartitionSpec`` reads it
        entry = rest if len(rest) > 1 else (rest[0] if rest else None)
        return (g, *([None] * extra_leading), entry)
    axes = data_axes_for(mesh, with_group=False)
    return (*([None] * extra_leading), axes if len(axes) > 1 else axes[0])


def shard_slices(shape: Sequence[int], spec: Spec, mesh,
                 coord: Dict[str, int]) -> Tuple[slice, ...]:
    """The block of a ``shape`` tensor that the rank at mesh coordinates
    ``coord`` (``{axis: index}``) holds under ``spec``; an entry of several
    axes splits its dim over their product, the first the slowest."""
    sizes = axis_sizes(mesh)
    out = []
    for i, n in enumerate(shape):
        axes = _axes_of(spec[i]) if i < len(spec) else ()
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if n % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {axes}")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's block shape under ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in _axes_of(
        spec[i] if i < len(spec) else None)) for i, n in enumerate(shape))


def local_shard(x, spec: Spec, mesh, coord: Dict[str, int]):
    """The rank's block of a whole tensor ``x`` (a view)."""
    return x[shard_slices(x.shape, spec, mesh, coord)]
