"""One rank's view of the LM split over a ``DeviceMesh``: tensor
parallelism over the ``model`` axis with every collective explicit and
counted.

Where the JAX package lets GSPMD partition ``LM.loss`` under the rules of
:mod:`repro_torch.distributed.sharding`, the port runs the model's own code
(:class:`~repro_torch.models.transformer.model.LM` and its blocks) on the
rank's local shards, handing every entry point a :class:`ModelShard`: the
rank's view of which leaves are split, whose crossings are the collectives
(:mod:`repro_torch.models.transformer.parallel` describes the interface;
on one device every crossing is the identity).  The layout is Megatron's,
as the rules describe it: column-parallel projections give each rank its
heads or its slice of ``d_ff``; row-parallel ones give partial sums, which
one all-reduce over ``model`` completes.  The hand-written kernels (the
scan and its gradient) run on the local heads as they are: batch rows and
heads never cross ranks.

Every tensor is either *replicated* over ``model`` — the same value on every
model rank, and (under autograd) the same gradient — or *local*.  The
crossings are autograd functions, each one collective on the way in or on
the way back (the ``f``/``g`` operators of Megatron-LM):

  :meth:`ShardComm.reduce`  local partial sums → replicated (all-reduce;
                            backward passes the gradient on);
  :meth:`ShardComm.enter`   replicated → input of local compute (identity;
                            backward all-reduces the partial gradients);
  :meth:`ShardComm.gather`  local slices → replicated (all-gather; backward
                            keeps the rank's slice);
  :meth:`ShardComm.take`    a replicated tensor's entries that this rank
                            uses (index select; backward all-reduces the
                            scattered gradient).

Two ops DTensor has no correct rule for are written on local shards
(:meth:`ModelShard.lookup`, :meth:`ModelShard.vocab_nll`): the
vocab-sharded embedding lookup (each rank looks up its rows, one
all-reduce) and the loss over vocab-sharded logits (max, sum of
exponentials and target logit, each one all-reduce).

Data parallelism: a batch sharded over data axes gives each rank its rows;
``LM.loss_terms`` returns the rank's share of the global loss (its sum of
token losses over the global count), so summing the ranks' gradients over
those axes gives the global gradient.

:class:`ShardComm` counts every collective's per-device result bytes by
kind (an all-reduce twice, as the JAX dry run prices it), by the mesh axes
its group spans, and as inter-group (crossing the LLCG group axis) or
intra-group traffic.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.hints import get_hint
from repro_torch.distributed.sharding import (_axes_of, _stack_depth,
                                              axis_sizes, group_axis_for)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
MODEL = ("model",)


# --------------------------------------------------------------------------
# The rank's view of the mesh, its collectives and their bytes
# --------------------------------------------------------------------------
class ShardComm:
    """One rank of a ``DeviceMesh``: its axis sizes, its coordinate, the
    process group of each set of axes, and the bytes of every collective
    it takes part in (:meth:`summary`)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.sizes = axis_sizes(device_mesh)
        self.names = tuple(self.sizes)
        self.coord = dict(zip(self.names, device_mesh.get_coordinate()))
        self.group_axis = group_axis_for(device_mesh)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        # the groups are made now, outside any fake-tensor trace (a
        # DeviceMesh computes them with real tensors)
        for axes in [(a,) for a in self.names] + [
                self.axes(("pod", "data"))]:
            if axes and all(self.sizes[a] > 1 for a in axes):
                self.group(axes)
        self.reset()

    # ---------------------------------------------------------- accounting
    def reset(self) -> None:
        self.bytes = {k: 0.0 for k in KINDS}
        self.by_span: Dict[str, float] = {}
        self.calls = 0

    def summary(self) -> Dict[str, Any]:
        """Per-device bytes by kind, ``total``, ``inter_group`` (groups
        that span the LLCG group axis), ``intra_group`` and ``by_span`` —
        the keys of the JAX dry run's ``collective`` record."""
        out: Dict[str, Any] = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        out["inter_group"] = sum(v for s, v in self.by_span.items()
                                 if self.group_axis in s.split("+"))
        out["intra_group"] = out["total"] - out["inter_group"]
        out["by_span"] = dict(self.by_span)
        out["calls"] = self.calls
        return out

    def _count(self, kind: str, nbytes: float, axes) -> None:
        self.bytes[kind] += nbytes
        span = "+".join(axes)
        self.by_span[span] = self.by_span.get(span, 0.0) + nbytes
        self.calls += 1

    # -------------------------------------------------------------- groups
    def axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` in mesh order, without the axes of size 1."""
        return tuple(a for a in self.names if a in axes and self.sizes[a] > 1)

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.sizes[a] for a in axes if a in self.sizes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` (the first the slowest)."""
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.coord[a]
        return idx

    def group(self, axes: Tuple[str, ...]):
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.device_mesh.get_group(axes[0])
            else:
                self._groups[axes] = self.device_mesh[axes]._flatten(
                    "_".join(axes)).get_group()
        return self._groups[axes]

    # ------------------------------------------------- raw collectives
    def all_reduce(self, x: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        """A new tensor holding the sum (or max) of ``x`` over ``axes``."""
        axes = self.axes(axes)
        if not axes:
            return x
        y = x.detach().clone().contiguous()
        self._count("all-reduce", 2.0 * y.numel() * y.element_size(), axes)
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group(axes))
        return y

    def all_gather(self, x: torch.Tensor, dim: int,
                   axes: Sequence[str]) -> torch.Tensor:
        """The ranks' ``x`` along ``axes`` concatenated on ``dim`` in rank
        order."""
        axes = self.axes(axes)
        if not axes:
            return x
        x = x.detach().contiguous()
        n = self.size(axes)
        self._count("all-gather", float(n * x.numel() * x.element_size()),
                    axes)
        outs = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(outs, x, group=self.group(axes))
        return torch.cat(outs, dim=dim)

    def local_slice(self, x: torch.Tensor, dim: int,
                    axes: Sequence[str]) -> torch.Tensor:
        """This rank's equal slice of ``x`` along ``dim`` over ``axes``."""
        axes = self.axes(axes)
        if not axes:
            return x
        n = x.shape[dim] // self.size(axes)
        return x.narrow(dim, self.index(axes) * n, n)

    # ----------------------------------------------- autograd crossings
    def reduce(self, x, axes=MODEL):
        return _Reduce.apply(x, self, tuple(axes)) if self.axes(axes) else x

    def enter(self, x, axes=MODEL):
        return _Enter.apply(x, self, tuple(axes)) if self.axes(axes) else x

    def gather(self, x, dim: int, axes=MODEL):
        if not self.axes(axes):
            return x
        return _Gather.apply(x, self, dim % x.dim(), tuple(axes))

    def take(self, x, index: torch.Tensor, dim: int, axes=MODEL):
        return _Take.apply(x, self, index, dim % x.dim(), tuple(axes))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axes):
        ctx.comm, ctx.dim, ctx.axes = comm, dim, axes
        return comm.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.local_slice(g, ctx.dim, ctx.axes).contiguous(),
                None, None, None)


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, index, dim, axes):
        ctx.comm, ctx.dim, ctx.axes = comm, dim, axes
        ctx.shape = x.shape
        ctx.save_for_backward(index)
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        full = g.new_zeros(ctx.shape).index_add_(ctx.dim, index, g)
        return ctx.comm.all_reduce(full, ctx.axes), None, None, None, None


# --------------------------------------------------------------------------
# Which dim of each leaf is sharded over ``model``
# --------------------------------------------------------------------------
def model_dims(specs: Any) -> Any:
    """The layer-level dim (stacking dims removed) that ``model`` shards
    in each leaf of a parameter spec tree, or None."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        depth = _stack_depth(path)
        dims = [i - depth for i, e in enumerate(tree)
                if "model" in _axes_of(e)]
        return dims[0] if dims else None
    return walk(specs, ())


# --------------------------------------------------------------------------
# The rank's view of the model's split
# --------------------------------------------------------------------------
class ModelShard:
    """The view of one rank that the LM's entry points take as ``tp``
    (:mod:`repro_torch.models.transformer.parallel`): which leaves of a
    parameter subtree are split over ``model`` (``md``, from
    :func:`model_dims`), a layer's decode-state specs (``state``, the dry
    run's state rules without the stacking dims), the axes that split the
    batch, and the crossings between them over ``comm``."""

    def __init__(self, comm: ShardComm, md: Any, state: Optional[Dict] = None,
                 batch_axes: Sequence[str] = ()):
        self.comm = comm
        self.md = md
        self.state = state
        self.batch_axes = comm.axes(batch_axes)
        self.batch_shards = comm.size(self.batch_axes)
        self.size = comm.sizes.get("model", 1)
        self.rank = comm.coord.get("model", 0)

    @classmethod
    def of(cls, comm: ShardComm, param_specs: Dict,
           state_specs: Optional[Dict] = None,
           batch_axes: Sequence[str] = ()) -> "ModelShard":
        """The whole model's view: ``param_specs`` the unstacked spec tree
        (:func:`~repro_torch.distributed.sharding.param_pspecs` without the
        group axis), ``state_specs`` the decode states' specs."""
        return cls(comm, model_dims(param_specs), state_specs, batch_axes)

    def __getitem__(self, name: str) -> "ModelShard":
        return ModelShard(self.comm, self.md[name], self.state,
                          self.batch_axes)

    def layer(self, group: str, key: str, depth: int) -> "ModelShard":
        md = self.md["shared"] if key.startswith("s") else \
            self.md[group][key]
        state = None if self.state is None else {
            n: s[depth:] for n, s in self.state[group][key].items()}
        return ModelShard(self.comm, md, state, self.batch_axes)

    def sharded(self, name: str) -> bool:
        return self.md[name] is not None

    @property
    def vocab_sharded(self) -> bool:
        return self.sharded("lm_head" if "lm_head" in self.md else "embed")

    # ------------------------------------------------- model-axis crossings
    def col(self, x, name: str):
        return self.comm.enter(x) if self.sharded(name) else x

    def row(self, x, name: str):
        return self.comm.reduce(x) if self.sharded(name) else x

    def enter(self, x):
        return self.comm.enter(x)

    def reduce(self, x):
        return self.comm.reduce(x)

    def take(self, x, index: torch.Tensor, dim: int):
        return self.comm.take(x, index, dim)

    def pick(self, x, name: str, dim: int = -1):
        if not self.sharded(name):
            return x
        n = x.shape[dim] // self.size
        return self.comm.take(x, torch.arange(
            self.rank * n, (self.rank + 1) * n, device=x.device), dim)

    def gather(self, x, dim: int, name: str):
        return self.comm.gather(x, dim) if self.sharded(name) else x

    def local_slice(self, x, dim: int):
        return self.comm.local_slice(x, dim, MODEL)

    def all_reduce(self, x):
        return self.comm.all_reduce(x, MODEL)

    def all_gather(self, x, dim: int):
        return self.comm.all_gather(x, dim, MODEL)

    # decode (no autograd): a column-parallel output gathered whole; a
    # row-parallel product of a replicated input, its slice times the
    # rank's rows, summed
    def col_out(self, y, name: str, dim: int = -1):
        return self.all_gather(y, dim) if self.sharded(name) else y

    def row_in(self, y, w, name: str):
        if not self.sharded(name):
            return y @ w.to(y.dtype)
        return self.all_reduce(self.local_slice(y, -1) @ w.to(y.dtype))

    # ----------------------------------------------------------- states
    def state_dim(self, name: str) -> Optional[int]:
        """The dim of state leaf ``name`` that ``model`` splits."""
        if self.state is None or name not in self.state:
            return None
        dims = [i for i, e in enumerate(self.state[name])
                if "model" in _axes_of(e)]
        return dims[0] if dims else None

    def to_state(self, tree: Dict) -> Dict:
        """A state replicated over ``model`` → the rank's block of it (its
        data dims are local already; ``model`` is the fastest axis of the
        dim it splits)."""
        out = {}
        for name, x in tree.items():
            d = self.state_dim(name)
            out[name] = x if d is None else self.local_slice(x, d)
        return out

    def from_state(self, x, name: str):
        d = self.state_dim(name)
        return x if d is None else self.all_gather(x, d)

    # -------------------------------------------------------- vocabulary
    def lookup(self, table, tokens):
        """Embedding rows: with the table's rows on ``model``, each rank
        looks up the tokens in its range and one all-reduce sums the rows
        (a token's row is exact: the other ranks add zeros)."""
        if not self.sharded("embed"):
            return table[tokens]
        n = table.shape[0]
        lo = self.rank * n
        inside = (tokens >= lo) & (tokens < lo + n)
        rows = table[(tokens - lo).clamp(0, n - 1)] * inside[..., None]
        return self.comm.reduce(rows)

    def vocab_nll(self, logits32, labels):
        """Cross entropy over logits whose vocab is split over ``model``
        (this rank's slice)."""
        n = logits32.shape[-1]
        lo = self.rank * n
        top = self.comm.all_reduce(logits32.detach().amax(-1), MODEL,
                                   op="max")
        lse = top + torch.log(self.comm.reduce(
            torch.exp(logits32 - top[..., None]).sum(-1)))
        inside = (labels >= lo) & (labels < lo + n)
        picked = logits32.gather(
            -1, (labels - lo).clamp(0, n - 1)[..., None])[..., 0]
        target = self.comm.reduce(torch.where(
            inside, picked, torch.zeros((), device=picked.device)))
        return lse - target

    # ------------------------------------------------------ data shards
    def batch_sum(self, x):
        return self.comm.all_reduce(x, self.batch_axes)

    def batch_mean(self, x, dim: int):
        if not self.batch_axes:
            return x.mean(dim=dim)
        return self.comm.reduce(x.sum(dim=dim), self.batch_axes) / (
            x.shape[dim] * self.batch_shards)

    def counts_before(self, counts):
        """The MoE's per-expert counts of the data shards before this one,
        and of all of them."""
        every = self.comm.all_gather(counts, 0, self.batch_axes)
        before = every[:self.comm.index(self.batch_axes)]
        return before.sum(0, keepdim=True), every.sum(0, keepdim=True)

    def expert_sum(self, y):
        return self.comm.reduce(y, (get_hint("expert_axis") or "model",))
