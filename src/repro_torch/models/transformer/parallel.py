"""How a block meets the ranks that share its layer: the model on one device.

Every entry point of the model (:class:`~repro_torch.models.transformer.
model.LM`) and every block function takes a ``tp`` argument, the rank's
view of how the parameters it is given are split over a mesh's ``model``
axis and its batch over the data axes.  The block functions are written
once: where a leaf is split they cross between the rank's local shards and
replicated tensors through ``tp``, and on one device every crossing is the
identity.  This module holds that identity, :data:`UNSHARDED`, the default
of every ``tp`` argument; the sharded view, whose crossings are counted
collectives, is :class:`repro_torch.distributed.tensor_parallel.ModelShard`.

The interface, with the sharded meaning of each call:

  ``tp[name]``, ``tp.layer(group, key, depth)`` — the view of a subtree
        of the parameters (and, for a layer, of its decode state);
  ``tp.sharded(name)`` — leaf ``name`` of this subtree is split over
        ``model``;
  ``tp.col(x, name)`` — ``x`` entering a product with the column-split
        leaf ``name`` (backward: the partial gradients summed);
  ``tp.row(y, name)`` — the partial sums of a product with the row-split
        leaf ``name``, completed (one all-reduce);
  ``tp.pick(x, name, dim)`` — this rank's slice of a replicated ``x``
        along ``dim``, the slice leaf ``name``'s split selects;
  ``tp.gather(x, dim, name)`` — local slices of a split leaf's output,
        gathered whole;
  ``tp.col_out(y, name)``, ``tp.row_in(y, w, name)`` — decode's
        replicated forms of a column- and a row-parallel product;
  ``tp.to_state(tree)``, ``tp.from_state(x, name)``,
        ``tp.state_dim(name)`` — a layer's decode state laid out by the
        state rules;
  ``tp.lookup(table, tokens)`` — embedding rows (vocab-parallel when the
        table is split);
  ``tp.batch_shards``, ``tp.batch_sum(x)``, ``tp.batch_mean(x, dim)`` —
        the data shards of the batch and sums over them.

Calls that only a split leaf makes (``tp.take``, ``tp.local_slice``,
``tp.rank``, the raw collectives) are the sharded view's alone.
"""
from __future__ import annotations

from typing import Optional

import torch


class Unsharded:
    """The model on one device: no leaf is split, the batch is whole, and
    every crossing is the identity."""

    batch_shards = 1
    vocab_sharded = False

    def __getitem__(self, name: str) -> "Unsharded":
        return self

    def layer(self, group: str, key: str, depth: int) -> "Unsharded":
        return self

    def sharded(self, name: str) -> bool:
        return False

    def col(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x

    def row(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x

    def pick(self, x: torch.Tensor, name: str, dim: int = -1
             ) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor, dim: int, name: str) -> torch.Tensor:
        return x

    def col_out(self, y: torch.Tensor, name: str) -> torch.Tensor:
        return y

    def row_in(self, y: torch.Tensor, w: torch.Tensor,
               name: str) -> torch.Tensor:
        return y @ w.to(y.dtype)

    def to_state(self, tree):
        return tree

    def from_state(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x

    def state_dim(self, name: str) -> Optional[int]:
        return None

    def lookup(self, table: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
        return table[tokens]

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def batch_mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x.mean(dim=dim)


UNSHARDED = Unsharded()
