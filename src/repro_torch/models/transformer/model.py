"""Language model assembly over the config's repeating-unit pattern.

The parameter and state trees keep the JAX package's layout, so carried-over
weights and states compare leaf for leaf:

  params["units"][str(i)] — pattern entry i, stacked (n_units, count, …)
  params["rem"][str(i)]   — remainder entry i, stacked (count, …)
  params["shared"]        — the one ``shared_attn`` set (zamba2), reused at
                            every application; ``units`` has no key for it
  states["units"][str(i)], states["units"][f"s{i}"] (a shared entry's
  caches, stacked (n_units, …)), states["rem"][str(i)], states["emb0_last"]

Where the JAX package ``lax.scan``\\ s over units and layers, the port loops
over the stacked axes in Python; each layer's parameters are views into the
stacks.  ``forward`` takes them with one ``unbind`` per stacked leaf (its
layer axes flattened), so a backward writes each stack's gradient once, a
``stack`` of its layers' gradients: indexing each layer instead would have
autograd zero-fill a gradient of the whole stack for every layer and add
them up.  ``prefill`` and ``decode_step`` take no gradients and index each
layer.  Every block gets ``emb0``, the layer stack's input embeddings (the
prompt's in prefill, the current token's in decode), which the shared block
concatenates to its input.  Weights stay f32 and are cast to the stream's
dtype at use.  As in the JAX package, the embedding scale promotes the
stream to f32, so a bfloat16 config rounds only the embedding rows to
bfloat16 (ROADMAP.md Queue 3, quirk 3).

Entry points:
  init(seed, device)                → params (drawn on the CPU a layer at a
                                      time, each copied into its stack on
                                      ``device``)
  param_specs()                     → the parameter tree's shapes and
                                      dtypes, nothing drawn or allocated
  forward(params, batch, remat)     → (logits, aux)
  prefill(params, batch, max_seq)   → (logits_last, states)
  decode_step(params, states, token, position, max_seq) → (logits, states)
  loss(params, batch, efficient_ce, remat) → the training loss (scalar
                                      f32)

``position`` is an int shared by the batch (a wave), or a (B,) tensor, each
row at its own (a slot pool, whose states carry the per-row layout of
:func:`per_row_positions`).

The batch holds ``tokens``, and per frontend:
  vision — ``patches`` (B, num_prefix_tokens, frontend_dim): a GELU
           projector (``proj1``, ``proj2``) in ``cfg.dtype`` whose rows
           are concatenated before the scaled token embeddings (the
           result f32, as ``jnp.concatenate`` promotes it); ``forward``
           drops the prefix's logits, ``prefill``'s ``last_index`` and
           the decode positions count the prefix.
  audio  — ``frames`` (B, S, frontend_dim) in place of tokens, projected
           by ``proj`` and blended with ``mask_emb`` at
           ``mask_positions`` (B, S); no √d scale, so the stream stays in
           ``cfg.dtype`` (a bfloat16 encoder computes in bfloat16).  An
           ``encoder_only`` config's ``forward`` runs every block
           bidirectionally.
``loss`` adds ``labels`` (B, S) (and, for an encoder-only audio config,
``mask_positions`` as the positions it averages over).  Every op of
``forward`` is differentiable by autograd; the recurrent kinds' scans run
the hand-written gradient kernel on the card
(:func:`repro_torch.kernels.ops.linear_scan`).

Every entry point takes ``tp``, the rank's view of a split over a mesh
(:mod:`.parallel`; the identity by default): given
:class:`repro_torch.distributed.tensor_parallel.ModelShard`, the same code
runs one rank's shards of the parameters, batch and states — the
vocab-sharded embedding looked up on the rank's rows, the logits the
rank's vocab slice, ``loss_terms`` the rank's share of the loss.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.transformer import blocks as B
from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.initutils import TorchRng
from repro_torch.models.transformer.norms import rms_norm
from repro_torch.models.transformer.parallel import UNSHARDED
from repro_torch.utils.pytree import map_with_paths, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# threads drawing a stack's layers in ``LM.init`` (the CPU generator's
# normal draw runs on one core per call)
_INIT_WORKERS = min(8, os.cpu_count() or 1)


def _stack(trees: List[Dict], dim_sizes: Tuple[int, ...]) -> Dict:
    """Per-layer trees (in layer order) → one tree of ``dim_sizes + leaf``
    stacks."""
    return tree_map(lambda *xs: torch.stack(xs).reshape(
        *dim_sizes, *xs[0].shape), *trees)


def per_row_positions(states: Dict, batch: int) -> Dict:
    """``states`` with every attention cache's ``pos`` leaf, (…, L), given
    a batch axis before its slots, (…, batch, L): the layout of states
    whose rows decode at their own positions (``decode_step`` with a (B,)
    ``position``), as a slot pool's, which the JAX package stacks per
    slot.  Other leaves are returned as they are."""
    return map_with_paths(
        lambda k, x: x.unsqueeze(-2).expand(*x.shape[:-1], batch,
                                            x.shape[-1])
        if k.rsplit("/", 1)[-1] == "pos" else x, states)


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def _entries(self) -> List[Tuple[str, str, str, Tuple[int, ...]]]:
        """``(group, key, kind, leading dims)`` of every stacked state
        entry: the pattern's (a ``shared_attn`` entry i under ``f"s{i}"``,
        one application per unit), then the remainder's.  The parameters
        have the same entries but the shared ones (:meth:`_layer_params`)."""
        n_units = self.cfg.resolved_units()
        for kind, cnt in self.cfg.pattern:
            if kind == "shared_attn" and cnt != 1:
                raise ValueError(f"{self.cfg.name}: a shared_attn entry of "
                                 f"count {cnt} is not ported (the port "
                                 "applies the shared block once per unit)")
        units = [("units", f"s{i}", kind, (n_units,))
                 if kind == "shared_attn" else
                 ("units", str(i), kind, (n_units, cnt))
                 for i, (kind, cnt) in enumerate(self.cfg.pattern)]
        rem = [("rem", str(i), kind, (cnt,))
               for i, (kind, cnt) in enumerate(self.cfg.remainder)]
        return units + rem

    def _layers(self):
        """``(group, key, kind, index)`` of every layer in depth order, the
        index into the entry's stacked leading axes."""
        entries = self._entries()
        for u in range(self.cfg.resolved_units()):
            for group, key, kind, dims in entries:
                if group == "units":
                    for rest in itertools.product(*map(range, dims[1:])):
                        yield group, key, kind, (u, *rest)
        for group, key, kind, dims in entries:
            if group == "rem":
                for c in range(dims[0]):
                    yield group, key, kind, (c,)

    def _layer_params(self, params: Dict, group: str, key: str,
                      idx: Tuple[int, ...]) -> Dict:
        """A layer's parameters: views into its entry's stacks, or the one
        shared set."""
        if key.startswith("s"):
            return params["shared"]
        return self._index(params[group][key], idx)

    def _unbound_layers(self, params: Dict):
        """``(group, key, kind, index, parameters)`` of every layer in
        :meth:`_layers` order, each stacked leaf's layers taken by one
        ``unbind`` of its flattened layer axes, whose backward is one
        ``stack``.  Expert axes inside a layer stay inside its piece."""
        pieces = {(group, key): tree_map(
            lambda x, n=len(dims): x.flatten(0, n - 1).unbind(0),
            params[group][key])
            for group, key, _, dims in self._entries()
            if not key.startswith("s")}
        dims = {(group, key): d for group, key, _, d in self._entries()}
        for group, key, kind, idx in self._layers():
            if key.startswith("s"):
                yield group, key, kind, idx, params["shared"]
                continue
            flat = 0
            for i, n in zip(idx, dims[group, key]):
                flat = flat * n + i
            yield group, key, kind, idx, tree_map(
                lambda t: t[flat], pieces[group, key])

    # ------------------------------------------------------------------ init
    def init(self, seed: int, device="cuda", block=None) -> Dict:
        """Random f32 weights from ``seed``: drawn on the CPU generator, so
        the same seed gives the same weights on every device.  Each layer
        is drawn on the CPU from its own generator and copied into its
        entry's stack, allocated on ``device`` (the GPU unless the caller
        passes another): the host holds at most ``_INIT_WORKERS`` layers
        at a time, drawn in parallel.  The stream's order is the JAX
        package's: embeddings, the frontend, the pattern's entries, the
        shared set, the remainder's entries.

        ``block(path, x)``, given, keeps a block of every leaf (a rank's,
        under the sharding rules): ``path`` is the leaf's ``/``-joined key
        in the returned tree and ``x`` the whole tensor of one layer; the
        stacks are allocated at the blocks' shapes, so ``device`` holds
        only the blocks."""
        keep = block or (lambda path, x: x)

        def placed(tree, path: str, to=None):
            if isinstance(tree, dict):
                return {k: placed(v, f"{path}/{k}" if path else k, to)
                        for k, v in tree.items()}
            x = keep(path, tree)
            return x if to is None else x.to(to)

        cfg = self.cfg
        rng = TorchRng(seed)
        d = cfg.d_model
        params: Dict[str, Any] = {
            "embed": rng.standard_normal((cfg.vocab_size, d)) / math.sqrt(d),
            "final_norm": torch.zeros(d),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = (rng.standard_normal((d, cfg.vocab_size))
                                 / math.sqrt(d))
        fd = cfg.frontend_dim
        if cfg.frontend == "audio":
            params["frontend"] = {
                "proj": rng.standard_normal((fd, d)) / math.sqrt(fd),
                "mask_emb": rng.standard_normal((d,)) * 0.02}
        elif cfg.frontend == "vision":
            params["frontend"] = {
                "proj1": rng.standard_normal((fd, d)) / math.sqrt(fd),
                "proj2": rng.standard_normal((d, d)) / math.sqrt(d)}
        params = placed(params, "", device)

        def stack_init(kind: str, dims: Tuple[int, ...], path: str) -> Dict:
            base = rng.fork()
            # each layer's generator forked in layer order: the draws
            # themselves are independent and run on _INIT_WORKERS threads
            rngs = [base.fork() for _ in range(math.prod(dims))]
            first = placed(B.init_block_params(kind, cfg, rngs[0]), path)
            stacks = tree_map(lambda x: torch.empty(
                (len(rngs), *x.shape), dtype=x.dtype, device=device), first)

            def fill(n, layer=None):
                layer = layer or placed(
                    B.init_block_params(kind, cfg, rngs[n]), path)
                tree_map(lambda s, x: s[n].copy_(x), stacks, layer)
            fill(0, first)
            del first
            with ThreadPoolExecutor(_INIT_WORKERS) as pool:
                list(pool.map(fill, range(1, len(rngs))))
            return tree_map(lambda s: s.reshape(*dims, *s.shape[1:]),
                            stacks)

        entries = self._entries()
        params["units"] = {key: stack_init(kind, dims, f"units/{key}")
                           for group, key, kind, dims in entries
                           if group == "units" and kind != "shared_attn"}
        if any(kind == "shared_attn" for _, _, kind, _ in entries):
            params["shared"] = placed(
                B.init_block_params("shared_attn", cfg, rng.fork()),
                "shared", device)
        params["rem"] = {key: stack_init(kind, dims, f"rem/{key}")
                         for group, key, kind, dims in entries
                         if group == "rem"}
        return params

    def param_specs(self) -> Dict:
        """The tree :meth:`init` returns, as
        :class:`~repro_torch.configs.shapes.TensorSpec` records (the JAX
        package's ``jax.eval_shape(model.init, …)``): one layer of each
        kind is drawn under a fake-tensor mode, which allocates nothing."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.configs.shapes import TensorSpec
        cfg = self.cfg
        d = cfg.d_model
        spec = lambda x, lead=(): TensorSpec((*lead, *x.shape), x.dtype)
        f32 = lambda *shape: TensorSpec(shape, torch.float32)
        params: Dict[str, Any] = {"embed": f32(cfg.vocab_size, d),
                                  "final_norm": f32(d)}
        if not cfg.tie_embeddings:
            params["lm_head"] = f32(d, cfg.vocab_size)
        fd = cfg.frontend_dim
        if cfg.frontend == "audio":
            params["frontend"] = {"proj": f32(fd, d), "mask_emb": f32(d)}
        elif cfg.frontend == "vision":
            params["frontend"] = {"proj1": f32(fd, d), "proj2": f32(d, d)}
        with FakeTensorMode():
            layer = {kind: B.init_block_params(kind, cfg, TorchRng(0))
                     for _, _, kind, _ in self._entries()}
        entries = self._entries()
        params["units"] = {key: tree_map(lambda x, n=dims: spec(x, n),
                                         layer[kind])
                           for group, key, kind, dims in entries
                           if group == "units" and kind != "shared_attn"}
        if "shared_attn" in layer:
            params["shared"] = tree_map(spec, layer["shared_attn"])
        params["rem"] = {key: tree_map(lambda x, n=dims: spec(x, n),
                                       layer[kind])
                         for group, key, kind, dims in entries
                         if group == "rem"}
        return params

    # -------------------------------------------------------------- helpers
    def _embed_tokens(self, params: Dict, tokens: torch.Tensor,
                      tp=UNSHARDED) -> torch.Tensor:
        # as the JAX package: rows rounded to cfg.dtype, then scaled by a
        # numpy float64, which promotes the stream to float32 — every layer
        # after this computes in f32 whatever cfg.dtype says
        return tp.lookup(params["embed"], tokens).to(self.dtype).float() * \
            math.sqrt(self.cfg.d_model)

    def _embed(self, params: Dict, batch: Dict, tp=UNSHARDED) -> torch.Tensor:
        """The layer stack's input: the frontend's rows (module
        docstring), else the scaled token embeddings."""
        dt = self.dtype
        fr = params.get("frontend")
        if self.cfg.frontend == "audio":
            h = batch["frames"].to(dt) @ fr["proj"].to(dt)
            if "mask_positions" in batch:
                m = batch["mask_positions"][..., None].to(dt)
                h = h * (1 - m) + fr["mask_emb"].to(dt) * m
            return h
        toks = self._embed_tokens(params, batch["tokens"], tp)
        if self.cfg.frontend == "vision":
            p = F.gelu(batch["patches"].to(dt) @ fr["proj1"].to(dt),
                       approximate="tanh") @ fr["proj2"].to(dt)
            return torch.cat([p.to(toks.dtype), toks], dim=1)
        return toks

    def _head(self, params: Dict, h: torch.Tensor,
              tp=UNSHARDED) -> torch.Tensor:
        h = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        head = params["embed"].T if name == "embed" else params["lm_head"]
        return tp.col(h, name) @ head.to(h.dtype)

    def _stacked_states(self, per_layer: List[Dict]) -> Dict:
        """Per-layer states in :meth:`_layers` order → the stacked tree."""
        lists: Dict[Tuple[str, str], List[Dict]] = {}
        for (group, key, _, _), st in zip(self._layers(), per_layer):
            lists.setdefault((group, key), []).append(st)
        states: Dict[str, Any] = {"units": {}, "rem": {}}
        for group, key, _, dims in self._entries():
            states[group][key] = _stack(lists[(group, key)], dims)
        return states

    @staticmethod
    def _index(tree: Dict, idx: Tuple[int, ...]) -> Dict:
        return tree_map(lambda x: x[idx], tree)

    # ---------------------------------------------------------------- forward
    def forward(self, params: Dict, batch: Dict, tp=UNSHARDED,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``remat`` recomputes each block's forward in the backward
        (``torch.utils.checkpoint``, non-reentrant): the backward then
        holds every block's input and one block's activations at a time.
        The embedding and the head are not recomputed."""
        cfg = self.cfg
        h = self._embed(params, batch, tp)
        emb0 = h
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for group, key, kind, idx, layer in self._unbound_layers(params):
            args = (kind, layer, h, cfg)
            kw = dict(emb0=emb0, causal=not cfg.encoder_only,
                      tp=tp.layer(group, key, len(idx)))
            if remat:
                h, a = torch.utils.checkpoint.checkpoint(
                    B.block_forward, *args, use_reentrant=False, **kw)
            else:
                h, a = B.block_forward(*args, **kw)
            aux = aux + a
        if cfg.frontend == "vision":
            h = h[:, cfg.num_prefix_tokens:]
        return self._head(params, h, tp), aux

    # ------------------------------------------------------------------ loss
    def loss(self, params: Dict, batch: Dict,
             efficient_ce: bool = True, tp=UNSHARDED,
             remat: bool = False) -> torch.Tensor:
        """Next-token / masked-prediction cross entropy, plus the MoE
        load-balance term ``aux``.

        ``efficient_ce=True`` (default) computes it as the JAX package
        does, without a gather over the vocab axis: logsumexp minus a
        one-hot contraction; ``False`` takes ``log_softmax`` and gathers
        the label's entry.  Logits are taken in f32.  ``remat``
        recomputes block by block (:meth:`forward`).
        """
        nll, aux = self.loss_terms(params, batch, efficient_ce, tp, remat)
        return nll + aux

    def loss_terms(self, params: Dict, batch: Dict, efficient_ce: bool = True,
                   tp=UNSHARDED, remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(nll, aux)``, the loss their sum.  Split over a mesh, ``nll``
        is the rank's share (the global one is its sum over the data
        shards, whose gradients then sum to the global gradient) and
        ``aux`` the global term; vocab-sharded logits take the cross
        entropy on the rank's slice (``tp.vocab_nll``)."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch, tp, remat)
        labels = batch["labels"].long()
        logits32 = logits.float()
        if tp.vocab_sharded:
            nll = tp.vocab_nll(logits32, labels)
        elif efficient_ce:
            lse = torch.logsumexp(logits32, dim=-1)
            onehot = labels[..., None] == torch.arange(
                cfg.vocab_size, device=labels.device)[None, None, :]
            target_logit = torch.where(onehot, logits32,
                                       torch.zeros((), device=labels.device)
                                       ).sum(dim=-1)
            nll = lse - target_logit
        else:
            logp = F.log_softmax(logits32, dim=-1)
            nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        if cfg.encoder_only and "mask_positions" in batch:
            m = batch["mask_positions"].float()
            return (nll * m).sum() / tp.batch_sum(m.sum()).clamp_min(1.0), aux
        return nll.mean() / tp.batch_shards, aux

    # --------------------------------------------------------------- prefill
    def prefill(self, params: Dict, batch: Dict, max_seq: int,
                last_index: Optional[int] = None, tp=UNSHARDED
                ) -> Tuple[torch.Tensor, Dict]:
        """``last_index`` selects which row's logits (and ``emb0_last``) to
        return instead of the final row, counting a vision prefix's rows.
        ``max_seq`` sizes the attention caches (the recurrent kinds have
        none)."""
        h = self._embed(params, batch, tp)
        emb0 = h
        per_layer = []
        for group, key, kind, idx in self._layers():
            h, st, _ = B.block_prefill(
                kind, self._layer_params(params, group, key, idx), h,
                self.cfg, max_seq, emb0=emb0,
                tp=tp.layer(group, key, len(idx)))
            per_layer.append(st)
        states = self._stacked_states(per_layer)
        row = -1 if last_index is None else int(last_index)
        states["emb0_last"] = emb0[:, row][:, None]
        return self._head(params, h[:, row], tp), states

    def init_states(self, params: Dict, batch: int, max_seq: int) -> Dict:
        """Zero decode states (no prefill)."""
        device = params["embed"].device
        per_layer = [B.init_block_state(kind, self.cfg, batch, max_seq,
                                        self.dtype, device)
                     for _, _, kind, _ in self._layers()]
        states = self._stacked_states(per_layer)
        states["emb0_last"] = torch.zeros((batch, 1, self.cfg.d_model),
                                          dtype=self.dtype, device=device)
        return states

    # ------------------------------------------------------------ decode step
    def decode_step(self, params: Dict, states: Dict, token: torch.Tensor,
                    position: Union[int, torch.Tensor], max_seq: int,
                    tp=UNSHARDED) -> Tuple[torch.Tensor, Dict]:
        """token: (B,) int; ``position``: the token's index in the
        sequence, an int for every row or a (B,) int tensor, a row each
        (the recurrent kinds read neither)."""
        h = self._embed_tokens(params, token, tp)[:, None]
        emb0 = h
        per_layer = []
        for group, key, kind, idx in self._layers():
            h, st = B.block_decode(
                kind, self._layer_params(params, group, key, idx), h,
                self.cfg, self._index(states[group][key], idx), position,
                max_seq, emb0=emb0, tp=tp.layer(group, key, len(idx)))
            per_layer.append(st)
        new_states = self._stacked_states(per_layer)
        new_states["emb0_last"] = emb0
        return self._head(params, h[:, 0], tp), new_states
