"""Mixture-of-Experts with top-k routing and capacity-bounded dispatch, as
the JAX package's ``models/transformer/moe.py``.

Step by step as the reference: f32 routing (softmax, top-k, the weights
renormalised by their sum clipped at 1e-9); the (T·k) assignments sorted
stably by expert id; each assignment's position within its expert; the
capacity ``C = max(8, roundup8(⌈T·k/E · capacity_factor⌉))``, worked out
on the host from the shapes; assignments past ``C`` dropped; one batched
GLU over the expert axis, ``(E, C, d) × (E, d, f)``; the combine weighted
by ``w · keep``; Qwen2's shared experts, a fused always-on GLU with a
sigmoid gate taken in f32; the Switch load-balance loss
``router_aux_loss · E · Σ_e f_e · p̄_e``, ``f`` counted before dropping.

**Groups.**  ``moe_forward(..., groups=G)`` splits the ``B·S`` tokens into
``G`` groups of ``T_g = B·S / G`` consecutive tokens, each routed with its
own capacity from ``T_g``.  A wave and every prefill route the whole batch
as one group, as the reference does.  A slot pool's decode step (one token
a row, each at its own position) routes each row alone (``G = B``,
``T_g = 1``): the JAX pool step is a ``vmap`` of batch-1 decode steps, so
there each slot's MoE sees one token, and a shared capacity would make the
pool's rows, retired slots decoding junk included, compete for it.

**Determinism.**  The reference dispatches and combines with scatter-adds;
on CUDA ``index_add_`` adds with atomics, in no fixed order.  Here each
kept (expert, slot) has exactly one source token (a dropped assignment
adds exactly 0 in the reference), so the dispatch buffer is a gather of
token rows through an index table written once per kept slot; each
token's k contributions are gathered and summed in a fixed order.  Every
shape is fixed by ``x`` and the config, and nothing syncs the host.

**Split over a mesh** (``tp``, :mod:`.parallel`).  The experts sit on
``model`` when their count divides it (a rank computes its block of
experts' rows of the dispatch buffer) and are otherwise split over
``d_ff`` (a rank computes its columns of every expert); either way one
all-reduce over the expert axis (the dry run's hint, ``model``) completes
the output, the shared experts' row-parallel sum with it.  A batch split
over data shards is routed as the global batch: each token's position in
its expert continues over the shards before its own (an all-gather of the
per-shard counts), the capacity is the global token count's and the
load-balance term takes the global means.  Each shard then computes the
whole buffer at the global capacity, its own tokens' rows filled and the
others' zero: per-device expert work and the buffer do not shrink with
the data shards (handing each shard its share of the rows and gathering
the outputs back is exact, but moves the whole buffer across the shards
every layer: ROADMAP Queue 1b item 15).  The reference's
``with_sharding_constraint`` calls on the buffer have no numerical effect
and have no counterpart here.  The JAX package computes the MoE as einsums
outside any Pallas kernel, so the port keeps it in torch ops.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.config import ModelConfig
from repro_torch.models.transformer.parallel import UNSHARDED


def init_moe_params(cfg: ModelConfig, rng) -> Dict:
    """f32 CPU tensors drawn from ``rng`` (a :class:`TorchRng`) in the JAX
    package's order: router, the experts' gate, up and down, then the
    shared experts (``num_shared_experts > 0``)."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.expert_d_ff, moe.num_experts

    def dense(shape, fan_in):
        return rng.standard_normal(shape) / math.sqrt(fan_in)

    p = {"router": dense((d, e), d), "w_gate": dense((e, d, f), d),
         "w_up": dense((e, d, f), d), "w_down": dense((e, f, d), f)}
    if moe.num_shared_experts > 0:
        fs = moe.num_shared_experts * moe.shared_expert_d_ff
        p["shared"] = {"w_gate": dense((d, fs), d), "w_up": dense((d, fs), d),
                       "w_down": dense((fs, d), fs), "gate": dense((d, 1), d)}
    return p


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a group of ``tokens``: the reference's
    ``max(8, roundup8(ceil(T·k/E · capacity_factor)))`` in Python floats."""
    moe = cfg.moe
    c = int(math.ceil(tokens * moe.top_k / moe.num_experts
                      * moe.capacity_factor))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """Each group's routing: ``probs`` (G, T, E) f32, ``top_w`` / ``top_i``
    (G, T, k) (weights renormalised), ``keep`` (G, T, k) bool (the
    assignment fits its expert's capacity), ``slot`` (G, T, k) (its row
    ``expert · C + position`` of the dispatch buffer, clipped to the last
    row as in the reference), ``counts`` (G, E) (assignments per expert
    before dropping) and the capacity ``C``."""
    probs: torch.Tensor
    top_w: torch.Tensor
    top_i: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    capacity: int


def route(params: Dict, x: torch.Tensor, cfg: ModelConfig,
          groups: int = 1, tp=UNSHARDED) -> Routing:
    """The routing of ``x`` (B, S, d) in ``groups`` groups of consecutive
    tokens; with the batch split over data shards, the global batch's
    (one group; ``counts`` the global ones)."""
    moe = cfg.moe
    k, e = moe.top_k, moe.num_experts
    t = x.shape[0] * x.shape[1] // groups
    xt = x.reshape(groups, t, x.shape[-1])
    logits = (xt @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = probs.topk(k, dim=-1)                 # (G, T, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # stable sort of the (T·k) assignments by expert id; within an expert
    # they keep token order (a token takes each expert at most once)
    flat_e = top_i.reshape(groups, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    counts = torch.zeros((groups, e), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(t * k, device=x.device) - starts.gather(-1, se)
    if tp.batch_shards > 1:
        if groups != 1:
            raise ValueError("a batch split over data shards routes as one "
                             "group")
        before, counts = tp.counts_before(counts)
        pos = pos + before.gather(-1, se)
    cap = capacity(t * tp.batch_shards, cfg)
    slot = (se * cap + pos).clamp(0, e * cap - 1)
    # back to the (T, k) order of the assignments (``order`` is a
    # permutation: each entry written once)
    unsort = torch.empty_like(order)
    unsort.scatter_(1, order, torch.arange(t * k, device=x.device)
                    .expand(groups, -1).contiguous())
    slot_u = slot.gather(-1, unsort).reshape(groups, t, k)
    keep_u = (pos < cap).gather(-1, unsort).reshape(groups, t, k)
    return Routing(probs, top_w, top_i, keep_u, slot_u, counts, cap)


def moe_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                groups: int = 1, tp=UNSHARDED
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux); ``groups`` and ``tp`` as in the module
    docstring.  ``aux`` is the load-balance loss, averaged over the
    groups."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s // groups
    e, k = moe.num_experts, moe.top_k
    dt = x.dtype
    xt = x.reshape(groups, t, d)
    r = route(params, x, cfg, groups, tp)
    cap = r.capacity
    # the rank's experts: a block of them (expert parallel), else all
    e_loc = params["w_gate"].shape[0]
    e0 = tp.rank * e_loc if e_loc < e else 0
    mine = r.keep & (r.top_i >= e0) & (r.top_i < e0 + e_loc)
    sink = e_loc * cap
    slot = torch.where(mine, r.slot - e0 * cap, sink)   # dropped: the sink

    # ---- dispatch: each kept (expert, slot) row takes its one token; the
    # empty ones read the zero row appended at index t; dropped
    # assignments write their index to a sink column that is cut off
    src = torch.full((groups, sink + 1), t, dtype=torch.long, device=x.device)
    tok = torch.arange(t, device=x.device)[None, :, None].expand_as(slot)
    src.scatter_(1, slot.reshape(groups, -1), tok.reshape(groups, -1))
    xin = tp.col(xt, "w_gate")
    x_pad = torch.cat([xin, xin.new_zeros((groups, 1, d))], dim=1)
    buf = x_pad.gather(1, src[:, :sink, None].expand(-1, -1, d))
    buf = buf.reshape(groups, e_loc, cap, d)

    # ---- expert compute: one batched GLU over the expert axis
    g = F.silu(torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(dt)))
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(dt))
    out = torch.einsum("gecf,efd->gecd", g * u, params["w_down"].to(dt))
    out = out.reshape(groups, sink, d)
    out = torch.cat([out, out.new_zeros((groups, 1, d))], dim=1)

    # ---- combine: each token's k contributions gathered and summed in
    # the order of its top-k (a dropped one reads the zero row)
    rows = out.gather(1, slot.reshape(groups, t * k, 1).expand(-1, -1, d))
    w = tp.col(r.top_w * r.keep, "w_gate").to(dt)
    y = (rows.reshape(groups, t, k, d) * w[..., None]).sum(dim=2)
    partial = tp.sharded("w_gate")          # a sum over the expert axis

    # ---- shared experts (always on)
    if "shared" in params:
        sh, tsh = params["shared"], tp["shared"]
        xs = tsh.col(xt, "w_up")
        gsh = F.silu(xs @ sh["w_gate"].to(dt)) * (xs @ sh["w_up"].to(dt))
        gate = tsh.col(torch.sigmoid((xt @ sh["gate"].to(dt)).float()),
                       "w_down")
        ysh = (gsh @ sh["w_down"].to(dt)) * gate.to(dt)
        if tsh.sharded("w_down") != partial:    # complete the partial one
            y, ysh = (tp.expert_sum(y), ysh) if partial else \
                (y, tp.expert_sum(ysh))
            partial = False
        y = y + ysh
    if partial:
        y = tp.expert_sum(y)

    # ---- Switch-style load-balance aux, per group
    frac = r.counts.float() / (t * tp.batch_shards * k)
    aux = moe.router_aux_loss * e * (frac * tp.batch_mean(r.probs, 1)).sum(-1)
    return y.reshape(b, s, d), aux.mean()


def _chosen(r: Routing) -> torch.Tensor:
    """(G, T, E) bool: the experts each token chose."""
    m = torch.zeros(r.probs.shape, dtype=torch.bool, device=r.probs.device)
    return m.scatter_(2, r.top_i, True)


def _kept(r: Routing) -> torch.Tensor:
    """(G, T, E) bool: the experts each token was kept by."""
    m = torch.zeros(r.probs.shape, dtype=torch.bool, device=r.probs.device)
    return m.scatter_(2, r.top_i, r.keep)


def routing_differences(ref: Routing, got: Routing, tie: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where two routings of the same layer's tokens differ (the card's
    against the CPU's, say), and which of those differences ``ref`` does
    not explain.  Returns (differ, unexplained), (G, T) bool each.

    A token differs if it chose other experts or was kept by others.  Its
    choice may differ only at a near tie: ``ref``'s k-th and (k+1)-th
    probabilities within ``tie``.  Its keep may differ at an expert it
    chose on both sides only through a capacity shift: an earlier token of
    its group chose that expert on one side and not on the other, which
    moves every later token's position in it by one."""
    k = ref.top_i.shape[-1]
    chose_r, chose_g = _chosen(ref), _chosen(got)
    flip = chose_r != chose_g                          # (G, T, E)
    top = ref.probs.topk(k + 1, dim=-1).values
    tied = top[..., k - 1] - top[..., k] <= tie
    shifted = (torch.cumsum(flip.long(), dim=1) - flip.long()) > 0
    kept_diff = (_kept(ref) != _kept(got)) & chose_r & chose_g
    differ = flip.any(-1) | kept_diff.any(-1)
    unexplained = (flip.any(-1) & ~tied) | (kept_diff & ~shifted).any(-1)
    return differ, unexplained
