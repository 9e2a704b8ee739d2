"""rwkv6-1.6b's LLCG training round in plain PyTorch: the block as the
port defines it, the loss, autograd gradients, Adam, the mean and the
server correction.

The block (the port's, which departs from the published Finch block as
the configuration's ``assumed`` lists: a static token-shift lerp, RMSNorm
pre-norms, no ``ln0``, a GroupNorm without bias, the decay exponent
clamped to [-8, 2]), for a stream h (B, T, d) and heads of 64:

    x  = rms_norm(h, ln1);  xx = x shifted one step (zeros first)
    x_m = x + (xx - x) mu_m                       for m in r, k, v, g, w
    r, k, v = x_r W_r, x_k W_k, x_v W_v;  g = silu(x_g W_g)
    log w = -exp(clamp(base + tanh(x_w A) B, -8, 2))
    y  = the strict scan of (r, k, v, log w, u) per head
    h += (group_norm(y) (*) g) W_o
    x  = rms_norm(h, ln2);  xx = x shifted
    h += sigmoid(x_r' W_cr) (*) (relu(x_k' W_ck)^2 W_cv)

with the strict recurrence (state S in R^{64 x 64} per head, S_{-1} = 0)

    S_t = diag(exp(log w_t)) S_{t-1} + k_t v_t^T
    y_t = S_{t-1}^T r_t + (r_t . (u (*) k_t)) v_t

The scan here is its own chunked form, written from that recurrence: in
chunks of ``CHUNK`` steps with c = the cumulative sum of log w inside the
chunk, every decay is exp of a difference c_{t-1} - c_s <= 0 (the segsum
form), so nothing overflows whatever the decay; each chunk's start state
is the same form one level up, over the chunks before it.
:func:`scan_steps` is the step-by-step recurrence it is held to.

The embedding's rows are rounded to ``embed_dtype`` (the configuration's
``dtype``, as the port rounds them) and scaled by sqrt(d); the rest
computes in the parameters' dtype: float64 for the first step the check
holds the program's first loss and gradient to, a block at a time from
the program's own inputs (:func:`first_step_by_block`; the whole step,
:func:`first_step`, for small models), float32 for the rounds
(:func:`llcg_rounds`), whose Adam states float64 would not fit beside.  The loss is the mean next-token cross entropy.
Each block is recomputed in the backward (``torch.utils.checkpoint``), so
a 4,096-token gradient fits beside the optimizer states.

Parameters are flat dicts ``{"embed", "final_norm", "lm_head",
"units/<i>/<leaf>"}``, the layers stacked (units, count, ...) on each
``units/<i>`` leaf, as the program lays them out.  Nothing here imports the
program (``repro_torch``), JAX or the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from llcg_bench.reference.common import Adam

HEAD = 64
CHUNK = 16


# --------------------------------------------------------------------------
# the scan
# --------------------------------------------------------------------------
def scan_steps(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The strict recurrence one step at a time.  q, k, log_w: (N, T, dk);
    v: (N, T, dv); u: (N, dk).  Returns y (N, T, dv)."""
    n, t, dk = q.shape
    s = q.new_zeros(n, dk, v.shape[-1])
    ys = []
    for i in range(t):
        bonus = (q[:, i] * u * k[:, i]).sum(-1, keepdim=True)
        ys.append(torch.einsum("nj,njc->nc", q[:, i], s) + bonus * v[:, i])
        s = log_w[:, i, :, None].exp() * s + k[:, i, :, None] * v[:, i, None, :]
    return torch.stack(ys, dim=1)


def scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor,
         chunk: int = CHUNK) -> torch.Tensor:
    """:func:`scan_steps` in chunks (module docstring).  A T that is not a
    multiple of ``chunk`` is padded with steps of no input and decay 1."""
    n, t, dk = q.shape
    dv = v.shape[-1]
    pad = -t % chunk
    if pad:
        q, k, v, log_w = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v, log_w))
    m = (t + pad) // chunk
    q, k, v, lw = (x.reshape(n, m, chunk, x.shape[-1])
                   for x in (q, k, v, log_w))
    c = torch.cumsum(lw, dim=2)                          # (n, m, L, dk)
    c_prev = c - lw                                      # c_{t-1}
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril(-1)        # s < t
    diff = c_prev[:, :, :, None, :] - c[:, :, None, :, :]   # (n,m,t,s,dk)
    diff = torch.where(causal[None, None, :, :, None], diff,
                       torch.full_like(diff, -math.inf))
    att = (q[:, :, :, None, :] * k[:, :, None, :, :] * diff.exp()).sum(-1)
    y = torch.einsum("nmts,nmsc->nmtc", att, v)
    c_last = c[:, :, -1:, :]                             # (n, m, 1, dk)
    contrib = torch.einsum("nmsj,nmsc->nmjc", k * (c_last - c).exp(), v)
    # chunk i starts from sum_{j < i} exp(C_{i-1} - C_j) (*) contrib_j, C
    # the cumulative sum of the chunks' summed log w: the same segsum form
    # across chunks
    big = torch.cumsum(c_last[:, :, 0], dim=1)           # (n, m, dk)
    before = torch.ones(m, m, dtype=torch.bool, device=q.device).tril(-1)
    across = (big - c_last[:, :, 0])[:, :, None, :] - big[:, None, :, :]
    across = torch.where(before[None, :, :, None], across,
                         torch.full_like(across, -math.inf)).exp()
    starts = torch.einsum("nijk,njkc->nikc", across, contrib)
    y = y + torch.einsum("nmtj,nmjc->nmtc", q * c_prev.exp(), starts)
    y = y.reshape(n, m * chunk, dv)[:, :t]
    q, k, v = (x.reshape(n, m * chunk, x.shape[-1])[:, :t] for x in (q, k, v))
    bonus = (q * u[:, None, :] * k).sum(-1, keepdim=True)
    return y + bonus * v


# --------------------------------------------------------------------------
# the block and the loss
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    inv = 1.0 / torch.sqrt(x.square().mean(-1, keepdim=True) + eps)
    return x * inv * (1.0 + scale)


def group_norm(x: torch.Tensor, scale: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    *lead, d = x.shape
    g = x.reshape(*lead, groups, d // groups)
    mean = g.mean(-1, keepdim=True)
    var = (g - mean).square().mean(-1, keepdim=True)
    return ((g - mean) / torch.sqrt(var + eps)).reshape(*lead, d) * scale


def _shift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def block(p: Dict[str, torch.Tensor], h: torch.Tensor,
          eps: float) -> torch.Tensor:
    """One layer (module docstring); ``p`` holds its leaves."""
    b, t, d = h.shape
    nh = d // HEAD
    x = rms_norm(h, p["ln1"], eps)
    xx = _shift(x)
    mix = lambda name: x + (xx - x) * p[name]
    r, k, v = mix("mu_r") @ p["w_r"], mix("mu_k") @ p["w_k"], \
        mix("mu_v") @ p["w_v"]
    g = F.silu(mix("mu_g") @ p["w_g"])
    lora = torch.tanh(mix("mu_w") @ p["w_decay_a"]) @ p["w_decay_b"]
    log_w = -torch.exp(torch.clamp(p["w_decay_base"] + lora, -8.0, 2.0))
    heads = lambda z: z.reshape(b, t, nh, HEAD).transpose(1, 2).reshape(
        b * nh, t, HEAD)
    u = p["u_bonus"].reshape(1, nh, HEAD).expand(b, nh, HEAD).reshape(
        b * nh, HEAD)
    y = scan(heads(r), heads(k), heads(v), heads(log_w), u)
    y = y.reshape(b, nh, t, HEAD).transpose(1, 2).reshape(b, t, d)
    h = h + (group_norm(y, p["gn_scale"], nh, eps) * g) @ p["w_o"]
    x = rms_norm(h, p["ln2"], eps)
    xx = _shift(x)
    xk = x + (xx - x) * p["mu_ck"]
    xr = x + (xx - x) * p["mu_cr"]
    kk = torch.square(F.relu(xk @ p["w_ck"]))
    return h + torch.sigmoid(xr @ p["w_cr"]) * (kk @ p["w_cv"])


def layer_slots(params: Dict[str, torch.Tensor]
                ) -> List[Dict[str, "tuple[str, int, int]"]]:
    """Where every layer's leaves sit, in depth order: per layer, leaf
    name -> (stacked key, unit, index in the entry).  Unit u of every
    pattern entry ``units/<i>`` (i in order), each of the entry's layers
    of that unit; the stacks are (units, count, ...)."""
    entries: Dict[int, Dict[str, str]] = {}
    for key in params:
        if key.startswith("units/"):
            _, i, name = key.split("/")
            entries.setdefault(int(i), {})[name] = key
        elif key not in ("embed", "final_norm", "lm_head"):
            raise ValueError(f"no layer of the reference holds {key!r}")
    out = []
    units = params[next(iter(entries[0].values()))].shape[0]
    for u in range(units):
        for i in sorted(entries):
            count = params[next(iter(entries[i].values()))].shape[1]
            out += [{name: (key, u, c) for name, key in entries[i].items()}
                    for c in range(count)]
    return out


def layers(params: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Every layer's leaves in depth order (views into the stacks,
    :func:`layer_slots`)."""
    return [{name: params[key][u, c] for name, (key, u, c) in slot.items()}
            for slot in layer_slots(params)]


def embed(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
          embed_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The layer stack's input: the rows of ``tokens`` rounded to
    ``embed_dtype`` and scaled by sqrt(d), in the parameters' dtype."""
    dtype = params["embed"].dtype
    return params["embed"][tokens.long()].to(embed_dtype).to(dtype) \
        * math.sqrt(params["embed"].shape[1])


def head_nll(params: Dict[str, torch.Tensor], h: torch.Tensor,
             labels: torch.Tensor, eps: float) -> torch.Tensor:
    """The next-token cross entropy of every token from the last block's
    output ``h`` (B, T, d): the final norm, the head, against ``labels``."""
    logits = rms_norm(h, params["final_norm"], eps) @ params["lm_head"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.long().reshape(-1),
                           reduction="none").reshape(labels.shape)


def token_nll(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
              labels: torch.Tensor, eps: float,
              embed_dtype: torch.dtype = torch.float32,
              remat: bool = True) -> torch.Tensor:
    """The next-token cross entropy of every token of ``tokens`` (B, T)
    against ``labels``, (B, T), in the parameters' dtype."""
    h = embed(params, tokens, embed_dtype)
    for p in layers(params):
        if remat:
            h = torch.utils.checkpoint.checkpoint(block, p, h, eps,
                                                  use_reentrant=False)
        else:
            h = block(p, h, eps)
    return head_nll(params, h, labels, eps)


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, eps: float,
         embed_dtype: torch.dtype = torch.float32,
         remat: bool = True) -> torch.Tensor:
    """The mean of :func:`token_nll`."""
    return token_nll(params, tokens, labels, eps, embed_dtype, remat).mean()


def first_step(params: Dict[str, torch.Tensor], batch: Dict, eps: float,
               device, embed_dtype: torch.dtype = torch.float32,
               dtype: torch.dtype = torch.float64
               ) -> "tuple[torch.Tensor, Dict[str, torch.Tensor]]":
    """Each token's loss of ``batch`` (on the host) and the gradient of
    their mean with respect to every leaf (on ``device``), at ``params``
    (any device and dtype) copied to ``device`` in ``dtype``: the check's
    float64 first step."""
    leaves = {k: v.detach().to(device=device, dtype=dtype)
              .requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        nll = token_nll(leaves, batch["tokens"].to(device),
                        batch["labels"].to(device), eps, embed_dtype)
        grads = torch.autograd.grad(nll.mean(), list(leaves.values()))
    return nll.detach().cpu(), dict(zip(leaves, grads))


def first_step_by_block(params: Dict[str, torch.Tensor], batch: Dict,
                        stream: List[torch.Tensor],
                        cotangents: Dict[int, torch.Tensor], eps: float,
                        device, embed_dtype: torch.dtype = torch.float32,
                        dtype: torch.dtype = torch.float64) -> Iterator:
    """The first step of ``batch`` at ``params`` again one piece at a time
    in ``dtype`` on ``device``, each piece from what another computation of
    the step (the program's) gave it: its input from ``stream`` (the
    input of every block, then the last block's output) and the gradient
    of the mean loss with respect to its output from ``cotangents`` (by
    position in ``stream``).  Yields, in depth order, ``(piece, out,
    grads, d_in)``:

    * ``("embed", stream[0] as it should be, {"embed": gradient}, None)``;
    * ``(i, block i's output, {leaf name: gradient}, gradient of its
      input)`` for every layer i (:func:`layer_slots` says where each
      leaf sits);
    * ``("head", each token's loss, {"final_norm", "lm_head": gradient},
      gradient of the last block's output)``.

    Each piece alone is as well conditioned as one block: a float32 step
    of the whole model can sit tenths off this one (a layer's first token
    divides its time mix's output by sqrt(var + eps) with var ~1e-7, and
    24 such factors compound the rounding), and pieces checked against
    their own inputs do not compound it."""
    wide = lambda x: x.detach().to(device=device, dtype=dtype)
    leaf = lambda x: wide(x).requires_grad_(True)
    tokens, labels = batch["tokens"].to(device), batch["labels"].to(device)
    with torch.enable_grad():
        table = {"embed": leaf(params["embed"])}
        out = embed(table, tokens, embed_dtype)
        (g,) = torch.autograd.grad(out, [table["embed"]],
                                   wide(cotangents[0]))
        yield "embed", out.detach(), {"embed": g}, None
        del table, out, g
        for i, slot in enumerate(layer_slots(params)):
            p = {name: leaf(params[key][u, c])
                 for name, (key, u, c) in slot.items()}
            h = leaf(stream[i])
            out = block(p, h, eps)
            grads = torch.autograd.grad(out, [h, *p.values()],
                                        wide(cotangents[i + 1]))
            yield i, out.detach(), dict(zip(p, grads[1:])), grads[0]
            del p, h, out, grads
        p = {k: leaf(params[k]) for k in ("final_norm", "lm_head")}
        h = leaf(stream[-1])
        nll = head_nll(p, h, labels, eps)
        grads = torch.autograd.grad(nll.mean(), [h, *p.values()])
        yield "head", nll.detach(), dict(zip(p, grads[1:])), grads[0]


def value_and_grad(params: Dict[str, torch.Tensor], batch: Dict, eps: float,
                   embed_dtype: torch.dtype = torch.float32
                   ) -> "tuple[float, Dict[str, torch.Tensor]]":
    """The loss and its gradient with respect to every leaf."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        value = loss(leaves, batch["tokens"], batch["labels"], eps,
                     embed_dtype)
        grads = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), dict(zip(leaves, grads))


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tree.items()}


def grad_norms_at(params: Dict[str, torch.Tensor], batch: Dict, eps: float,
                  device, embed_dtype: torch.dtype = torch.float32
                  ) -> Dict[str, float]:
    """The per-leaf norms of the gradient at ``params`` (any device; copied
    to ``device``) on ``batch``."""
    at = {k: v.detach().to(device) for k, v in params.items()}
    _, grads = value_and_grad(at, {k: x.to(device) for k, x in
                                   batch.items()}, eps, embed_dtype)
    return norms(grads)


# --------------------------------------------------------------------------
# the LLCG rounds
# --------------------------------------------------------------------------
def llcg_rounds(params0: Dict[str, torch.Tensor], rounds: List[Dict],
                eps: float, lr: float, server_lr: float, device,
                embed_dtype: torch.dtype = torch.float32,
                at_mean: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """LLCG rounds from ``params0`` (flat, on any device; copied to
    ``device``): per round G machines take K Adam steps (lr)
    from the same parameters, each on its own batches and with its own Adam
    state, which it keeps from round to round, the parameters are averaged,
    and the server takes S Adam steps (server_lr, one Adam for every round)
    from the mean.  ``rounds[r]`` holds ``local`` (G, K, B, T) and ``corr``
    (S, B', T) batches of ``tokens`` and ``labels``.

    Returns each round's mean local and correction loss, the norms of the
    mean's change in round 1 (``mean1_change``) and of the parameters'
    change over the rounds (``change``), and, given ``at_mean`` (the
    program's mean of round 1), the norms of the server's gradient there on
    round 1's first correction batch (``corr_grad1_at``).  Machines run one
    after another; the first machine's copy becomes the sum."""
    on = lambda x: x.detach().to(device)
    batch = lambda b: {k: x.to(device) for k, x in b.items()}
    server = Adam(server_lr)
    machines: List[Adam] = []
    current = {k: on(v) for k, v in params0.items()}
    out: Dict = {"local_loss": [], "corr_loss": []}
    for r, rb in enumerate(rounds):
        g_count, k_count = rb["local"]["tokens"].shape[:2]
        machines += [Adam(lr) for _ in range(g_count - len(machines))]
        total = None
        losses = []
        for g in range(g_count):
            p = {k: v.clone() for k, v in current.items()}
            for i in range(k_count):
                value, grads = value_and_grad(
                    p, batch({n: x[g, i] for n, x in rb["local"].items()}),
                    eps, embed_dtype)
                machines[g].update(p, grads)
                del grads
                losses.append(value)
            if total is None:
                total = p
            else:
                with torch.no_grad():
                    for k, v in p.items():
                        total[k].add_(v)
            del p
        del current
        with torch.no_grad():
            for v in total.values():
                v.div_(g_count)
        current = total
        out["local_loss"].append(sum(losses) / len(losses))
        if r == 0:
            out["mean1_change"] = _change(current, params0)
            if at_mean is not None:
                out["corr_grad1_at"] = grad_norms_at(
                    at_mean, {n: x[0] for n, x in rb["corr"].items()}, eps,
                    device, embed_dtype)
        corr = []
        for s in range(rb["corr"]["tokens"].shape[0]):
            value, grads = value_and_grad(
                current, batch({n: x[s] for n, x in rb["corr"].items()}),
                eps, embed_dtype)
            server.update(current, grads)
            del grads
            corr.append(value)
        out["corr_loss"].append(sum(corr) / len(corr))
    out["change"] = _change(current, params0)
    return out


def _change(params: Dict[str, torch.Tensor],
            params0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf, the norm of ``params - params0``, ``params0``'s leaves
    brought to ``params``' device one at a time."""
    return {k: float(torch.linalg.vector_norm(
        (v - params0[k].to(device=v.device, dtype=v.dtype)).double()))
        for k, v in params.items()}
