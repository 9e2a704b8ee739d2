"""Plain reference of LLCG (the paper's Algorithm 2) on a SAGE/BatchNorm
stack: the random partition and its local graphs, the round's neighbor
tables and batches (``draw.round_draw``), K Adam steps on every machine
from a fresh optimizer, the parameter mean, S server Adam steps on the
full graph with full-neighbor mean aggregation, and the full-graph
evaluation.

Parameters are a flat dict ``"<op><i>/<leaf>" -> tensor``; a stack of B
graphs carries a leading B axis on every leaf.  Ops: ``S`` = SAGE
(``relu(h W_self + mean_nbr(h) W_nbr + b)``, no activation on the last
op), ``B`` = BatchNorm over the nodes of each graph with batch statistics
and the population variance.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llcg_bench.reference.common import Adam, Precision
from llcg_bench.reference.draw import round_draw

#: Edges aggregated per block of the full-graph mean: bounds the gathered
#: (edges, d) buffer.
EDGE_BLOCK_BYTES = 1 << 31


def op_dims(arch: str, d_in: int, hidden: int, classes: int
            ) -> List[Tuple[str, int, int]]:
    """``(op, d_in, d_out)`` per op; BatchNorm keeps the width, the last
    width-changing op outputs the classes."""
    changing = [i for i, op in enumerate(arch) if op != "B"]
    out, d = [], d_in
    for i, op in enumerate(arch):
        if op == "B":
            out.append((op, d, d))
        else:
            d_out = classes if i == changing[-1] else hidden
            out.append((op, d, d_out))
            d = d_out
    return out


class _FullMean(torch.autograd.Function):
    """``out[i] = mean_{j in N(i)} h[j]`` over a CSR graph, in blocks of
    rows; the backward scatters ``g[i] / deg(i)`` back to every neighbor."""

    @staticmethod
    def forward(ctx, h, indptr, indices, rows, inv_deg, blocks):
        ctx.save_for_backward(indices, rows, inv_deg)
        ctx.blocks = blocks
        out = torch.zeros_like(h)
        for e0, e1 in blocks:
            out.index_add_(0, rows[e0:e1], h.index_select(0, indices[e0:e1]))
        return out * inv_deg[:, None]

    @staticmethod
    def backward(ctx, g):
        indices, rows, inv_deg = ctx.saved_tensors
        gs = g * inv_deg[:, None]
        gh = torch.zeros_like(g)
        for e0, e1 in ctx.blocks:
            gh.index_add_(0, indices[e0:e1], gs.index_select(0, rows[e0:e1]))
        return gh, None, None, None, None, None


class FullGraph:
    """A whole graph's CSR on the device, for full-neighbor means."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, device):
        n = indptr.size - 1
        deg = np.diff(indptr)
        self.indptr = torch.from_numpy(indptr.astype(np.int64)).to(device)
        self.indices = torch.from_numpy(indices.astype(np.int64)).to(device)
        self.rows = torch.repeat_interleave(
            torch.arange(n, device=device),
            torch.from_numpy(deg.astype(np.int64)).to(device))
        self.inv_deg = torch.from_numpy(
            (1.0 / np.maximum(deg, 1)).astype(np.float32)).to(device)
        self.n = n

    def mean(self, h: torch.Tensor) -> torch.Tensor:
        per = max(EDGE_BLOCK_BYTES // (4 * h.shape[-1]), 1)
        e = int(self.indices.numel())
        blocks = [(a, min(a + per, e)) for a in range(0, e, per)]
        return _FullMean.apply(h, self.indptr, self.indices, self.rows,
                               self.inv_deg, blocks)


def forward(params: Dict[str, torch.Tensor], arch: str, h: torch.Tensor,
            agg, prec: Precision) -> torch.Tensor:
    """Logits ``(B, N, C)`` of a stack of B graphs; ``agg(h)`` is the mean
    over each node's neighbors."""
    last = max(i for i, op in enumerate(arch) if op != "B")
    for i, op in enumerate(arch):
        name = f"{op.lower()}{i}"
        if op == "S":
            w_s, w_n = params[f"{name}/w_self"], params[f"{name}/w_nbr"]
            out = prec.mm(h, w_s) + prec.mm(agg(h), w_n) \
                + params[f"{name}/b"][:, None, :]
            h = out if i == last else F.relu(out)
        elif op == "B":
            mean = h.mean(dim=1, keepdim=True)
            var = h.var(dim=1, keepdim=True, correction=0)
            h = (h - mean) / torch.sqrt(var + 1e-5) \
                * params[f"{name}/gamma"][:, None, :] \
                + params[f"{name}/beta"][:, None, :]
        else:
            raise ValueError(f"op {op!r} has no reference")
    return h


def batch_nll(logits: torch.Tensor, labels: torch.Tensor,
              batch: torch.Tensor) -> torch.Tensor:
    """``(B,)`` mean cross-entropy of each graph's batch rows."""
    b = logits.shape[0]
    rows = torch.arange(b, device=logits.device)[:, None]
    picked = logits[rows, batch]
    logp = torch.log_softmax(picked, dim=-1)
    return -logp.gather(-1, labels[rows, batch][..., None])[..., 0].mean(-1)


def padded_mean(table: torch.Tensor, mask: torch.Tensor, prec: Precision):
    """Mean over sampled neighbor slots ``table (B, N, F)``."""
    def agg(h):
        b, n, d = h.shape
        offs = torch.arange(b, device=h.device)[:, None, None] * n
        g = h.reshape(b * n, d).index_select(
            0, (table.long() + offs).reshape(-1)).reshape(*table.shape, d)
        s = prec.ein("bnfd,bnf->bnd", g, mask)
        return s / mask.sum(-1, keepdim=True).clamp_min(1.0)
    return agg


class Partitioned:
    """The random balanced partition (a permutation dealt round robin) and
    the machines' local graphs, cut edges dropped, nodes renumbered in
    ascending order."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 train_nodes: np.ndarray, parts: int, seed: int):
        n = indptr.size - 1
        perm = np.random.default_rng(seed).permutation(n)
        assign = np.empty(n, np.int64)
        assign[perm] = np.arange(n) % parts
        src = np.repeat(np.arange(n), np.diff(indptr))
        dst = indices.astype(np.int64)
        self.nodes, self.graphs, self.pools = [], [], []
        inside = assign[src] == assign[dst]
        for p in range(parts):
            nodes = np.flatnonzero(assign == p)
            o2n = np.full(n, -1, np.int64)
            o2n[nodes] = np.arange(nodes.size)
            sel = inside & (assign[src] == p)
            ls, ld = o2n[src[sel]], o2n[dst[sel]]
            ip = np.zeros(nodes.size + 1, np.int64)
            np.cumsum(np.bincount(ls, minlength=nodes.size), out=ip[1:])
            self.nodes.append(nodes)
            self.graphs.append((ip, ld.astype(np.int32)))
            self.pools.append(o2n[np.intersect1d(train_nodes, nodes)])
        self.n_max = max(x.size for x in self.nodes)
        self.dmax = max(max(int(np.diff(g[0]).max(initial=0))
                            for g in self.graphs), 1)


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The float64 norm of every leaf."""
    return {k: float(torch.linalg.vector_norm(v.detach(),
                                              dtype=torch.float64))
            for k, v in tree.items()}


class FullData:
    """The whole graph on the device: its CSR, features, labels and
    validation nodes; the full-neighbor server loss and the evaluation."""

    def __init__(self, data, device):
        self.graph = FullGraph(data.indptr, data.indices, device)
        self.x = torch.from_numpy(data.features).to(device)[None]
        self.y = torch.from_numpy(data.labels.astype(np.int64)).to(
            device)[None]
        self.val = torch.from_numpy(data.val_nodes.astype(np.int64)).to(
            device)

    def logits(self, leaves, arch: str, prec: Precision) -> torch.Tensor:
        return forward(leaves, arch, self.x,
                       lambda h: self.graph.mean(h[0])[None], prec)

    def server_grads(self, p, arch: str, batch: torch.Tensor,
                     prec: Precision):
        """The correction loss on ``batch`` at ``p`` and its gradient."""
        leaves = {n: x[None].detach().requires_grad_(True)
                  for n, x in p.items()}
        lv = batch_nll(self.logits(leaves, arch, prec), self.y, batch[None])
        grads = torch.autograd.grad(lv.sum(), list(leaves.values()))
        return lv[0].detach(), {n: g[0] for n, g in zip(leaves, grads)}

    def validation(self, p, arch: str, prec: Precision):
        """The validation loss and accuracy at ``p``."""
        with torch.no_grad():
            lv = self.logits({k: v[None] for k, v in p.items()}, arch,
                             prec)[0][self.val]
            y = self.y[0][self.val]
            return (float(F.cross_entropy(lv, y)),
                    float((lv.argmax(-1) == y).float().mean()))


def judge_at(full: FullData, arch: str, batch: torch.Tensor,
             avg1: Dict[str, torch.Tensor],
             params1: Dict[str, torch.Tensor]) -> Dict:
    """In float32, at another run's round-1 parameters: the norms of the
    server's first gradient at its mean ``avg1`` on ``batch``
    (``corr_grad1_at``) and the validation loss at its parameters after the
    correction ``params1`` (``val_loss_at``)."""
    f32 = Precision(False)
    _, grads = full.server_grads(avg1, arch, batch, f32)
    return {"corr_grad1_at": norms(grads),
            "val_loss_at": full.validation(params1, arch, f32)[0]}


def llcg_reference(data, params0: Dict[str, torch.Tensor], arch: str,
                   plan: Dict, rounds: int, seed: int, device,
                   control: bool = False) -> Dict:
    """Rounds ``1..rounds`` of LLCG from ``params0``; returns per round the
    local, correction and validation losses and the validation accuracy;
    round 1's draw (with the server's batches), the norms of the machines'
    first local gradients and of the server's first gradient, the mean of
    round 1 (``avg1``) and its parameters after the correction
    (``params1``), the server's first moment after round 1; the parameters
    after the last round; the whole graph (``full``) for :func:`judge_at`."""
    prec = Precision(control)
    P, K, S = plan["machines"], plan["local_steps"], plan["correction_steps"]
    B, Bs, fan = plan["batch_size"], plan["server_batch_size"], plan["fanout"]
    part = Partitioned(data.indptr, data.indices, data.train_nodes, P, seed)
    d = data.features.shape[1]
    feats = torch.zeros((P, part.n_max, d), device=device)
    labels = torch.zeros((P, part.n_max), dtype=torch.int64, device=device)
    for p, nodes in enumerate(part.nodes):
        feats[p, :nodes.size] = torch.from_numpy(data.features[nodes]).to(
            device)
        labels[p, :nodes.size] = torch.from_numpy(
            data.labels[nodes].astype(np.int64)).to(device)
    full = FullData(data, device)
    host = np.random.default_rng(seed + 1)
    tn = np.asarray(data.train_nodes)
    params = {k: v.clone() for k, v in params0.items()}
    server = Adam(plan["lr"])
    out = {"local_loss": [], "corr_loss": [], "val_loss": [], "val_score": [],
           "full": full}

    for r in range(1, rounds + 1):
        tables, masks, batches = round_draw(
            part.graphs, part.pools, part.n_max, part.dmax, fan, B, seed, r,
            K, device)
        if r == 1:
            out["drawn"] = {"tables": tables, "masks": masks,
                            "batches": batches}
        # local phase: every machine from the global parameters, a fresh Adam
        stack = {k: v[None].repeat(P, *([1] * v.dim())).contiguous()
                 for k, v in params.items()}
        local = Adam(plan["lr"])
        losses = []
        for k in range(K):
            leaves = {n: x.detach().requires_grad_(True)
                      for n, x in stack.items()}
            agg = padded_mean(tables[:, k], masks[:, k], prec)
            lv = batch_nll(forward(leaves, arch, feats, agg, prec), labels,
                           batches[:, k])
            grads = torch.autograd.grad(lv.sum(), list(leaves.values()))
            if r == 1 and k == 0:
                out["grad1"] = norms(dict(zip(leaves, grads)))
            local.update(stack, dict(zip(leaves, grads)))
            losses.append(lv.detach())
        out["local_loss"].append(float(torch.stack(losses).mean()))
        params = {k: v.mean(0) for k, v in stack.items()}
        # server correction on the full graph
        keys = host.random((S, tn.size))
        cb = tn[np.argpartition(keys, Bs - 1, axis=1)[:, :Bs]] \
            if Bs < tn.size else tn[np.argsort(keys, axis=1)]
        cb = torch.from_numpy(cb.astype(np.int64)).to(device)
        if r == 1:
            out["drawn"]["corr_batches"] = cb
            out["avg1"] = {k: v.clone() for k, v in params.items()}
        closs = []
        for s in range(S):
            lv, grads = full.server_grads(params, arch, cb[s], prec)
            if r == 1 and s == 0:
                out["corr_grad1"] = norms(grads)
            server.update(params, grads)
            closs.append(float(lv))
        out["corr_loss"].append(float(np.mean(closs)))
        if r == 1:
            out["server_m1"] = {k: v.clone() for k, v in server.m.items()}
            out["params1"] = {k: v.clone() for k, v in params.items()}
        loss, score = full.validation(params, arch, prec)
        out["val_loss"].append(loss)
        out["val_score"].append(score)
    out["params"] = params
    return out
