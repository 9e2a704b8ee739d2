"""LLCG training rounds of an LM (rwkv6-1.6b) through the port's round step.

Set-up builds what ``launch/train.py``'s ``train()`` builds, from the seed:
the trainer's corpus (``data.tokens.synthetic_corpus``), the weights
(``LM.init`` on the card), the machines' and the server's Adam states and
the round step (``distributed.steps.build_llcg_round_step`` with the
traffic's G, K, S and per-block recomputation).  Each round's batches are
the trainer's ``_local_batches`` / ``_corr_batches`` from its generator.
The scan kernels' sources compile while the host draws the corpus and the
weights.  The ``check_rounds`` rounds the check reads run first (they warm
every kernel); then rounds run back to back for ``--seconds`` (a closed
loop; every round that starts in the window counts whole).

The model's forward is wrapped, unchanged, to keep each token's loss of
the first forward the round step runs (machine 0's first batch at the
initial weights), and in round 1 its blocks are, to keep each block's
input and the gradient the backward gives it in that step.  The local and
the server optimizer are wrapped, unchanged, to keep the first gradient
each is given (the round step updates one leaf at a time, in
``tree_leaves`` order): machine 0's whole, on the host; the server's as
per-leaf norms, with a host copy of the parameters it was taken at (the
program's mean of round 1).

After the window the program's state is freed and the reference
(``reference/lm_rwkv6.py``) takes machine 0's first step again in float64
a block at a time, each block from the program's own input and output
gradient, and trains ``reference_rounds`` rounds again in float32 from the
same weights and batches; :func:`compare` gives the numbers the check
reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from llcg_bench import harness
from llcg_bench.bounds_lm import lm_train_flops, scan_bwd_work, scan_work
from llcg_bench.drivers import common
from llcg_bench.reference import lm_rwkv6 as ref_lm

#: The scan's head width and chunk in the port's rwkv6 block.
HEAD, SCAN_CHUNK = 64, 8
#: The scan's gradients, in the order of its inputs (q, k, v, log_w, u).
SCAN_GRADS = ("dq", "dk", "dv", "dlog_w", "du")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(config: Dict):
    """The port's ``ModelConfig`` of the configuration file: the
    architecture's config with the file's widths, depth, vocabulary and
    dtype."""
    from repro_torch.configs import get_config
    m = config["model"]
    cfg = dataclasses.replace(
        get_config(m["arch"]), num_layers=m["num_layers"],
        d_model=m["d_model"], num_heads=m["d_model"] // m["head_size"],
        num_kv_heads=m["d_model"] // m["head_size"], d_ff=m["d_ff"],
        vocab_size=m["vocab_size"], dtype=config["dtype"])
    cfg.validate()
    return cfg


def train_config(cell: harness.Cell, seed: int):
    """The trainer's ``TrainConfig`` of the traffic file and the seed."""
    from repro_torch.launch.train import TrainConfig
    t, m = cell.traffic, cell.config["model"]
    return TrainConfig(arch=m["arch"], smoke=False,
                       correction_steps=t["correction_steps"],
                       batch_per_group=t["batch_per_machine"],
                       seq_len=t["seq_len"], lr=t["lr"],
                       server_lr=t["server_lr"],
                       heterogeneity=t["heterogeneity"], seed=seed,
                       remat=t["remat"])


def _first_forward_kept(lm, into: Dict):
    """``lm`` (the model's class) whose forward, otherwise unchanged, keeps
    in ``into["nll1"]`` each token's cross entropy (on the host) of the
    first forward it runs."""
    class Observed(lm):
        def forward(self, params, batch, *args, **kw):
            logits, aux = super().forward(params, batch, *args, **kw)
            if "nll1" not in into:
                with torch.no_grad():
                    lg = logits.detach().float()
                    labels = batch["labels"].long()
                    into["nll1"] = (torch.logsumexp(lg, dim=-1) - lg.gather(
                        -1, labels[..., None])[..., 0]).cpu()
            return logits, aux
    return Observed


@contextlib.contextmanager
def _first_scan_kept(into: Dict):
    """``ops.linear_scan``, otherwise unchanged, keeping in ``into`` (on the
    host), of its first strict call from a zero state (the rwkv6 block's
    training call), the inputs (q, k, v, log_w, u), ``y``, the gradient
    the backward is given (``dy``) and those it gives (``SCAN_GRADS``)."""
    from repro_torch.kernels import ops
    orig = ops.linear_scan
    host = lambda x: x.detach().to("cpu", copy=True)

    def keep(name):
        def hook(g):
            into.setdefault(name, host(g))
        return hook

    def linear_scan(q, k, v, log_w, h0=None, chunk=64, strict=False,
                    u=None):
        y, h = orig(q, k, v, log_w, h0, chunk=chunk, strict=strict, u=u)
        if "y" not in into and strict and h0 is None and u is not None \
                and y.requires_grad:
            ins = (q, k, v, log_w, u)
            into.update(inputs=[host(x) for x in ins], y=host(y))
            y.register_hook(keep("dy"))
            for name, x in zip(SCAN_GRADS, ins):
                if x.requires_grad:
                    x.register_hook(keep(name))
        return y, h
    ops.linear_scan = linear_scan
    try:
        yield
    finally:
        ops.linear_scan = orig


@contextlib.contextmanager
def _first_blocks_kept(into: Dict, layers: int):
    """``blocks.block_forward``, otherwise unchanged, keeping in ``into``
    (on the host), of its first ``layers`` calls that record a gradient
    (the first forward the round step runs), each block's input
    (``stream``, the last block's output after them) and, as the backward
    passes them, the gradients of the loss with respect to each
    (``cotangents``, by position in ``stream``)."""
    from repro_torch.models.transformer import blocks
    orig = blocks.block_forward
    host = lambda x: x.detach().to("cpu", copy=True)
    stream = into.setdefault("stream", [])
    cotangents = into.setdefault("cotangents", {})

    def keep(i):
        def hook(g):
            cotangents.setdefault(i, host(g))
        return hook

    def block_forward(kind, params, h, cfg, *args, **kw):
        out = orig(kind, params, h, cfg, *args, **kw)
        i = len(stream)
        if i < layers and torch.is_grad_enabled() and h.requires_grad:
            stream.append(host(h))
            if i == 0:
                h.register_hook(keep(0))
            out[0].register_hook(keep(i + 1))
            if i == layers - 1:
                stream.append(host(out[0]))
        return out
    blocks.block_forward = block_forward
    try:
        yield
    finally:
        blocks.block_forward = orig


class Program:
    """The program's objects for one seed, built as ``train()`` builds
    them."""

    def __init__(self, cell: harness.Cell, seed: int, device):
        from repro_torch.data.tokens import synthetic_corpus
        from repro_torch.distributed import steps
        from repro_torch.models.transformer.model import LM
        from repro_torch.optim import adamw
        from repro_torch.utils.pytree import flatten_with_paths, tree_map

        t = cell.traffic
        self.cell, self.device = cell, torch.device(device)
        self.tcfg = tcfg = train_config(cell, seed)
        self.mcfg = mcfg = model_config(cell.config)
        self.phases = {}
        compiling = None
        if self.device.type == "cuda":       # nvcc beside the host's work
            from repro_torch.kernels import build
            compiling = threading.Thread(target=build.build, args=(
                ["linear_scan", "linear_scan_bwd"],), daemon=True)
            compiling.start()
        tick = time.perf_counter()
        self.corpus = synthetic_corpus(
            mcfg.vocab_size, num_shards=t["machines"],
            tokens_per_shard=max(tcfg.seq_len * 64, 20_000),
            heterogeneity=tcfg.heterogeneity, seed=seed)
        self.rng = np.random.default_rng(seed)
        self.phases["corpus"] = time.perf_counter() - tick
        tick = time.perf_counter()
        self.first: Dict = {"local": {}, "server": {}}
        self.model = _first_forward_kept(LM, self.first)(mcfg)
        params = self.model.init(seed, self.device)
        self.names = [k for k, _ in flatten_with_paths(params)]
        self.params0 = {k: v.detach().to("cpu", copy=True) for k, v in
                        flatten_with_paths(params)}
        self.param_bytes = sum(4 * v.numel() for v in self.params0.values())
        local_opt = self._observed(adamw(tcfg.lr), self.first["local"],
                                   tensors=True)
        server_opt = self._observed(adamw(tcfg.server_lr),
                                    self.first["server"], params=True)
        self.server = server_opt.init(params)
        g = t["machines"]
        self.params_G = tree_map(lambda x: x.unsqueeze(0).expand(
            g, *x.shape).clone(), params)
        del params
        self.opt_G = local_opt.init(self.params_G)
        self.step = steps.build_llcg_round_step(
            self.model, local_opt, server_opt,
            steps.LLCGStepConfig(num_groups=g, local_steps=t["local_steps"],
                                 correction_steps=t["correction_steps"],
                                 remat=tcfg.remat))
        if compiling is not None:
            compiling.join()
        self.phases["program"] = time.perf_counter() - tick

    def _observed(self, opt, into: Dict, params: bool = False,
                  tensors: bool = False):
        """``opt``, unchanged, that keeps in ``into`` the norms of the first
        gradient it is given (``grads``, by leaf name) and, with
        ``tensors``, host copies of that gradient (``tensors``), with
        ``params`` of the parameters it was taken at (``params``)."""
        from repro_torch.optim.optimizers import Optimizer
        names = self.names

        def update(grads, state, p):
            seen = into.setdefault("grads", {})
            if len(seen) < len(names):
                name = names[len(seen)]
                g = grads["x"].detach()
                seen[name] = float(torch.linalg.vector_norm(g.double()))
                if tensors:
                    into.setdefault("tensors", {})[name] = g.to(
                        "cpu", copy=True)
                if params:
                    into.setdefault("params", {})[name] = \
                        p["x"].detach().to("cpu", copy=True)
            return opt.update(grads, state, p)
        return Optimizer(opt.init, update)

    def _change(self, leaves) -> Dict[str, float]:
        """Per leaf of ``(name, tensor)`` pairs, the norm of its change
        from the initial weights, one leaf on the device at a time."""
        return {k: float(torch.linalg.vector_norm(
            (v.to(self.device) - self.params0[k].to(self.device)).double()))
            for k, v in leaves}

    def batches(self) -> Dict:
        """The next round's batches on the host, drawn as ``train()``
        draws them."""
        from repro_torch.launch import train
        t = self.cell.traffic
        local = train._local_batches(self.corpus, t["machines"],
                                     t["local_steps"], self.tcfg, self.rng)
        corr = train._corr_batches(self.corpus, self.tcfg, self.rng)
        corr = {k: v[:, :t["corr_batch"]] for k, v in corr.items()}
        return {"local": local, "corr": corr}

    def round(self, b: Dict):
        on = lambda d: {k: v.to(self.device) for k, v in d.items()}
        self.params_G, self.opt_G, self.server, m = self.step(
            self.params_G, self.opt_G, self.server, on(b["local"]),
            on(b["corr"]))
        return float(m["local_loss"]), float(m["corr_loss"])

    def drive(self, seconds: float, trace: bool, timed: bool = True
              ) -> Dict:
        """The checked rounds, then the window; without ``timed`` only the
        rounds the reference compares."""
        from repro_torch.utils.pytree import flatten_with_paths, tree_map
        warm = self.cell.traffic["check_rounds"]
        compared = self.cell.traffic["reference_rounds"]
        if not 1 <= compared <= warm:
            raise ValueError("the reference compares 1 to check_rounds "
                             "rounds")
        window = harness.Window(seconds, trace, self.device)
        tick = time.perf_counter()
        rounds: List[Dict] = []
        local_loss, corr_loss = [], []
        wire1 = None
        r = 0
        while True:
            r += 1
            if r == compared + 1:
                change = self._change(flatten_with_paths(
                    tree_map(lambda x: x[0], self.params_G)))
                if not timed:
                    break
            if r == warm + 1:
                wire0 = self.step.wire_bytes
                window.begin()
            elif r > warm + 1 and window.expired():
                break
            b = self.batches()
            with contextlib.ExitStack() as kept:
                if r == 1:
                    kept.enter_context(_first_scan_kept(
                        self.first.setdefault("scan", {})))
                    kept.enter_context(_first_blocks_kept(
                        self.first.setdefault("blocks", {}),
                        self.mcfg.num_layers))
                losses = self.round(b)
            window.round_done()
            if r <= warm:
                rounds.append(b)
                local_loss.append(losses[0])
                corr_loss.append(losses[1])
                if r == 1:
                    wire1 = self.step.wire_bytes
        server = self.first["server"]
        out = {"batches": rounds, "wire1": wire1,
               "nll1": self.first.get("nll1"),
               "local_loss": local_loss, "corr_loss": corr_loss,
               "grad1": self.first["local"].pop("tensors", {}),
               "scan": self.first.pop("scan", {}),
               "blocks": self.first.pop("blocks", {}),
               "corr_grad1": dict(server.get("grads", {})),
               "avg1": server.get("params", {}),
               "mean1_change": self._change(server.get("params",
                                                       {}).items()),
               "change": change}
        if timed:
            window.close()
            n = window.rounds
            out.update(window=window, check_rounds_s=window.t0 - tick,
                       rounds=n, wire_MB_per_round=(self.step.wire_bytes
                                                    - wire0) / n / 1e6)
        return out


def layer_gaps(got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """Per leaf and layer (a stacked leaf ``units/<i>/<name>`` split along
    its (units, count) axes, ``<leaf>#<layer>``), the norm of ``got`` (the
    program's, on the host) minus ``want`` (the reference's, on its device)
    and the norm of ``want``; the gap is inf where ``got`` lacks the leaf
    or has another shape."""
    out = {}
    for k, w in want.items():
        layers = w.shape[0] * w.shape[1] if k.startswith("units/") else 1
        w = w.reshape(layers, -1)
        ref = w.norm(dim=1).tolist()
        a = got.get(k)
        if a is None or a.numel() != w.numel():
            diff = [math.inf] * layers
        else:
            diff = (a.to(w.device, w.dtype).reshape(layers, -1) - w).norm(
                dim=1).tolist()
        for i in range(layers):
            out[f"{k}#{i}" if layers > 1 else k] = (diff[i], ref[i])
    return out


def scan_gaps(scan: Dict, device) -> Dict[str, float]:
    """The first scan a run kept (:func:`_first_scan_kept`) against the
    float64 recurrence (``reference/lm_rwkv6.py``'s scan under autograd)
    from the same inputs and ``dy``: for ``y`` and each gradient the norm
    of the gap over the reference's (inf where the run kept none)."""
    if "dy" not in scan:
        return {}
    wide = [x.to(device, torch.float64).requires_grad_(True)
            for x in scan["inputs"]]
    with torch.enable_grad():
        y = ref_lm.scan(*wide)
        grads = torch.autograd.grad(y, wide,
                                    scan["dy"].to(device, torch.float64))
    out = {}
    for name, want in zip(("y",) + SCAN_GRADS, (y.detach(),) + grads):
        got = scan.get(name)
        out[name] = math.inf if got is None else float(
            (got.to(device, torch.float64) - want).norm() / want.norm())
    return out


def block_gaps(got: Dict, params0: Dict[str, torch.Tensor], batch: Dict,
               eps: float, device, embed_dtype) -> Dict:
    """One run's first step (``got``: its blocks' inputs and output
    gradients, its first gradient and token losses; the gradient and the
    blocks are dropped once read) against
    ``ref_lm.first_step_by_block`` from the run's own inputs and
    gradients: ``grad1``, per leaf and layer (``<leaf>#<layer>``, as
    :func:`layer_gaps`) and per position of the stream (``stream#<i>``, the
    gradient of the loss with respect to block i's input, the head's at
    the last), the norm of the gap and of the reference; ``fwd1``, per
    block, the norm of its output's gap over that of the reference's
    update of the stream (the embedding's over the stream's); ``nll1``,
    the reference's token losses from the run's last block output.  A run
    that kept another stream reads inf."""
    kept = got.pop("blocks", {})
    stream, cot = kept.get("stream", []), kept.get("cotangents", {})
    grad1 = got.pop("grad1", {})
    slots = ref_lm.layer_slots(params0)
    shape = (*batch["tokens"].shape, params0["embed"].shape[1])
    if len(stream) != len(slots) + 1 or len(cot) != len(stream) or any(
            tuple(x.shape) != shape for x in stream):
        return {"grad1": {"stream": (math.inf, 0.0)},
                "fwd1": {"stream": math.inf}, "nll1": None}
    parts, fwd = {}, {}
    wide = lambda x: x.to(device, torch.float64)

    def gap(name, a, want):
        if a is None or a.numel() != want.numel():
            parts[name] = (math.inf, float(want.norm()))
        else:
            parts[name] = (float((wide(a).reshape(want.shape) - want).norm()),
                           float(want.norm()))
    nll = None
    for piece, out, grads, d_in in ref_lm.first_step_by_block(
            params0, batch, stream, cot, eps, device, embed_dtype):
        if piece == "embed":
            fwd["embed"] = float((wide(stream[0]) - out).norm() / out.norm())
            gap("embed", grad1.get("embed"), grads["embed"])
        elif piece == "head":
            nll = out.cpu()
            gap(f"stream#{len(slots)}", cot[len(slots)], d_in)
            for k, g in grads.items():
                gap(k, grad1.get(k), g)
        else:
            fwd[f"block#{piece}"] = float(
                (wide(stream[piece + 1]) - out).norm()
                / (out - wide(stream[piece])).norm())
            gap(f"stream#{piece}", cot[piece], d_in)
            for name, g in grads.items():
                key, u, c = slots[piece][name]
                a = grad1.get(key)
                gap(f"{key}#{u * params0[key].shape[1] + c}",
                    None if a is None else a[u, c], g)
        del out, grads, d_in
    return {"grad1": parts, "fwd1": fwd, "nll1": nll}


def reference(cell: harness.Cell, params0: Dict, gots: List[Dict],
              device, at_mean: bool = True) -> List[Dict]:
    """The reference against each run of ``gots`` (the program's drives from
    the same weights and batches, the first the program as it stands):
    machine 0's first step in float64 a block at a time from each run's
    own inputs and output gradients (:func:`block_gaps`), each run's
    first scan against float64 (:func:`scan_gaps`), then
    ``reference_rounds`` float32 rounds on the batches ``gots[0]`` drew,
    with, given ``at_mean``, the server's gradient at ``gots[0]``'s mean."""
    t = cell.traffic
    eps = model_config(cell.config).norm_eps
    embed = _DTYPES[cell.config["dtype"]]
    first = {k: x[0, 0] for k, x in gots[0]["batches"][0]["local"].items()}
    steps = []
    for got in gots:
        steps.append(block_gaps(got, params0, first, eps, device, embed))
        common.free(device)
    scans = [scan_gaps(got.pop("scan"), device) for got in gots]
    rounds = ref_lm.llcg_rounds(
        params0, gots[0]["batches"][:t["reference_rounds"]], eps, t["lr"],
        t["server_lr"], device, embed_dtype=embed,
        at_mean=gots[0]["avg1"] if at_mean else None)
    return [dict(rounds, **step, scan=g) for step, g in zip(steps, scans)]


def compare(got: Dict, ref: Dict, param_bytes: int, traffic: Dict) -> Dict:
    """The numbers the check can read:

    * ``nll1_gap``: each token's loss of machine 0's first batch at the
      initial weights, the round step's first forward against the float64
      reference's from the step's own last block output (the norm of the
      gap over the reference's);
    * ``fwd1_gap``: in that forward, each block's output against the
      float64 block from the step's own input, the norm of the gap over
      that of the reference's update of the stream (the embedding's over
      the stream's), the largest;
    * ``grad1_median_gap``, ``grad1_worst_gap``: machine 0's first local
      gradient against the float64 reference's, each block's from the
      step's own input and output gradient, per leaf and layer the norm
      of the difference over the larger of the reference's norm there and
      the median leaf's (per position of the stream, the gradient a block
      gives its input, over the reference's), the median and the worst;
    * ``scan_gap``: layer 0's scan in that step, its ``y`` and every
      gradient its backward gave, against the float64 recurrence from the
      inputs and the output gradient the kernels had, the largest;
    * ``corr_grad1_median_gap``, ``mean_median_gap``, ``step_median_gap``:
      the median leaf's gap (per-leaf norms, over the larger of the leaf's
      and the median leaf's reference norm; leaves under a thousandth of
      the median left out) of the server's first gradient at the
      program's own mean of round 1, of the mean's change in round 1 and
      of the parameters' change over the compared rounds;
    * ``loss_gap``, ``corr_gap``: the largest relative gap of the compared
      rounds' mean local and correction losses;
    * ``wire_bytes_gap``: the round step's counter after round 1 against 2
      G times the parameters' f32 bytes.

    The first step is held a block at a time because the whole model's
    float32 first gradient is ill-conditioned at init: a layer's first
    token divides its time mix's output, of variance down to ~1e-7, by
    sqrt(var + 1e-6), and over 24 layers those factors compound the
    rounding, so two float32 computations of the step (the kernels', the
    plain scan's) read leaves tenths to several times apart and apart from
    float64 on some seeds.  Each block from its own input is as well
    conditioned as one layer.  Of the float32 rounds the norms of the
    changes and the losses are held (Adam's first steps take the signs of
    that gradient, so the changes themselves differ element by element as
    much as an update of the wrong sign on some seeds).  ``detail`` keeps
    the worst leaves and blocks and the scan's gaps, for the record."""
    n = traffic["reference_rounds"]
    pairs = {"corr_grad1": (got["corr_grad1"], ref.get("corr_grad1_at", {})),
             "mean": (got["mean1_change"], ref["mean1_change"]),
             "step": (got["change"], ref["change"])}
    gaps = {k: common.leaf_gaps(a, b, common.kept_leaves(b)) if b else {}
            for k, (a, b) in pairs.items()}
    median = lambda vals: common.median(list(vals)) if vals \
        else float("inf")
    parts = ref["grad1"]
    leaves = [r for k, (_, r) in parts.items() if not k.startswith("stream")]
    med = common.median(leaves) if leaves else 0.0
    grad1 = {}
    for k, (d, r) in parts.items():
        gap = d / max(r, 1e-30 if k.startswith("stream") else med, 1e-30)
        grad1[k] = gap if math.isfinite(gap) else float("inf")
    rel = lambda key: common.relative_gap(got[key][:n], ref[key][:n]) \
        if len(got[key]) >= n else float("inf")
    nll, nll_ref = got["nll1"], ref["nll1"]
    fwd1 = ref["fwd1"]
    readings = {
        "nll1_gap": float((nll.double() - nll_ref).norm() / nll_ref.norm())
        if nll is not None and nll_ref is not None
        and nll.shape == nll_ref.shape else float("inf"),
        "fwd1_gap": max(fwd1.values(), default=float("inf")),
        "grad1_median_gap": median(grad1.values()),
        "grad1_worst_gap": max(grad1.values(), default=float("inf")),
        "scan_gap": max(ref["scan"].values(), default=float("inf")),
        "corr_grad1_median_gap": median(gaps["corr_grad1"].values()),
        "mean_median_gap": median(gaps["mean"].values()),
        "step_median_gap": median(gaps["step"].values()),
        "loss_gap": rel("local_loss"),
        "corr_gap": rel("corr_loss"),
        "wire_bytes_gap": abs(got["wire1"] - 2.0 * traffic["machines"]
                              * param_bytes),
    }
    detail = {"losses": [got["local_loss"], got["corr_loss"]],
              "ref_losses": [ref["local_loss"], ref["corr_loss"]],
              "grad1": [[k, grad1[k], parts[k][1]] for k in sorted(
                  grad1, key=grad1.get, reverse=True)[:4]],
              "fwd1": sorted(fwd1.items(), key=lambda kv: kv[1],
                             reverse=True)[:3],
              "scan": ref["scan"]}
    for k, (a, b) in pairs.items():
        detail[f"{k}_worst_gap"] = max(gaps[k].values(), default=None)
        detail[k] = common.worst_leaves(a, b, common.kept_leaves(b)) \
            if b else []
    return {"readings": readings, "detail": detail}


def work(cell: harness.Cell) -> Dict:
    """A round's model FLOPs (forward and backward, no recomputation) and
    per launch of each scan kernel its ``(bytes, operations)``."""
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import tree_leaves
    t = cell.traffic
    cfg = model_config(cell.config)
    heads, seq = cfg.d_model // HEAD, t["seq_len"]
    n_params = sum(math.prod(s.shape)
                   for s in tree_leaves(LM(cfg).param_specs()))
    embed = cfg.vocab_size * cfg.d_model
    steps = [t["batch_per_machine"]] * (t["machines"] * t["local_steps"]) \
        + [t["corr_batch"]] * t["correction_steps"]
    tokens = seq * sum(steps)
    fwd = [scan_work(b * heads, seq, SCAN_CHUNK, HEAD, HEAD) for b in steps]
    bwd = [scan_bwd_work(b * heads, seq, SCAN_CHUNK, HEAD, HEAD)
           for b in steps]
    flops = lm_train_flops(n_params - embed, tokens) + cfg.num_layers * sum(
        o for _, o in fwd + bwd)
    recompute = 2 if t["remat"] else 1
    return {"flops_per_round": flops, "precision": cell.config["precision"],
            "work": {"linear_scan": fwd * cfg.num_layers * recompute,
                     "linear_scan_bwd": bwd * cfg.num_layers},
            "facts": {"parameters": n_params, "tokens_per_round": tokens}}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device, t0: float) -> Dict:
    imports = time.perf_counter() - t0
    prog = Program(cell, seed, device)
    out = prog.drive(seconds, trace)
    w = out["window"]
    peak = common.peak_bytes(prog.device)
    ctx = harness.trace_context(w)
    phases = dict(imports=imports, **prog.phases,
                  check_rounds=out["check_rounds_s"])
    params0, param_bytes = prog.params0, prog.param_bytes
    del prog
    common.free(device)
    tick = time.perf_counter()
    (ref,) = reference(cell, params0, [out], device)
    checked = compare(out, ref, param_bytes, cell.traffic)
    phases["reference"] = time.perf_counter() - tick
    info = work(cell)
    ctx.update(info)
    return {"setup_s": w.t0 - t0, "window": w, "rounds": out["rounds"],
            "round_times": w.round_times(),
            "wire_MB_per_round": out["wire_MB_per_round"],
            "readings": checked["readings"], "memory_peak_bytes": peak,
            "ctx": ctx, "facts": dict(info["facts"], setup_phases=phases,
                                      detail=checked["detail"])}


def calibrate(cell: harness.Cell, seed: int, device, seconds: float,
              planted: List[Optional[str]]) -> List[Dict]:
    """The program's readings for one seed with each fault of ``planted``
    (the first None: the program as it stands), each from a fresh set-up
    over the compared rounds alone (no window: ``seconds``, which the
    calibration script passes every driver, is not used), against the reference of the batches
    the program as it stands draws (a fault may change the batches the
    program reads, not the ones it should have read).  The server's
    gradient is taken at the sound run's mean alone: a fault's reads
    inf."""
    from llcg_bench import faults_lm
    if planted[0] is not None:
        raise ValueError("calibrate's first run is the program as it "
                         "stands (None)")
    outs = []
    for f in planted:
        with (faults_lm.lm(f) if f else contextlib.nullcontext()):
            prog = Program(cell, seed, device)
            o = prog.drive(0.0, False, timed=False)
        if outs:
            o["avg1"] = {}
        outs.append(o)
        params0, param_bytes = prog.params0, prog.param_bytes
        del prog, o
        common.free(device)
    refs = reference(cell, params0, outs, device)
    res = []
    for o, ref, f in zip(outs, refs, planted):
        if o is not outs[0]:
            ref = {k: v for k, v in ref.items() if k != "corr_grad1_at"}
        res.append(dict(compare(o, ref, param_bytes, cell.traffic),
                        fault=f))
    return res


def control(cell: harness.Cell, seed: int, device) -> Dict:
    """The precision control: the program with the scan's state kept in
    bfloat16 (``faults_lm``'s ``bf16_state``), compared as the program
    is."""
    return calibrate(cell, seed, device, 0.0, [None, "bf16_state"])[1]


def end_to_end(out: Dict) -> Dict[str, float]:
    """The host-clock metrics of the window."""
    w = out["window"]
    return {"setup_s": out["setup_s"],
            "round_ms": w.wall_s / out["rounds"] * 1e3,
            "wire_MB_per_round": out["wire_MB_per_round"]}
