"""GNN training rounds through the port's round engine.

Set-up builds the graph (``llcg_bench.sbm``: its structure from the
config's ``structure_seed``, its features from the seed), the initial
parameters from the seed on the device, and, as ``PlanTrainer.run()`` builds them, the
plan's ``RoundSampler`` (prewarmed) and ``_PlanProgram``.  One call of the
engine's round loop, ``core/engine.py``'s ``run_schedule``, runs the
``check_rounds`` rounds the check reads and then rounds back to back
until ``--seconds`` have passed (``harness.TimedSchedule``).  The
evaluation each round is the program's full-graph forward
(``GNNModel.apply``) through the correction's aggregation operands:
``RoundSampler.evaluate``'s padded table would gather (N, max degree, d)
rows, beyond the card at this size.  The local and the server optimizer
are wrapped (``Program._observed``) to keep the first gradient each is
given, which the engine does not report.  So the window times this
composition of the program's parts, not ``PlanTrainer.run()`` itself.

After the window the reference (``reference/gnn.py``) runs the checked
rounds again from the same seed and parameters and the two are compared.

Every seed runs the same graph structure, partition and sampling streams
(the traffic's ``plan_seed``) with its own features and weights: the
partition's largest local degree sets the device draw's width, so a
partition drawn from the seed changed the work of a round by up to 2%
from seed to seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from llcg_bench import faults, harness
from llcg_bench.bounds import sage_stack_flops, spmm_csr_work
from llcg_bench.drivers import common
from llcg_bench.reference import gnn as ref_gnn
from llcg_bench.sbm import sbm

#: Rounds the schedule can hold; the window stops it long before.
ROUND_LIMIT = 20_000


def make_graph(config: Dict, seed: int, device):
    """The config's graph structure with features drawn from ``seed``."""
    g = config["graph"]
    return sbm(g["num_nodes"], g["num_classes"], g["feature_dim"],
               g["avg_degree"], g["homophily"], g["feature_snr"],
               g["structure_seed"], device, feature_seed=seed)


def make_params(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial parameters from the seed, on the device: Glorot-normal
    weights, zero biases and BatchNorm shifts, unit BatchNorm scales.
    Flat ``"<op><i>/<leaf>"`` keys, the program's tree names."""
    m, g = config["model"], config["graph"]
    gen = common.generator(seed, device)
    out = {}
    for i, (op, d_in, d_out) in enumerate(ref_gnn.op_dims(
            m["arch"], g["feature_dim"], m["hidden_dim"], g["num_classes"])):
        name = f"{op.lower()}{i}"
        if op == "B":
            out[f"{name}/gamma"] = torch.ones(d_in, device=device)
            out[f"{name}/beta"] = torch.zeros(d_in, device=device)
            continue
        std = float(np.sqrt(2.0 / (d_in + d_out)))
        for w in ("w_self", "w_nbr") if op == "S" else ("w",):
            out[f"{name}/{w}"] = torch.randn(
                (d_in, d_out), generator=gen, device=device) * std
        out[f"{name}/b"] = torch.zeros(d_out, device=device)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for k, v in flat.items():
        a, b = k.split("/")
        tree.setdefault(a, {})[b] = v
    return tree


class Program:
    """The program's objects for one seed, built as ``PlanTrainer.run()``
    builds them."""

    def __init__(self, cell: harness.Cell, seed: int, device):
        from repro_torch.core.plan import (DistConfig, RoundSampler,
                                           _PlanProgram, build_trainer,
                                           llcg_plan)
        from repro_torch.graph.csr import CSRGraph
        from repro_torch.graph.datasets import SyntheticDataset
        from repro_torch.models.gnn.model import build_model

        conf, t = cell.config, cell.traffic
        self.cell, self.seed = cell, seed
        self.phases = {}
        tick = time.perf_counter()
        self.g = g = make_graph(conf, seed, device)
        self.phases["graph"] = time.perf_counter() - tick
        tick = time.perf_counter()
        data = SyntheticDataset(
            graph=CSRGraph(indptr=g.indptr, indices=g.indices,
                           num_nodes=g.num_nodes),
            features=g.features, labels=g.labels, train_nodes=g.train_nodes,
            val_nodes=g.val_nodes, test_nodes=g.test_nodes,
            num_classes=g.num_classes, name=conf["name"])
        m = conf["model"]
        self.model = build_model(m["arch"], g.features.shape[1],
                                 g.num_classes, hidden_dim=m["hidden_dim"])
        cfg = DistConfig(num_machines=t["machines"], rounds=ROUND_LIMIT,
                         local_k=t["local_steps"],
                         correction_steps=t["correction_steps"],
                         batch_size=t["batch_size"],
                         server_batch_size=t["server_batch_size"],
                         fanout=t["fanout"], lr=t["lr"],
                         partition_method=t["partition"],
                         server_agg_layout=t["server_agg_layout"],
                         seed=t["plan_seed"])
        plan = llcg_plan(cfg)
        self.plan = plan = dataclasses.replace(
            plan, sampler=dataclasses.replace(plan.sampler,
                                              placement=t["placement"]))
        self.trainer = build_trainer(data, self.model, plan, device=device)
        self.device = self.trainer.device
        self.sampler = RoundSampler(data, self.model, plan, self.device)
        # what the local and the server optimizer are first given in a drive
        self.first: Dict[str, Dict] = {"local": {}, "server": {}}
        self.sampler.opt = self._observed(self.sampler.opt,
                                          self.first["local"])
        self.sampler.server_opt = self._observed(
            self.sampler.server_opt, self.first["server"], params=True)
        self.sampler.prewarm(
            {d.kind for d in self.trainer.descs},
            correction=any(d.correction for d in self.trainer.descs))
        self.program = _PlanProgram(self.model, self.sampler,
                                    self.trainer.descs,
                                    self.trainer.uniforms,
                                    backend=self.trainer.backend)
        self.by_round = {row["round"]: row
                         for row in self.trainer.accounting(self.sampler)}
        self.desc_by_round = {d.r: d for d in self.trainer.descs}
        self.corr_agg = self.sampler.correction_operands()
        self.val = torch.from_numpy(np.asarray(g.val_nodes)).to(self.device)
        self.rng0 = self.sampler.snapshot()
        self.phases["program"] = time.perf_counter() - tick

    @staticmethod
    def _observed(opt, into: Dict, params: bool = False):
        """``opt``, unchanged, that also keeps in ``into`` the per-leaf norms
        of the first gradient it is given in a drive (``grads``: the
        machines' first local gradients, or the server's first gradient, as
        the optimizer gets them) and, with ``params``, a copy of the
        parameters that gradient was taken at."""
        from repro_torch.optim.optimizers import Optimizer

        def update(grads, state, p):
            if not into:
                into["grads"] = common.norms(common.flatten(grads))
                if params:
                    into["params"] = {k: v.detach().clone() for k, v in
                                      common.flatten(p).items()}
            return opt.update(grads, state, p)
        return Optimizer(opt.init, update)

    def drive(self, seconds: float, trace: bool) -> Dict:
        """The checked rounds, then the window; what the check and the
        metrics read."""
        from repro_torch.core.engine import run_schedule
        from repro_torch.models.gnn.model import (cross_entropy_on_batch,
                                                  f1_micro)

        warm = self.cell.traffic["check_rounds"]
        sampler, program, model = self.sampler, self.program, self.model
        sampler.restore_snapshot(self.rng0)
        for seen_first in self.first.values():
            seen_first.clear()
        window = harness.Window(seconds, trace, self.device)
        seen: Dict = {"round": 0}
        tick = time.perf_counter()

        def evaluate(params):
            with torch.no_grad():
                logits = model.apply(params, sampler.full_feats,
                                     sampler.full_table_d,
                                     sampler.full_mask_d, agg=self.corr_agg)
                out = (float(cross_entropy_on_batch(
                    logits, sampler.full_labels, self.val)),
                    float(f1_micro(logits, sampler.full_labels, self.val)))
            window.round_done()
            seen["round"] += 1
            if seen["round"] == 1 and program.with_correction:
                seen["server_m1"] = common.norms(
                    common.flatten(program._server_state.mu))
                seen["params1"] = {k: v.detach().clone() for k, v in
                                   common.flatten(params).items()}
            if seen["round"] == warm:
                seen["params"] = {k: v.detach().clone() for k, v in
                                  common.flatten(params).items()}
            return out

        params0 = make_params(self.cell.config, self.seed, self.device)
        drawn = {}

        def sample(r, k):
            inputs = sampler.sample(self.desc_by_round[r])
            if r == 1:
                drawn.update(tables=inputs.tables.clone(),
                             masks=inputs.masks.clone(),
                             batches=inputs.batches.clone(),
                             corr_batches=inputs.corr_batches.clone())
            return inputs

        hist = run_schedule(
            program, nest(params0), None, None, sample,
            harness.TimedSchedule(self.plan.local.local_k, ROUND_LIMIT,
                                  warm, window),
            evaluate, self.plan.name,
            bytes_per_round=lambda r, k: self.by_round[r]["bytes"],
            steps_per_round=lambda r, k: self.by_round[r]["steps"],
            prefetch=self.plan.sampler.resolved_overlap, device=self.device)
        window.close()
        n = window.rounds
        return {"window": window, "check_rounds_s": window.t0 - tick,
                "rounds": n,
                "wire_MB_per_round": (hist.bytes_cum[-1]
                                      - hist.bytes_cum[warm - 1]) / n / 1e6,
                "local_loss": hist.meta["local_loss"][:warm],
                "corr_loss": hist.meta["corr_loss"][:warm],
                "val_loss": hist.train_loss[:warm],
                "val_score": hist.val_score[:warm],
                "bytes": hist.bytes_cum[0],
                "server_m1": seen.get("server_m1", {}),
                "grad1": self.first["local"].get("grads", {}),
                "corr_grad1": self.first["server"].get("grads", {}),
                "avg1": self.first["server"].get("params", {}),
                "params1": seen.get("params1", {}),
                "params": seen["params"], "drawn": drawn}


def reference(cell: harness.Cell, g, seed: int, device,
              control: bool = False) -> Dict:
    t = cell.traffic
    return ref_gnn.llcg_reference(
        g, make_params(cell.config, seed, device), cell.config["model"]["arch"],
        t, t["check_rounds"], t["plan_seed"], device, control=control)


def judged(cell: harness.Cell, ref: Dict, got: Dict) -> Dict:
    """The reference's float32 readings at ``got``'s own round-1
    parameters (``ref_gnn.judge_at``), on round 1's first server batch."""
    return ref_gnn.judge_at(ref["full"], cell.config["model"]["arch"],
                            ref["drawn"]["corr_batches"][0], got["avg1"],
                            got["params1"])


def compare(got: Dict, ref: Dict, at: Dict, params0: Dict[str, torch.Tensor],
            traffic: Dict) -> Dict:
    """The numbers the check can read: the entries of round 1's tables,
    masks, batches and server batches that differ from the reference's
    draw; relative gaps of the first round's local, correction and
    validation losses; the worst gap of the validation accuracy over the
    checked rounds; the worst leaf's gap of the machines' first gradient,
    of the server's first moment after round 1 and of the parameters'
    change over the checked rounds (leaves whose reference gradient or
    moment is under a thousandth of the median leaf's left out); the wire
    bytes of a round against 2 P times the parameters' bytes.  And, at the
    program's own round-1 parameters (``at``, :func:`judged`): the median
    leaf's gap of the server's first gradient (through the correction's
    aggregation; its worst leaf, a sum that cancels under BatchNorm, swings
    with the ReLU units that the two summation orders flip) and the
    relative gap of the validation loss (through the evaluation's).
    ``detail`` is for the record."""
    change_prog = common.norms({k: v - params0[k]
                                for k, v in got["params"].items()})
    change_ref = common.norms({k: v - params0[k]
                               for k, v in ref["params"].items()})
    ref_m1 = common.norms(ref["server_m1"])
    keep = common.kept_leaves(ref_m1)
    keep1 = common.kept_leaves(ref["grad1"])
    keep_c = common.kept_leaves(at["corr_grad1_at"])
    param_bytes = 4 * sum(v.numel() for v in params0.values())
    rel = lambda key: common.relative_gap(got[key][:1], ref[key][:1])
    grads = common.leaf_gaps(got["server_m1"], ref_m1, keep)
    corr1 = common.leaf_gaps(got["corr_grad1"], at["corr_grad1_at"], keep_c)
    steps = common.leaf_gaps(change_prog, change_ref, keep)
    drawn, want = got["drawn"], ref["drawn"]
    readings = {
        "draw_gap": float(sum(int((drawn[k].long() != want[k].long()).sum())
                              for k in ("tables", "batches", "corr_batches"))
                          + int((drawn["masks"] != want["masks"]).sum())),
        "loss_gap": rel("local_loss"),
        "corr_gap": rel("corr_loss"),
        "val_gap": rel("val_loss"),
        "score_gap": max(abs(a - b) for a, b in
                         zip(got["val_score"], ref["val_score"])),
        "grad1_gap": common.worst_leaf_gap(got["grad1"], ref["grad1"],
                                           keep1),
        "corr_grad1_median_gap": common.median(list(corr1.values())),
        "eval_gap": common.relative_gap(got["val_loss"][:1],
                                        [at["val_loss_at"]]),
        "grad_gap": max(grads.values()),
        "step_gap": max(steps.values()),
        "wire_bytes_gap": abs(got["bytes"] - 2.0 * traffic["machines"]
                              * param_bytes),
    }
    keys = ("local_loss", "corr_loss", "val_loss", "val_score")
    detail = {"losses": [got[k] for k in keys],
              "ref_losses": [ref[k] for k in keys],
              "left_out": sorted(set(ref_m1) - set(keep)),
              "left_out_grad1": sorted(set(ref["grad1"]) - set(keep1)),
              "grad1": common.leaf_gaps(got["grad1"], ref["grad1"], keep1),
              "corr_grad1": corr1,
              "grad": grads, "step": steps,
              "grad_gap_median": common.median(list(grads.values())),
              "step_gap_median": common.median(list(steps.values()))}
    return {"readings": readings, "detail": detail}


def work(cell: harness.Cell, g) -> Dict:
    """FLOPs of a round and the SpMM launches' (bytes, operations)."""
    t, m = cell.traffic, cell.config["model"]
    layers = ref_gnn.op_dims(m["arch"], g.features.shape[1],
                             m["hidden_dim"], g.num_classes)
    part = ref_gnn.Partitioned(g.indptr, g.indices, g.train_nodes,
                               t["machines"], t["plan_seed"])
    nnz = g.num_edges
    flops = 0.0
    for ip, _ in part.graphs:
        e = int(np.minimum(np.diff(ip), t["fanout"]).sum())
        flops += t["local_steps"] * sage_stack_flops(layers, ip.size - 1, e,
                                                     True)
    flops += t["correction_steps"] * sage_stack_flops(layers, g.num_nodes,
                                                      nnz, True)
    flops += sage_stack_flops(layers, g.num_nodes, nnz, False)
    agg_in = [(i, d_in) for i, (op, d_in, _) in enumerate(layers)
              if op in ("S", "G")]
    spmm: List[int] = []
    if t["server_agg_layout"] == "bcsr_kernel":
        per_step = [d for _, d in agg_in] + [d for i, d in agg_in if i > 0]
        spmm = per_step * t["correction_steps"] + [d for _, d in agg_in]
    return {"flops_per_round": flops, "precision": cell.config["precision"],
            "work": {"spmm_csr": [spmm_csr_work(g.num_nodes, nnz, d)
                                  for d in spmm]},
            "facts": {"nodes": g.num_nodes, "edges": nnz // 2,
                      "n_max": part.n_max, "dmax": part.dmax}}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device, t0: float) -> Dict:
    imports = time.perf_counter() - t0
    prog = Program(cell, seed, device)
    out = prog.drive(seconds, trace)
    w = out["window"]
    phases = dict(imports=imports, **prog.phases,
                  check_rounds=out["check_rounds_s"])
    peak = common.peak_bytes(prog.device)
    ctx = harness.trace_context(w)
    g = prog.g
    del prog
    common.free(device)
    ref = reference(cell, g, seed, device)
    checked = compare(out, ref, judged(cell, ref, out),
                      make_params(cell.config, seed, device), cell.traffic)
    del ref
    info = work(cell, g)
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
    (None: none), from one set-up, against one reference."""
    prog = Program(cell, seed, device)
    outs = []
    for f in planted:
        with (faults.gnn(f) if f else contextlib.nullcontext()):
            o = prog.drive(seconds, False)
        outs.append({k: v for k, v in o.items() if k != "window"})
    g = prog.g
    del prog
    common.free(device)
    ref = reference(cell, g, seed, device)
    p0 = make_params(cell.config, seed, device)
    return [dict(compare(o, ref, judged(cell, ref, o), p0, cell.traffic),
                 fault=f) for o, f in zip(outs, planted)]


def control(cell: harness.Cell, seed: int, device) -> Dict:
    """The control: the reference with every product in TF32 put in the
    program's place, compared as the program is."""
    g = make_graph(cell.config, seed, device)
    low = reference(cell, g, seed, device, control=True)
    p0 = make_params(cell.config, seed, device)
    low["bytes"] = 2.0 * cell.traffic["machines"] * 4 * sum(
        v.numel() for v in p0.values())
    low["server_m1"] = common.norms(low["server_m1"])
    del low["full"]
    ref = reference(cell, g, seed, device)
    return compare(low, ref, judged(cell, ref, low), p0, cell.traffic)


def end_to_end(out: Dict) -> Dict[str, float]:
    """The host-clock metrics of the window."""
    w = out["window"]
    return {"setup_s": out["setup_s"],
            "round_ms": w.wall_s / out["rounds"] * 1e3,
            "round_p90_ms": harness.percentile(out["round_times"], 0.9)
            * 1e3,
            "wire_MB_per_round": out["wire_MB_per_round"]}
