"""The paper's tables and figures on the PyTorch port, on the GPU.

A port of ``benchmarks/paper_experiments.py``: one function per artifact,
each on the same synthetic graphs, configs and seeds, plus ``device=``
(the GPU unless the caller passes another):

  fig2_and_fig4          — PSGD-PA vs LLCG vs GGS vs single machine:
                           validation score, training loss and bytes per
                           round (Fig. 2 & 4).
  fig11_subgraph_approx  — PSGD-PA ≤ subgraph approximation ≤ LLCG (App.
                           A.5, Fig. 11).
  table1                 — strategy × GNN operator: final F1 and MB per
                           round (Table 1).
  fig5_local_K           — effect of the local epoch size K (Fig. 5).
  fig6_sampling          — neighbor-sampling fanout × correction steps S
                           (Fig. 6).
  yelp_regime            — high feature SNR: no correction needed (App.
                           A.4).
  machines_scaling       — the PSGD-PA↔LLCG gap grows with P (App. A.5).
  kappa_vs_gap           — κ² measured against the PSGD-PA↔LLCG accuracy
                           gap across partitioners (Theorems 1/2).

Run:  PYTHONPATH=src python -m benchmarks.torch.paper_experiments --fast
      [--only fig2,kappa] [--device cpu] [--out BENCH_torch_paper.json]

Prints ``name,value,derived`` CSV rows as ``benchmarks/run.py`` does;
``--fast`` uses that runner's shorter round counts.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np

from repro_torch.core import (
    DistConfig, estimate_discrepancies, run_ggs, run_llcg, run_psgd_pa,
    run_single_machine,
)
from repro_torch.graph import cut_edge_stats, partition_graph, sbm_graph
from repro_torch.models.gnn import build_model


def _dataset(seed=0, n=480):
    return sbm_graph(num_nodes=n, num_classes=4, feature_dim=16,
                     feature_snr=0.15, homophily=0.95, avg_degree=14,
                     seed=seed)


def _base_cfg(**kw) -> DistConfig:
    d = dict(num_machines=4, rounds=10, local_k=4, batch_size=32,
             server_batch_size=64, fanout=8, lr=1e-2, correction_steps=2,
             partition_method="random", seed=0)
    d.update(kw)
    return DistConfig(**d)


def fig2_and_fig4(rounds=10, device="cuda") -> List[Dict]:
    ds = _dataset()
    model = build_model("GG", ds.feature_dim, ds.num_classes, hidden_dim=32)
    cfg = _base_cfg(rounds=rounds)
    rows = []
    for name, fn in (("psgd_pa", run_psgd_pa), ("llcg", run_llcg),
                     ("ggs", run_ggs), ("single", run_single_machine)):
        h = fn(ds, model, cfg, device=device)
        for i, r in enumerate(h.rounds):
            rows.append({"figure": "fig2_fig4", "strategy": name, "round": r,
                         "val_score": h.val_score[i],
                         "train_loss": h.train_loss[i],
                         "mbytes_cum": h.bytes_cum[i] / 1e6})
    return rows


def fig11_subgraph_approx(rounds=8, device="cuda") -> List[Dict]:
    """PSGD-PA ≤ subgraph-approx (10% storage) ≤ LLCG, mean of 3 seeds in
    a harder regime than fig2 (lower SNR, fewer rounds, K=2)."""
    from repro_torch.core.subgraph_approx import run_subgraph_approx
    scores = {"psgd_pa": [], "subgraph_approx": [], "llcg": []}
    storage = 0.0
    mb = 0.0
    for seed in (6, 7, 8):
        ds = sbm_graph(num_nodes=480, num_classes=4, feature_dim=16,
                       feature_snr=0.08, homophily=0.96, avg_degree=14,
                       seed=seed)
        model = build_model("GG", ds.feature_dim, ds.num_classes,
                            hidden_dim=32)
        cfg = _base_cfg(rounds=max(rounds // 2, 3), local_k=2,
                        correction_steps=1, seed=seed)
        h_psgd = run_psgd_pa(ds, model, cfg, device=device)
        h_apx = run_subgraph_approx(ds, model, cfg, overhead=0.10,
                                    device=device)
        h_llcg = run_llcg(ds, model, cfg, device=device)
        scores["psgd_pa"].append(h_psgd.final_score)
        scores["subgraph_approx"].append(h_apx.final_score)
        scores["llcg"].append(h_llcg.final_score)
        storage = h_apx.meta["storage_overhead_bytes"] / 1e6
        mb = h_psgd.avg_mb_per_round()
    rows = []
    for name, vals in scores.items():
        row = {"figure": "fig11", "strategy": name,
               "final_score": float(np.mean(vals)),
               "std": float(np.std(vals)), "mb_per_round": mb}
        if name == "subgraph_approx":
            row["storage_overhead_mb"] = storage
        rows.append(row)
    return rows


def table1(rounds=8, device="cuda") -> List[Dict]:
    ds = _dataset(seed=1)
    rows = []
    for arch in ("GG", "SS", "GAT", "APPNP"):
        model = build_model(arch, ds.feature_dim, ds.num_classes,
                            hidden_dim=32)
        cfg = _base_cfg(rounds=rounds)
        for name, fn in (("psgd_pa", run_psgd_pa), ("llcg", run_llcg),
                         ("ggs", run_ggs)):
            h = fn(ds, model, cfg, device=device)
            rows.append({"figure": "table1", "arch": arch, "strategy": name,
                         "final_score": h.final_score,
                         "avg_mb_per_round": h.avg_mb_per_round()})
    return rows


def fig5_local_K(ks=(1, 4, 16), rounds=8, device="cuda") -> List[Dict]:
    ds = _dataset(seed=2)
    model = build_model("GG", ds.feature_dim, ds.num_classes, hidden_dim=32)
    rows = []
    for k in ks:
        h = run_llcg(ds, model, _base_cfg(local_k=k, rounds=rounds),
                     device=device)
        rows.append({"figure": "fig5", "K": k, "final_score": h.final_score,
                     "total_steps": h.steps_cum[-1],
                     "rounds": len(h.rounds)})
    return rows


def fig6_sampling(fanouts=(2, 8, None), s_steps=(0, 1, 4), rounds=8,
                  device="cuda") -> List[Dict]:
    ds = _dataset(seed=3)
    model = build_model("GG", ds.feature_dim, ds.num_classes, hidden_dim=32)
    rows = []
    for fo in fanouts:
        for s in s_steps:
            cfg = _base_cfg(fanout=fo, correction_steps=s, rounds=rounds)
            fn = run_llcg if s > 0 else run_psgd_pa
            h = fn(ds, model, cfg, device=device)
            rows.append({"figure": "fig6", "fanout": fo if fo else "full",
                         "S": s, "final_score": h.final_score})
    return rows


def yelp_regime(rounds=6, device="cuda") -> List[Dict]:
    """When features alone classify (high SNR — the Yelp case), PSGD-PA ≈
    GGS ≈ MLP and no correction is needed."""
    ds = sbm_graph(num_nodes=480, num_classes=4, feature_dim=16,
                   feature_snr=2.5, homophily=0.9, avg_degree=14, seed=5)
    gnn = build_model("GG", ds.feature_dim, ds.num_classes, hidden_dim=32)
    mlp = build_model("LL", ds.feature_dim, ds.num_classes, hidden_dim=32)
    cfg = _base_cfg(rounds=rounds)
    h_psgd = run_psgd_pa(ds, gnn, cfg, device=device)
    h_ggs = run_ggs(ds, gnn, cfg, device=device)
    h_mlp = run_psgd_pa(ds, mlp, cfg, device=device)
    return [
        {"figure": "yelp_regime", "strategy": "psgd_gnn",
         "final_score": h_psgd.final_score},
        {"figure": "yelp_regime", "strategy": "ggs_gnn",
         "final_score": h_ggs.final_score,
         "gap_to_psgd": h_ggs.final_score - h_psgd.final_score},
        {"figure": "yelp_regime", "strategy": "psgd_mlp",
         "final_score": h_mlp.final_score},
    ]


def machines_scaling(ps=(2, 4, 8), rounds=6, seeds=(9, 10, 11),
                     device="cuda") -> List[Dict]:
    """The PSGD-PA↔LLCG gap grows with the number of machines P (more
    cut-edges, larger κ²_A); mean over seeds."""
    rows = []
    for p in ps:
        gaps, cuts = [], []
        for seed in seeds:
            ds = sbm_graph(num_nodes=640, num_classes=4, feature_dim=16,
                           feature_snr=0.08, homophily=0.96, avg_degree=14,
                           seed=seed)
            model = build_model("GG", ds.feature_dim, ds.num_classes,
                                hidden_dim=32)
            cfg = _base_cfg(num_machines=p, rounds=rounds, local_k=2,
                            correction_steps=1, seed=seed)
            h_psgd = run_psgd_pa(ds, model, cfg, device=device)
            h_llcg = run_llcg(ds, model, cfg, device=device)
            gaps.append(h_llcg.final_score - h_psgd.final_score)
            part = partition_graph(ds.graph, p, method="random", seed=seed)
            cuts.append(cut_edge_stats(ds.graph,
                                       part.assignment)["cut_fraction"])
        rows.append({"figure": "machines_scaling", "P": p,
                     "cut_fraction": float(np.mean(cuts)),
                     "gap_mean": float(np.mean(gaps)),
                     "gap_std": float(np.std(gaps))})
    return rows


def kappa_vs_gap(rounds=8, device="cuda") -> List[Dict]:
    ds = _dataset(seed=4)
    model = build_model("GG", ds.feature_dim, ds.num_classes, hidden_dim=32)
    rows = []
    for method in ("random", "bfs", "spectral"):
        part = partition_graph(ds.graph, 4, method=method)
        est = estimate_discrepancies(ds, part, model,
                                     model.init(0, device=device),
                                     fanout=8, num_sampling_trials=3)
        cfg = _base_cfg(partition_method=method, rounds=rounds)
        h_psgd = run_psgd_pa(ds, model, cfg, device=device)
        h_llcg = run_llcg(ds, model, cfg, device=device)
        rows.append({"figure": "kappa_vs_gap", "partition": method,
                     "kappa_sq": est.kappa_sq,
                     "kappa_a_sq": est.kappa_a_sq,
                     "sigma_bias_sq": est.sigma_bias_sq,
                     "psgd_score": h_psgd.final_score,
                     "llcg_score": h_llcg.final_score,
                     "gap_closed": h_llcg.final_score - h_psgd.final_score})
    return rows


def _emit(rows) -> None:
    """``benchmarks/run.py``'s CSV rows: a name from the row's keys, the
    headline value × 1e6, and every field."""
    for r in rows:
        name = "_".join(str(r.get(k)) for k in
                        ("figure", "strategy", "arch", "partition", "K",
                         "fanout", "S", "round", "P") if r.get(k) is not None)
        val = r.get("val_score", r.get("final_score", r.get("gap_closed",
                                                            r.get("gap_mean",
                                                                  0))))
        derived = ";".join(f"{k}={v}" for k, v in r.items() if k != "figure")
        print(f"{name},{float(val) * 1e6 if val == val else 0:.1f},{derived}")


#: section name → (function, its round count from the runner's ``rounds``)
SECTIONS = {
    "fig2": (fig2_and_fig4, lambda r: r),
    "table1": (table1, lambda r: max(r - 2, 3)),
    "fig5": (fig5_local_K, lambda r: r),
    "fig6": (fig6_sampling, lambda r: max(r - 2, 3)),
    "kappa": (kappa_vs_gap, lambda r: max(r - 2, 3)),
    "yelp": (yelp_regime, lambda r: max(r - 2, 3)),
    "fig11": (fig11_subgraph_approx, lambda r: max(r - 2, 4)),
    "scaling": (machines_scaling, lambda r: max(r - 2, 4)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="benchmarks/run.py's short round counts")
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(SECTIONS))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="also write every row to this JSON file")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else list(SECTIONS)
    unknown = sorted(set(only) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown sections {unknown}; choose from {list(SECTIONS)}")
    rounds = 4 if args.fast else 8
    t0 = time.time()
    print("name,us_per_call,derived")
    results = {}
    for name in only:
        fn, rounds_for = SECTIONS[name]
        results[name] = fn(rounds=rounds_for(rounds), device=args.device)
        _emit(results[name])
    wall = time.time() - t0
    print(f"# total_benchmark_wall_s={wall:.1f} device={args.device}",
          file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": args.device, "fast": args.fast,
                       "wall_s": wall, "sections": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
