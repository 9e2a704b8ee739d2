"""Quickstart of the PyTorch port: the paper's three strategies as
TrainPlans, run on the GPU.

The same 2-layer GCN is trained three ways on a synthetic SBM graph whose
labels need the graph structure (low feature SNR, the Reddit-like regime),
each strategy a composition of round-phase primitives lowered by one entry
point, :func:`repro_torch.core.build_trainer`:

  PSGD-PA — Algorithm 1: local_steps + averaging (cut-edges ignored).
  LLCG    — Algorithm 2: + correction (the paper).
  GGS     — halo_exchange: features shipped every step (upper bound).

Expected outcome (the paper's Figure 4): LLCG ≈ GGS accuracy at PSGD-PA
communication cost.  The graph, configs and seeds are those of
``examples/quickstart.py``, so the bytes each strategy moves are the JAX
package's to the byte.

Reliability knob: ``TrainPlan(checkpoint=CheckpointSpec(dir=...))``
snapshots the full training state every ``every`` rounds off the training
thread, and a killed run resumes bit-identical through
:func:`repro_torch.launch.train.resume` / ``run_or_resume``; the last
section resumes the LLCG plan from a mid-schedule checkpoint.  See
:mod:`repro_torch.checkpoint.chaos` for the SIGKILL → resume trial.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys
import tempfile

from repro_torch.core import (CheckpointSpec, DistConfig, TrainPlan,
                              averaging, build_trainer, correction,
                              halo_exchange, local_steps)
from repro_torch.graph import cut_edge_stats, partition_graph, sbm_graph
from repro_torch.models.gnn import build_model


def setting():
    """The quickstart's graph, model and flat config."""
    data = sbm_graph(num_nodes=600, num_classes=4, feature_dim=16,
                     feature_snr=0.15, homophily=0.95, avg_degree=14, seed=0)
    model = build_model("GG", data.feature_dim, data.num_classes,
                        hidden_dim=32)
    cfg = DistConfig(num_machines=4, rounds=10, local_k=4, batch_size=32,
                     server_batch_size=64, fanout=8, lr=1e-2,
                     correction_steps=2, partition_method="random", seed=0)
    return data, model, cfg


def plans(cfg: DistConfig):
    """PSGD-PA, LLCG and GGS over the config's grouped sub-configs."""
    specs = cfg.specs()
    return (
        TrainPlan(phases=(local_steps(), averaging()),
                  name="PSGD-PA", seed=cfg.seed, **specs),
        TrainPlan(phases=(local_steps(), averaging(), correction()),
                  name="LLCG", seed=cfg.seed, **specs),
        TrainPlan(phases=(halo_exchange(),),
                  name="GGS", seed=cfg.seed, **specs),
    )


def run(device="cuda"):
    """Each plan's History, in the order of :func:`plans`."""
    data, model, cfg = setting()
    return [build_trainer(data, model, plan, device=device).run()
            for plan in plans(cfg)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    data, _, cfg = setting()
    part = partition_graph(data.graph, cfg.num_machines,
                           method=cfg.partition_method, seed=cfg.seed)
    stats = cut_edge_stats(data.graph, part.assignment)
    print(f"graph: {data.num_nodes} nodes, {data.graph.num_edges} edges, "
          f"{stats['cut_fraction']:.0%} cut under random partitioning; "
          f"device {args.device}\n")
    print(f"{'strategy':10s} {'final F1':>9s} {'MB/round':>9s} "
          f"{'bytes':>10s}   {'score trajectory'}")
    for plan, hist in zip(plans(cfg), run(args.device)):
        traj = " ".join(f"{v:.2f}" for v in hist.val_score[::2])
        print(f"{plan.name:10s} {hist.final_score:9.3f} "
              f"{hist.avg_mb_per_round():9.3f} {hist.bytes_cum[-1]:10.0f}   "
              f"{traj}")
    print("\nLLCG should match GGS accuracy at PSGD-PA communication cost.")
    checkpointed(args.device)
    return 0


def checkpointed(device="cuda"):
    """The LLCG plan with the checkpoint knob on: a full run writes a
    snapshot every 2 rounds, then a fresh trainer resumes from the round-4
    snapshot (as a job killed after round 5 would) and ``run_or_resume``
    continues the finished run as a no-op; both return the History of the
    uninterrupted run."""
    from repro_torch.launch.train import resume, run_or_resume
    data, model, cfg = setting()
    llcg = plans(cfg)[1]
    with tempfile.TemporaryDirectory() as ck:
        plan = TrainPlan(phases=llcg.phases, name="LLCG", seed=cfg.seed,
                         checkpoint=CheckpointSpec(dir=ck, every=2, keep=0),
                         **cfg.specs())
        hist = build_trainer(data, model, plan, device=device).run()
        mid = resume(data, model, plan, step=4, device=device)
        again = run_or_resume(data, model, plan, device=device)
    same = all(h.val_score == hist.val_score and h.train_loss ==
               hist.train_loss for h in (mid, again))
    print(f"checkpointed LLCG: F1 {hist.final_score:.3f}; resumed from "
          f"round 4: F1 {mid.final_score:.3f}; run_or_resume: F1 "
          f"{again.final_score:.3f}; trajectories identical: {same}")
    return hist, mid, again


if __name__ == "__main__":
    sys.exit(main())
