"""Train→serve end to end in the PyTorch port: TrainPlan → checkpoint →
GNN serving, on the GPU unless ``--device`` names another.

Trains a few LLCG rounds on a partitioned synthetic graph, exports the
round-engine params through the checkpoint store (``TrainPlan.
checkpoint_dir``), restores them into the GNN serving backend
(``GNNServingEngine.from_plan`` — the serving partition topology comes
from the SAME plan object that trained the params) and serves a mixed wave
of node queries — the graph stays partitioned, cut-crossing queries ride
the same halo-exchange lowering the training engine executes.

A second section serves the SAME checkpoint continuously
(``scheduler="slot"``): requests are submitted WHILE the scheduler is
running — each ``engine.scheduler.step()`` admits whatever has arrived
into free slots, serves the occupied ones, and retires finishers, so a
late submit never waits for a synchronous wave boundary.  Predictions
are byte-identical across the two schedulers (per-request determinism:
outputs depend on the serving seed and the request, not on co-residents
or admission order).

The port's counterpart of ``examples/serve_gnn.py``: same graph, model,
plan and queries.

Run:  PYTHONPATH=src python examples/torch_serve_gnn.py [--device cpu]
"""
import argparse
import sys
import tempfile

import numpy as np

from repro_torch.core import DistConfig, build_trainer, llcg_plan
from repro_torch.graph.datasets import grid_graph
from repro_torch.models.gnn import build_model
from repro_torch.serving.gnn import GNNRequest, GNNServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (default: "
                         "cuda)")
    args = ap.parse_args(argv)
    dev = args.device
    data = grid_graph(side=16, num_classes=4, feature_dim=8, seed=0)
    model = build_model("SS", data.feature_dim, data.num_classes,
                        hidden_dim=16)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = DistConfig(num_machines=4, rounds=4, local_k=4, batch_size=16,
                         fanout=4, checkpoint_dir=ckpt_dir, seed=0)
        plan = llcg_plan(cfg)
        hist = build_trainer(data, model, plan, device=dev).run()
        print(f"trained {cfg.rounds} LLCG rounds "
              f"(final val score {hist.final_score:.3f}); "
              f"params exported to the checkpoint store\n")

        engine = GNNServingEngine.from_plan(plan, model, data, batch_size=4,
                                            device=dev)
        meta = engine.checkpoint_meta
        print(f"restored round {meta['extra']['round']} "
              f"({meta['extra']['strategy']}) for serving "
              f"(L={engine.backend.num_hops} hops, "
              f"{engine.partition.num_parts} machines)\n")

        rng = np.random.default_rng(0)
        for uid in range(10):
            nodes = rng.choice(data.num_nodes,
                               size=int(rng.integers(1, 5)), replace=False)
            engine.submit(GNNRequest(uid=uid, nodes=nodes.tolist(),
                                     return_embeddings=(uid % 3 == 0)))
        results = engine.run()
        stats = engine.stats()
        print(f"served {stats['served']} queries "
              f"({stats['nodes_served']} nodes) in {stats['waves']} waves; "
              f"{stats['num_retraces']} width bucket(s), "
              f"{stats['exchange_bytes_cum'] / 1e3:.1f} kB halo traffic\n")
        for r in sorted(results, key=lambda r: r.uid):
            emb = ("" if r.embeddings is None
                   else f" emb{r.embeddings.shape}")
            print(f"  req {r.uid:2d} nodes={len(r.nodes)} "
                  f"preds={r.predictions} wave={r.wave} "
                  f"halo={'Y' if r.halo else 'n'}{emb}")

        # ---- continuous serving: submit while the scheduler is running ----
        print("\ncontinuous serving (scheduler='slot', 2 slots):")
        slot_engine = GNNServingEngine.from_plan(plan, model, data,
                                                 batch_size=2,
                                                 scheduler="slot",
                                                 device=dev)
        rng = np.random.default_rng(0)          # same query stream as above
        queries = [(uid, rng.choice(data.num_nodes,
                                    size=int(rng.integers(1, 5)),
                                    replace=False).tolist())
                   for uid in range(10)]
        slot_results = []
        pending = list(queries)
        # Seed the queue with the first three arrivals, then keep stepping;
        # the rest arrive mid-flight, between steps — no wave boundary.
        for uid, nodes in pending[:3]:
            slot_engine.submit(GNNRequest(uid=uid, nodes=nodes))
        pending = pending[3:]
        while pending or slot_engine.scheduler.queued \
                or slot_engine.scheduler.active:
            slot_results.extend(slot_engine.scheduler.step())
            if pending:                         # a late arrival each step
                uid, nodes = pending.pop(0)
                slot_engine.submit(GNNRequest(uid=uid, nodes=nodes))
        sstats = slot_engine.stats()
        print(f"served {sstats['served']} queries over {sstats['steps']} "
              f"steps (mean occupancy {sstats['occupancy_mean']:.2f}); "
              f"{sstats['forward_retraces']} width bucket(s), "
              f"{sstats['exchange_runs']} halo exchange run(s)")
        by_uid = {r.uid: r for r in results}
        same = all(r.predictions == by_uid[r.uid].predictions
                   for r in slot_results if r.uid in by_uid)
        print(f"slot predictions match the wave run: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
