"""Plan-composition walkthrough in the PyTorch port: strategies the flat
config could not say, on the GPU unless ``--device`` names another.

The port's counterpart of ``examples/plan_compositions.py`` (whose
docstring explains each composition at length): the same graph, model,
configuration and compositions through ``repro_torch``.

1. **Correction every m rounds** — LLCG with the server correction on
   every 2nd round only.
2. **Hybrid halo→LLCG** — exact GGS rounds for R₀ rounds, then LLCG.
3. **Schedule-driven switching** — ``when(r, k)`` sees the round's
   scheduled K·ρ^r steps: halo rounds while K < 8, local rounds after.
4. **train → checkpoint → serve** — ``GNNServingEngine.from_plan``
   restores the newest round's params with the plan's own partition.
5. **Sampler placement & overlap** — ``SamplerSpec(placement="device")``
   draws each round on the device, overlapped with the previous round.
6. **Aggregation layouts** — ``ServerSpec(agg_layout="csr")`` runs the
   correction's full-neighbor forward edge-centrically.
7. **Compressed communication** — ``CommSpec(compression="int8_ef")``:
   int8 deltas with error feedback, ~4× fewer bytes a round.
8. **Preemption-safe training** — ``TrainPlan(checkpoint=CheckpointSpec)``
   snapshots every round; a resumed run lands bit-identical to the
   uninterrupted one.

Run:  PYTHONPATH=src python examples/torch_plan_compositions.py [--device cpu]
"""
import argparse
import dataclasses
import sys
import tempfile

from repro_torch.core import (
    CheckpointSpec, DistConfig, ScheduleSpec, TrainPlan, averaging,
    build_trainer, correction, halo_exchange, llcg_plan, local_steps,
)
from repro_torch.graph import sbm_graph
from repro_torch.launch.train import resume
from repro_torch.models.gnn import build_model
from repro_torch.serving.gnn import GNNRequest, GNNServingEngine


def show(title, hist):
    kinds = "".join("H" if k == "ext" else "L"
                    for k in hist.meta["round_kinds"])
    print(f"{title:28s} rounds={kinds} final_F1={hist.final_score:.3f} "
          f"MB/round={hist.avg_mb_per_round():.3f} "
          f"corr_rounds={hist.meta['corr_rounds']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (default: "
                         "cuda)")
    dev = ap.parse_args(argv).device
    data = sbm_graph(num_nodes=480, num_classes=4, feature_dim=16,
                     feature_snr=0.15, homophily=0.95, avg_degree=14, seed=0)
    model = build_model("GG", data.feature_dim, data.num_classes,
                        hidden_dim=32)
    cfg = DistConfig(num_machines=4, rounds=8, local_k=4, batch_size=32,
                     server_batch_size=64, fanout=8, correction_steps=2,
                     partition_method="random", seed=0)
    specs = cfg.specs()

    def run(plan):
        return build_trainer(data, model, plan, device=dev).run()

    # 1 — server correction only every 2nd round
    show("correction-every-2", run(llcg_plan(cfg, correction_every=2)))

    # 2 — hybrid: 3 exact halo-exchange rounds, then LLCG rounds
    r0 = 3
    hybrid = TrainPlan(
        phases=(halo_exchange(first=r0),
                local_steps(after=r0), averaging(after=r0),
                correction(after=r0)),
        name="hybrid", seed=cfg.seed, **specs)
    show(f"hybrid halo(first={r0})→llcg", run(hybrid))

    # 3 — switching driven by the K·ρ^r schedule: halo while K < 8
    big = lambda r, k: k >= 8
    switch = TrainPlan(
        phases=(halo_exchange(when=lambda r, k: k < 8),
                local_steps(when=big), averaging(when=big),
                correction(when=big)),
        name="switch", seed=cfg.seed,
        **{**specs, "schedule": ScheduleSpec(rounds=6, rho=1.5)})
    show("switch k<8:halo else llcg", run(switch))

    # 5 — device-resident sampling, double-buffered against compute
    llcg = (local_steps(), averaging(), correction())
    on_dev = TrainPlan(phases=llcg, name="llcg-dev", seed=cfg.seed,
                       **{**specs, "sampler": dataclasses.replace(
                           specs["sampler"], placement="device")})
    show("llcg device+overlap", run(on_dev))

    # 6 — edge-centric correction: the padded default's trajectory
    csr = TrainPlan(phases=llcg, name="llcg-csr", seed=cfg.seed,
                    **{**specs, "server": dataclasses.replace(
                        specs["server"], agg_layout="csr")})
    show("llcg csr correction", run(csr))

    # 7 — compressed averaging: ~4x fewer bytes on the wire
    base = TrainPlan(phases=(local_steps(), averaging()),
                     name="psgd-f32", seed=cfg.seed, **specs)
    ef = dataclasses.replace(base, name="psgd-int8ef",
                             comm=dataclasses.replace(
                                 specs["comm"], compression="int8_ef"))
    h32, h8 = run(base), run(ef)
    print(f"{'int8_ef averaging':28s} "
          f"bytes={h8.bytes_cum[-1] / h32.bytes_cum[-1]:.2f}x of f32 "
          f"({h32.bytes_cum[-1] / h8.bytes_cum[-1]:.1f}x reduction) "
          f"loss f32={h32.train_loss[-1]:.4f} "
          f"int8_ef={h8.train_loss[-1]:.4f}")

    # 4 — the plan object closes the train→serve loop
    with tempfile.TemporaryDirectory() as ckpt:
        plan = llcg_plan(
            DistConfig(num_machines=4, rounds=3, local_k=4, batch_size=32,
                       fanout=8, partition_method="random", seed=0,
                       checkpoint_dir=ckpt),
            correction_every=2)
        run(plan)
        engine = GNNServingEngine.from_plan(plan, model, data, batch_size=8,
                                            device=dev)
        engine.submit(GNNRequest(uid=0, nodes=[0, 7, 42]))
        preds = engine.run()[0].predictions
        print(f"served from plan checkpoint: nodes [0, 7, 42] → "
              f"classes {list(map(int, preds))}")

    # 8 — preemption-safe training: checkpoint every round, then resume a
    # fresh trainer from round 6 and land where the uninterrupted run did
    with tempfile.TemporaryDirectory() as ck:
        full = dataclasses.replace(base, checkpoint=CheckpointSpec(
            dir=ck, every=1, keep=3))
        control = run(full)
        h = resume(data, model, full, step=6, device=dev)
        same = (h.final_score == control.final_score
                and h.bytes_cum == control.bytes_cum
                and h.train_loss == control.train_loss)
        print(f"{'resume from round 6 of 8':28s} bit-identical to "
              f"uninterrupted run: {same} (final_F1={h.final_score:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
