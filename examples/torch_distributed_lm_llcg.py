"""End-to-end example in the PyTorch port: LLCG pre-training of a reduced
architecture, on the GPU unless ``--device`` names another.

The port's counterpart of ``examples/distributed_lm_llcg.py``, with the same
flags: the host's devices form the LLCG machines, local shards are
heterogeneous Markov-mixture corpora (the κ²_X analogue of cut edges —
Section 4.1), and each round runs K·ρ^r local steps + parameter averaging +
S server-correction steps on a globally mixed batch
(:func:`repro_torch.launch.train.train`).

Run:  PYTHONPATH=src python examples/torch_distributed_lm_llcg.py \\
          [--rounds 8] [--device cpu]
"""
import argparse
import sys

from repro_torch.launch.train import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--base-k", type=int, default=2)
    ap.add_argument("--rho", type=float, default=1.3)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-group", type=int, default=4)
    ap.add_argument("--heterogeneity", type=float, default=0.6)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = TrainConfig(arch=args.arch, smoke=True, rounds=args.rounds,
                      base_k=args.base_k, rho=args.rho,
                      seq_len=args.seq_len,
                      batch_per_group=args.batch_per_group,
                      heterogeneity=args.heterogeneity,
                      ckpt_dir=args.ckpt_dir)
    _, metrics = train(cfg, device=args.device)
    for h in metrics["history"]:
        print(f"round {h['round']:2d} K={h['k']:3d} "
              f"local_loss={h['local_loss']:.4f} "
              f"corr_loss={h['corr_loss']:.4f} comm={h['comm_mb']:.1f}MB")
    print("done: the correction loss tracking the local loss is the "
          "paper's residual-error elimination at work.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
