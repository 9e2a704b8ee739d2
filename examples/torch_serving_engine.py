"""Serving-engine example in the PyTorch port: a mixed queue of requests
through the length-bucketed wave scheduler, on the GPU unless
``--device`` names another.

The port's counterpart of ``examples/serving_engine.py``: the same smoke
rwkv6 config, queue and sampling (greedy and temperature), through
``repro_torch.serving.engine``.

Run:  PYTHONPATH=src python examples/torch_serving_engine.py [--device cpu]
"""
import argparse
import sys

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    dev = ap.parse_args(argv).device
    cfg = get_smoke_config("rwkv6-1.6b")   # constant-state decode
    engine = ServingEngine(cfg, batch_size=4, max_seq=96, seed=0, device=dev)

    rng = np.random.default_rng(0)
    for i in range(10):
        plen = int(rng.choice([8, 8, 16, 24]))
        engine.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
            max_new_tokens=int(rng.integers(4, 12)),
            temperature=0.0 if i % 2 == 0 else 0.8,
        ))

    results = engine.run()
    print(f"served {len(results)} requests in {engine.stats()['waves']} waves "
          f"(batch={engine.batch_size}, length-bucketed, {dev})\n")
    for r in sorted(results, key=lambda r: r.uid):
        print(f"  req {r.uid:2d} prompt={r.prompt_len:2d} tok "
              f"generated={len(r.tokens):2d} wave={r.wave} "
              f"-> {r.tokens[:8]}{'…' if len(r.tokens) > 8 else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
