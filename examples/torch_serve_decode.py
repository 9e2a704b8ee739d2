"""Serving example in the PyTorch port: batched prefill + greedy decode
against a reduced architecture, on the GPU unless ``--device`` names
another.

The port's counterpart of ``examples/serve_decode.py``: prefill a batch of
prompts (building each layer's KV cache or recurrent state), then decode
N tokens per request one ``decode_step`` at a time.  The default,
h2o-danube-3-4b, is a sliding-window stack: each layer keeps a ring KV
cache of ``min(window, max_seq)`` slots.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py \\
          [--arch h2o-danube-3-4b] [--device cpu]
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer.model import LM


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if not cfg.supports_decode():
        print(f"{args.arch} is encoder-only — no decode path.")
        return 0
    max_seq = args.prompt_len + args.gen_tokens
    lm = LM(cfg)
    params = lm.init(0, args.device)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(args.device)
    batch = {"tokens": prompts}
    start = args.prompt_len              # the first decode position
    if cfg.frontend == "vision":         # random patches before the prompt
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(
                np.float32)).to(args.device)
        max_seq += cfg.num_prefix_tokens
        start += cfg.num_prefix_tokens
    sync = torch.cuda.synchronize if params["embed"].is_cuda else \
        (lambda: None)

    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen_tokens} device={args.device}")
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, states = lm.prefill(params, batch, max_seq=max_seq)
        sync()
        print(f"prefill: {time.perf_counter() - t0:.2f}s "
              f"(logits {tuple(logits.shape)})")
        tok = logits.argmax(-1)
        generated = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen_tokens - 1):
            logits, states = lm.decode_step(params, states, tok,
                                            start + i,
                                            max_seq=max_seq)
            tok = logits.argmax(-1)
            generated.append(tok)
        sync()
        dt = time.perf_counter() - t0
    out = torch.stack(generated, dim=1).cpu().numpy()
    print(f"decode: {args.gen_tokens - 1} steps in {dt:.2f}s "
          f"({(args.gen_tokens - 1) * args.batch / max(dt, 1e-9):.1f} tok/s "
          f"on {args.device})")
    for b in range(min(args.batch, 2)):
        print(f"  request {b}: {out[b].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
