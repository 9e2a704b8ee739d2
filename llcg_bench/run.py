"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m llcg_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (data and weights from the seed, the program's objects, the rounds
the check reads) is timed from the start of this process; then rounds run
back to back for ``--seconds``; then the reference decides ``correct``.
The last line of standard output is the result; the numbers compared, with
their limits, are the last lines of standard error.  The run fails, and
prints no result, without a CUDA card, or if JAX or the JAX package was
loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# every kernel and compiler cache inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(_ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(_ROOT / "build" / "torch_extensions"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from llcg_bench import harness
    man = harness.manifest()
    cell = harness.find_cell(args.workload, man)
    chips = {w["name"]: w for w in man["workloads"]}[cell.name]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the configurations compute in float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    drv = harness.driver(cell)
    out = drv.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    correct, checks = harness.decide(out["readings"], cell.limits)
    if args.trace:
        ctx = out["ctx"]
        metrics = {}
        for m in cell.per_layer:
            value = harness.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = drv.end_to_end(out)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["rounds"], "failed": 0,
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = out["ctx"].get("busy_s")
        device["window_s"] = out["ctx"].get("window_s")
        if "breakdown" in out["ctx"]:
            result["breakdown"] = out["ctx"]["breakdown"]
    result["facts"] = dict(out.get("facts", {}), readings=out["readings"],
                           end_to_end=drv.end_to_end(out))
    harness.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
