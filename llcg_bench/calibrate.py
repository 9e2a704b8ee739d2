"""The readings that limits are set from, at the cell's own size, many
seeds in one process (set-up is long):

    python3 -m llcg_bench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control] [--fault <name>] [--seconds 2]

Without ``--control`` the program runs each seed as a benchmark run does
(a short window) and its readings are printed; ``--control`` prints the
control's (the reference in TF32 in the program's place); ``--fault``
plants faults of ``llcg_bench.faults.FAULTS`` under the program (a comma
list, ``None`` for another run as it stands), each after one run as it
stands and from the same set-up (the driver's ``calibrate``).  One JSON
line a run.  The benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from llcg_bench import harness
    from llcg_bench.drivers import common
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(args.workload)
    drv = harness.driver(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.control:
            res = drv.control(cell, seed, args.device)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": True, **res,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        else:
            # one set-up a seed: the program as it stands, then each fault
            names = [None] + [None if f == "None" else f for f in
                              (args.fault.split(",") if args.fault else [])]
            for res in drv.calibrate(cell, seed, args.device, args.seconds,
                                     names):
                print(json.dumps({"workload": cell.name, "seed": seed,
                                  **res}), flush=True)
        common.free(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
