"""Readings for setting a cell's limits: several seeds of one cell in one
process, each a whole run (weights, capture, a short window, the check),
with the control's readings beside the program's.

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--out FILE]

Prints one JSON line a seed: the seed, the compared numbers (the
program's and the control's), ``correct`` and the end-to-end metrics.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import cells
    from benchmark.run import run

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    bench = cells.load_benchmark()
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        out = run(bench, args.workload, seed, args.seconds, bool(args.trace),
                  "cuda", t, control=True)
        rec = {"seed": seed, "correct": out["correct"],
               "check": {k: v["value"] for k, v in out["check"].items()},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "device": out["device"], "wall_s": time.time() - t}
        if "breakdown" in out:
            rec["breakdown"] = out["breakdown"]
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
