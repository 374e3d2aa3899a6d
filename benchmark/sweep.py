"""The serving knee: one served cell's traffic at several fixed rates in one
process, to find once the highest rate the server sustains.

    python -m benchmark.sweep --workload d30-fp4kv6-serve \\
        --rates 14,18,22 --seconds 20 --seed 1

For each rate it prints one JSON line: the rate offered, the requests due
in the window, those completed by the window's end and their rate, the
backlog left at the end, and the 50th / 95th latency percentiles (ms,
each request from its due time).  The cell's traffic file then fixes the
rate as a number; nothing here runs in a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from benchmark import cells, program, traffic
    from benchmark.run import ServeDriver

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    spec = cells.config(bench, cell["config"])
    mix = traffic.load(cell["traffic"])
    prog = program.build(spec, args.seed, "cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        drv = ServeDriver(prog, spec, dict(mix, rate=rate), args.seed,
                          "cuda")
        drv.warm()
        drv.window(args.seconds, None)
        due = np.asarray(drv.due)
        lat = np.asarray(drv.lat) / 1e3
        done = int(((due + lat) <= args.seconds).sum())
        print(json.dumps({
            "rate": rate, "due": len(due), "completed": done,
            "completed_per_s": done / args.seconds,
            "backlog_at_end": len(due) - done,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "failed": drv.failed, "server": drv.stats}), flush=True)
    prog.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
