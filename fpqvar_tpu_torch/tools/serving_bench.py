"""Serving latency / throughput benchmark of the continuous-batching server.

Drives :class:`fpqvar_tpu_torch.serving.GenerationServer` with three load
shapes and prints per-request latency percentiles and throughput as one
JSON line:

- unloaded: sequential requests, one in flight: the p50 is the floor a
  single user sees;
- saturated: an open-loop burst of ``--n`` requests: the server coalesces
  batches of ``--max-batch`` and runs its depth-2 pipeline; the p99 is
  queueing and batching delay under full load, and the throughput is the
  serving rate;
- poisson: ``--poisson`` requests with exponential inter-arrival times at
  ``--util`` times the measured saturated rate and uniformly random
  classes, the arrival process of a deployment; with 500 or more requests
  the p99 is a real quantile, not the run's maximum.  A request's latency
  runs from its intended arrival to the time its future completed, stamped
  by a done-callback; the latencies are read only once every callback has
  stamped its request.  Unlike the JAX package's bench, which seeds the
  trace with ``salt & 0xFFFF`` and so gives each recipe another trace, the
  port draws the gaps and classes from one fixed seed
  (:data:`POISSON_SEED`): every recipe of every run replays the same
  arrivals, scaled to its own saturated rate.

Every phase's per-request samples are in the JSON.  Params are built on the
device by ``synth_device_params`` (seeded init and the float32 device
transform), and requests carry seeds salted per process, so that no two
runs ask for the same images.  The generator runs fused (CUDA graphs, the
engine's default).  Needs a CUDA device unless ``--device cpu`` (a CPU run
measures the CPU, not the card).

    python -m fpqvar_tpu_torch.tools.serving_bench --preset d16 \\
        --recipes int8,bf16 --n 64 --poisson 500
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from fpqvar_tpu_torch.config import (GenerateConfig, VARConfig,
                                     bench_recipes, paper_recipes, var_d16,
                                     var_d30, var_d36_512, var_tiny)
from fpqvar_tpu_torch.models import VARGenerator, init_vqvae_params
from fpqvar_tpu_torch.quantize import synth_device_params
from fpqvar_tpu_torch.serving import GenerationServer


PRESETS = {"tiny": var_tiny, "d16": var_d16, "d30": var_d30,
           "d36": var_d36_512}
#: the seed of the Poisson phase's arrival gaps and classes
POISSON_SEED = 0


def recipes() -> dict:
    """The recipes the bench takes by name: ``bench_recipes`` and
    ``paper_recipes``."""
    return {**bench_recipes(), **paper_recipes()}


def _require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU (which measures the CPU, not the card)")
    return dev


def run_recipe(cfg: VARConfig, qcfg, vae, salt: int, *, n: int = 64,
               poisson: int = 0, util: float = 0.8, max_batch: int = 8,
               max_wait_ms: float = 30.0, unloaded: int = 8,
               device="cuda") -> dict:
    """One recipe through a fresh server on ``device``: warm-up, then the
    unloaded, saturated and (``poisson > 0``) Poisson phases.  Returns the
    phase results (milliseconds and images per second, unrounded)."""
    dev = _require_device(device)
    galt = None
    if qcfg.transform:
        galt = tuple(np.ones((cfg.depth, cfg.width), np.float32)
                     for _ in range(2))
    params = synth_device_params(cfg, qcfg, seed=0, galt=galt, device=dev)
    gen = VARGenerator(cfg, qcfg, GenerateConfig(), device=dev)
    server = GenerationServer(gen, params, vae, max_batch=max_batch,
                              max_wait_ms=max_wait_ms)
    try:
        # warm-up outside the timed phases: one lone request, one full batch
        server.submit(0, salt).result()
        for f in [server.submit(i % cfg.num_classes, salt + 1000 + i)
                  for i in range(max_batch)]:
            f.result()

        lat_unloaded = []
        for i in range(unloaded):
            t0 = time.perf_counter()
            server.submit(i % cfg.num_classes, salt + 2000 + i).result()
            lat_unloaded.append(time.perf_counter() - t0)

        st0 = server.stats()          # burst-only counters below
        t0 = time.perf_counter()
        subs = [(time.perf_counter(),
                 server.submit(i % cfg.num_classes, salt + 4000 + i))
                for i in range(n)]
        lat_sat = []
        for ts, fut in subs:
            fut.result()
            lat_sat.append(time.perf_counter() - ts)
        wall = time.perf_counter() - t0
        st = server.stats()

        lat_poi, poi = [], {}
        if poisson:
            rng = np.random.default_rng(POISSON_SEED)
            rate = util * (n / wall)                 # requests/s
            gaps = rng.exponential(1.0 / rate, size=poisson)
            classes = rng.integers(0, cfg.num_classes, size=poisson)
            done_at = [None] * poisson
            stamped = threading.Semaphore(0)

            def _stamp(i):
                # runs on the server's worker once set_result has woken the
                # waiters, so the completion time is right though results
                # are read in order, and may come after result() returned
                def cb(_):
                    done_at[i] = time.perf_counter()
                    stamped.release()
                return cb

            t0 = time.perf_counter()
            subs, t_next = [], t0
            for i in range(poisson):
                t_next += gaps[i]
                dt = t_next - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
                # the latency clock starts at the intended arrival time: a
                # submit loop that falls behind charges its delay to the
                # requests it held back (no coordinated omission)
                fut = server.submit(int(classes[i]), salt + 8000 + i)
                fut.add_done_callback(_stamp(i))
                subs.append((t_next, fut))
            for _, fut in subs:
                fut.result()
            poi_wall = time.perf_counter() - t0
            for _ in range(poisson):       # every completion time is stamped
                stamped.acquire()
            lat_poi = [done_at[i] - subs[i][0] for i in range(poisson)]
            poi = {"target_rate": rate,
                   "achieved_imgs_per_s": poisson / poi_wall}
    finally:
        server.stop()

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q)) * 1e3

    def dist(xs):
        return {"p50": pct(xs, 50), "p90": pct(xs, 90), "p99": pct(xs, 99),
                "mean": float(np.mean(xs)) * 1e3,
                "max": float(np.max(xs)) * 1e3,
                "samples_ms": [v * 1e3 for v in xs]}

    out = {
        "unloaded_ms": ({"p50": pct(lat_unloaded, 50),
                         "p90": pct(lat_unloaded, 90)} if lat_unloaded
                        else {}),
        "saturated_ms": dist(lat_sat),
        "saturated_imgs_per_s": n / wall,
        # burst-only deltas: the warm-up and unloaded requests would make
        # n / batches understate the coalesced batch size
        "batches": st["batches"] - st0["batches"],
        "pipelined": st["pipelined"] - st0["pipelined"],
    }
    if lat_poi:
        out["poisson_ms"] = dist(lat_poi)
        out["poisson"] = poi
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="d16", choices=sorted(PRESETS))
    ap.add_argument("--recipes", default="bf16,int8",
                    help="comma list of config.bench_recipes or "
                         "config.paper_recipes names, all measured in one "
                         "process")
    ap.add_argument("--n", type=int, default=64,
                    help="saturation-burst request count")
    ap.add_argument("--poisson", type=int, default=0,
                    help="Poisson-arrival phase request count (0 = skip); "
                         ">=500 makes the p99 a real quantile")
    ap.add_argument("--util", type=float, default=0.8,
                    help="Poisson arrival rate as a fraction of the "
                         "measured saturated rate")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=30.0)
    ap.add_argument("--unloaded", type=int, default=8,
                    help="sequential single-request probes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]()
    dev = _require_device(args.device)
    vae = init_vqvae_params(cfg.vae, seed=1, device=dev)
    salt = int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF
    results = {}
    for recipe in args.recipes.split(","):
        results[recipe] = run_recipe(
            cfg, recipes()[recipe], vae, salt, n=args.n,
            poisson=args.poisson, util=args.util, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, unloaded=args.unloaded,
            device=dev)
        brief = {k: ({kk: vv for kk, vv in v.items() if kk != "samples_ms"}
                     if isinstance(v, dict) else v)
                 for k, v in results[recipe].items()}
        print(f"# {recipe}: {brief}", file=sys.stderr, flush=True)
        salt += 100000
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(json.dumps({"preset": args.preset, "max_batch": args.max_batch,
                      "n": args.n, "device": kind, "recipes": results}))


if __name__ == "__main__":
    main()
