"""Baseline-method comparison study CLI.

The port's ``scripts/baseline_study.py``, with its flags: the data behind
the reference's ``search/baseline/`` motivation studies as JSON tables.
Per block of one layer kind: the per-channel absmax statistics of the
captured activations, each baseline's reconstruction MSE, and the
rotation-aware matmul-MSE sweep (plain against block or full Hadamard).
Inputs: a calibration store (written by ``tools/calibrate.py`` or by the
JAX package's ``scripts/calibrate.py``; the layouts are the same) and the
model weights (an upstream checkpoint, or a seeded random init in smoke
mode).  Runs on ``cuda`` unless ``--device cpu``.

    python -m fpqvar_tpu_torch.tools.baseline_study --depth 16 \\
        --calib calib --kind fc1 --blocks 0:4 --out baseline_study.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from fpqvar_tpu_torch.quantize import baselines as B
from fpqvar_tpu_torch.quantize.calibration import CalibrationStore
from fpqvar_tpu_torch.tools._common import (add_model_flags, model_config,
                                            var_params)


def block_report(store, weights, kind, blk, args, rng) -> dict:
    steps = store.steps(kind, blk)
    x = np.concatenate([store.load(kind, blk, s).reshape(-1, weights.shape[-1])
                        for s in range(steps)], axis=0)
    if x.shape[0] > args.max_samples:
        x = x[rng.choice(x.shape[0], args.max_samples, replace=False)]
    absmax_c = np.abs(x).max(axis=0)
    return {
        "block_idx": blk,
        # the per-channel activation absmax distribution (the outlier
        # statistics the reference plots)
        "act_absmax": {
            "max": float(absmax_c.max()),
            "median": float(np.median(absmax_c)),
            "p99_over_median": float(np.percentile(absmax_c, 99)
                                     / max(np.median(absmax_c), 1e-9)),
        },
        "reconstruction_mse": B.compare_baselines(x, n_bits=args.bits,
                                                  device=args.device),
        "rotation_aware_matmul_mse": B.rotation_aware_sweep(
            x, weights[blk], n_bits=args.bits,
            block_rotate=not args.full_rotation, device=args.device),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(p, default_depth=30)
    p.add_argument("--var-ckpt", type=str, default=None)
    p.add_argument("--calib", type=str, required=True)
    p.add_argument("--kind", type=str, default="fc1",
                   choices=["mat_qkv", "proj", "fc1", "fc2"])
    p.add_argument("--bits", type=int, default=4, choices=[4, 6])
    p.add_argument("--blocks", type=str, default=None,
                   help="range a:b (default: all)")
    p.add_argument("--max-samples", type=int, default=1024)
    p.add_argument("--full-rotation", action="store_true",
                   help="full-size Hadamard instead of block-diagonal")
    p.add_argument("--out", type=str, default="baseline_study.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = model_config(args)
    var_p = var_params(args, cfg, args.device)
    weights = var_p["blocks"][f"{args.kind}_w"].float().cpu().numpy()
    store = CalibrationStore(args.calib)
    rng = np.random.default_rng(0)
    if args.blocks:
        a, b = args.blocks.split(":")
        blocks = range(int(a), int(b))
    else:
        blocks = range(cfg.depth)

    report = []
    for blk in blocks:
        entry = block_report(store, weights, args.kind, blk, args, rng)
        report.append(entry)
        print(json.dumps({"block": blk, "act_p99/med":
                          entry["act_absmax"]["p99_over_median"]}),
              flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
