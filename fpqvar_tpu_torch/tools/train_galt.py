"""GALT training CLI: one smoothing vector per block for ``mat_qkv`` or
``fc1`` from a calibration store, written as ``best_s`` npz (the
``{kind}_best_s_fp{bits}.npz`` that ``galt.load_best_s_pair`` reads).

The port's ``scripts/train_galt.py``, with its flags.  Without
``--var-ckpt`` a seeded random init stands in (smoke mode).  Runs on
``cuda`` unless ``--device cpu``.

    python -m fpqvar_tpu_torch.tools.train_galt --depth 16 \\
        --var-ckpt var_d16.pth --calib calib --kind fc1 \\
        --out best_s/fc1_best_s_fp4.npz
"""
from __future__ import annotations

import argparse

from fpqvar_tpu_torch.quantize import galt as G
from fpqvar_tpu_torch.quantize.calibration import CalibrationStore
from fpqvar_tpu_torch.tools._common import (add_model_flags, model_config,
                                            var_params)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(p, default_depth=30)
    p.add_argument("--var-ckpt", type=str, default=None)
    p.add_argument("--calib", type=str, required=True)
    p.add_argument("--kind", type=str, default="fc1",
                   choices=["mat_qkv", "fc1"])
    p.add_argument("--bits", type=int, default=4, choices=[4, 6])
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--max-samples-per-step", type=int, default=256)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = model_config(args)
    var_p = var_params(args, cfg, args.device)
    best_s = G.train_galt(
        CalibrationStore(args.calib), var_p["blocks"][f"{args.kind}_w"],
        args.kind, w_bit=args.bits, epochs=args.epochs, lr=args.lr,
        max_samples_per_step=args.max_samples_per_step, device=args.device)
    G.save_best_s(args.out, best_s)
    print(f"wrote {args.out}: shape {best_s.shape}")


if __name__ == "__main__":
    main()
