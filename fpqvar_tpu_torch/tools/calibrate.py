"""Calibration capture CLI: ``--num-classes`` labels, one image each,
through the unquantized model, storing the per-(layer, block, step) inputs
and ``condition.npz`` (SiLU of the class embeddings) under ``--out``.

The port's ``scripts/calibrate.py``, with its flags.  Without both
checkpoints a seeded random init stands in (smoke mode).  Each batch of
labels samples from a generator seeded by ``(--seed, first label)``.
Runs on ``cuda`` unless ``--device cpu``.

    python -m fpqvar_tpu_torch.tools.calibrate --depth 16 \\
        --var-ckpt var_d16.pth --vae-ckpt vae_ch160v4096z32.pth --out calib
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from fpqvar_tpu_torch.models.var import init_var_params
from fpqvar_tpu_torch.models.vqvae import init_vqvae_params
from fpqvar_tpu_torch.quantize.calibration import (CalibrationStore,
                                                   capture_condition,
                                                   capture_generation)
from fpqvar_tpu_torch.tools._common import add_model_flags, model_config
from fpqvar_tpu_torch.utils import checkpoint as C


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(p, default_depth=30)
    p.add_argument("--vae-ckpt", type=str, default=None)
    p.add_argument("--var-ckpt", type=str, default=None)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--num-classes", type=int, default=100,
                   help="calibration label count (reference cali_data_size)")
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = model_config(args)
    if args.vae_ckpt and args.var_ckpt:
        vae_p = C.convert_vqvae_state_dict(
            C.load_torch_state_dict(args.vae_ckpt), cfg.vae, args.device)
        var_p = C.convert_var_state_dict(
            C.load_torch_state_dict(args.var_ckpt), cfg, args.device)
    else:
        print("[warn] random init (smoke-test mode)", file=sys.stderr)
        vae_p = init_vqvae_params(cfg.vae, seed=1, device=args.device)
        var_p = init_var_params(cfg, seed=0, device=args.device)

    store = CalibrationStore(args.out)
    gen = torch.Generator(device=args.device)
    for start in range(0, args.num_classes, args.batch):
        labels = list(range(start, min(start + args.batch, args.num_classes)))
        gen.manual_seed(int(np.random.SeedSequence(
            [args.seed, start]).generate_state(1)[0]))
        store.append_run(capture_generation(var_p, vae_p, cfg, labels, gen))
        print(f"captured classes {start}..{labels[-1]}", flush=True)
    np.savez_compressed(
        os.path.join(args.out, "condition.npz"),
        cond=capture_condition(var_p, cfg, np.arange(args.num_classes)))


if __name__ == "__main__":
    main()
