"""Checkpoint conversion CLI: upstream torch .pth -> npz, with optional
offline quantization (fold GALT -> rotate -> quantize/pack).

The port's ``scripts/convert_checkpoint.py``, with its flags.  The
transformed (optionally packed) checkpoint is persisted once and loaded
with ``utils/checkpoint.load_params``; the npz is the JAX package's
layout.  Without ``--var-ckpt`` a seeded random init stands in (smoke
mode).  Runs on ``cuda`` unless ``--device cpu``.

    python -m fpqvar_tpu_torch.tools.convert_checkpoint --depth 16 \\
        --var-ckpt var_d16.pth --quant --backend int8 --rotate \\
        --block_rotate --transform --best-s-dir best_s --out d16_int8.npz
"""
from __future__ import annotations

import argparse

from fpqvar_tpu_torch.config import QuantConfig
from fpqvar_tpu_torch.quantize import galt as G
from fpqvar_tpu_torch.quantize import quantize_var_params
from fpqvar_tpu_torch.quantize.recipe import to_bf16
from fpqvar_tpu_torch.tools._common import (add_model_flags, model_config,
                                            var_params)
from fpqvar_tpu_torch.utils import checkpoint as C


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(p, default_depth=30)
    p.add_argument("--var-ckpt", type=str, default=None,
                   help="upstream torch .pth; omitted -> random init "
                        "(smoke-test mode)")
    p.add_argument("--vae-ckpt", type=str, default=None)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--vae-out", type=str, default=None)
    p.add_argument("--quant", action="store_true")
    p.add_argument("--backend", type=str, default="packed",
                   choices=["fake", "packed", "int8"])
    p.add_argument("--w_bit", type=int, default=4)
    p.add_argument("--weight_fp_type", type=str, default="fp_e2")
    p.add_argument("--rotate", action="store_true")
    p.add_argument("--block_rotate", action="store_true")
    p.add_argument("--transform", action="store_true")
    p.add_argument("--best-s-dir", type=str, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16-cast unquantized f32 leaves even for plain "
                        "(no-transform) conversions")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = model_config(args)
    var_p = var_params(args, cfg, args.device,
                       "[warn] no --var-ckpt - random init (smoke-test mode)")
    transform = args.quant or args.rotate or args.transform
    # bf16-cast the float32 leaves BEFORE the transform, as JAX's CLI does:
    # quantize_var_params keeps the dtype of the leaves it does not
    # quantize.  Plain conversions stay float32 (lossless) unless --bf16.
    if args.bf16 or transform:
        var_p = to_bf16(var_p)
    if transform:
        qcfg = QuantConfig(
            enabled=args.quant, w_bit=args.w_bit,
            weight_format=args.weight_fp_type, backend=args.backend,
            rotate=args.rotate, block_rotate=args.block_rotate,
            transform=args.transform)
        galt = (G.load_best_s_pair(args.best_s_dir, args.w_bit)
                if args.transform else None)
        var_p = quantize_var_params(var_p, cfg, qcfg, galt=galt)

    C.save_params(args.out, var_p)
    print(f"wrote {args.out}")
    if args.vae_ckpt:
        vae_p = C.convert_vqvae_state_dict(
            C.load_torch_state_dict(args.vae_ckpt), cfg.vae, args.device)
        vae_out = args.vae_out or args.out.replace(".npz", "_vae.npz")
        C.save_params(vae_out, vae_p)
        print(f"wrote {vae_out}")


if __name__ == "__main__":
    main()
