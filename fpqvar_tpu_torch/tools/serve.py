"""Generation server CLI: continuous batching of class-conditional requests.

The port's ``scripts/serve.py``, with its flags, plus ``--device`` (default
``cuda``).  Requests are lines of ``"<class_id> [seed]"`` on stdin, or
``--demo N`` requests ``(i % num_classes, i)``; each image is written to
``--out`` as ``class{c}_img{seed}.png``.  The server is
``serving.GenerationServer`` over a fused ``VARGenerator`` (CUDA graphs on
a card).  Without checkpoints the trees are ``models.build_vae_var(0,
...)`` (smoke mode).  ``--recipe`` quantizes with ``quantize_var_params``;
``w4a4`` / ``w6a6`` apply GALT from ``--best-s-dir`` unless
``--no-transform``; ``--backend`` overrides the recipe's backend (``w4a4
--no-transform --backend int8`` runs kernels K1 and K5, ``--backend
packed`` K2)::

    python -m fpqvar_tpu_torch.tools.serve --tiny --device cpu \\
        --recipe w4a16 --demo 2 --max-batch 2 --out served
"""
from __future__ import annotations

import argparse
import os
import sys

from fpqvar_tpu_torch.tools._common import add_model_flags, model_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(p, default_depth=16)
    p.add_argument("--vae-ckpt", type=str, default=None)
    p.add_argument("--var-ckpt", type=str, default=None)
    p.add_argument("--packed-ckpt", type=str, default=None)
    p.add_argument("--recipe", type=str, default="bf16",
                   choices=["bf16", "w4a4", "w4a16", "w6a6"],
                   help="bf16 = unquantized; w4a16 = weights-only int8-code "
                        "deployment mode; w4a4/w6a6 = the paper's full "
                        "recipes (GALT folded offline or disabled via "
                        "--no-transform)")
    p.add_argument("--backend", type=str, default=None,
                   choices=["fake", "packed", "int8"],
                   help="override the recipe's execution backend")
    p.add_argument("--no-transform", action="store_true",
                   help="drop GALT from w4a4/w6a6 (no best_s artifacts)")
    p.add_argument("--best-s-dir", type=str, default=None,
                   help="GALT best_s artifact dir (required by w4a4/w6a6 "
                        "unless --no-transform)")
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=50.0)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--demo", type=int, default=0,
                   help="submit N demo requests instead of reading stdin")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def recipe(args):
    """The ``QuantConfig`` of ``--recipe`` with ``--no-transform`` and
    ``--backend`` applied."""
    from fpqvar_tpu_torch.config import (QuantConfig, fpqvar_w4a4,
                                         fpqvar_w4a16, fpqvar_w6a6)

    qcfg = {"bf16": QuantConfig, "w4a4": fpqvar_w4a4, "w4a16": fpqvar_w4a16,
            "w6a6": fpqvar_w6a6}[args.recipe]()
    if args.no_transform and qcfg.enabled:
        qcfg = qcfg.replace(transform=False)
    if args.backend is not None and qcfg.enabled:
        qcfg = qcfg.replace(backend=args.backend)
    return qcfg


def load_trees(args, cfg, qcfg):
    """(VAR tree, VQVAE tree) on ``args.device``, each from its checkpoint
    or from ``build_vae_var(0, ...)``; the VAR tree quantized under
    ``qcfg`` unless it is a ``--packed-ckpt`` (already transformed)."""
    from fpqvar_tpu_torch.models import build_vae_var
    from fpqvar_tpu_torch.utils import checkpoint as C

    dev = args.device
    rand_vae = rand_var = None
    if not (args.vae_ckpt and (args.packed_ckpt or args.var_ckpt)):
        rand_vae, rand_var = build_vae_var(0, cfg, dev)
    if args.vae_ckpt:
        vae_p = C.convert_vqvae_state_dict(
            C.load_torch_state_dict(args.vae_ckpt), cfg.vae, dev)
    else:
        print("[warn] random-init VQVAE (smoke-test mode)", file=sys.stderr)
        vae_p = rand_vae
    if args.packed_ckpt:
        return C.load_params(args.packed_ckpt, dev), vae_p
    if args.var_ckpt:
        var_p = C.convert_var_state_dict(
            C.load_torch_state_dict(args.var_ckpt), cfg, dev)
    else:
        print("[warn] random-init VAR (smoke-test mode)", file=sys.stderr)
        var_p = rand_var
    if qcfg.enabled:
        from fpqvar_tpu_torch.quantize import galt as G
        from fpqvar_tpu_torch.quantize import quantize_var_params

        galt = None
        if qcfg.transform:
            if args.best_s_dir is None:
                raise SystemExit(f"--recipe {args.recipe} applies GALT: "
                                 "pass --best-s-dir or --no-transform")
            try:
                galt = G.load_best_s_pair(args.best_s_dir, qcfg.w_bit)
            except FileNotFoundError as e:
                raise SystemExit(str(e))
        var_p = quantize_var_params(var_p, cfg, qcfg, galt=galt)
    return var_p, vae_p


def requests(args, num_classes: int):
    """``(class_id, seed)`` pairs: ``--demo N`` or stdin's lines."""
    if args.demo:
        for i in range(args.demo):
            yield i % num_classes, i
        return
    for line in sys.stdin:
        parts = line.split()
        if parts:
            yield int(parts[0]), int(parts[1]) if len(parts) > 1 else 0


def main(argv=None):
    args = parse_args(argv)
    from fpqvar_tpu_torch.config import GenerateConfig
    from fpqvar_tpu_torch.eval.imaging import save_images_png
    from fpqvar_tpu_torch.models import VARGenerator
    from fpqvar_tpu_torch.serving import GenerationServer

    cfg = model_config(args)
    qcfg = recipe(args)
    var_p, vae_p = load_trees(args, cfg, qcfg)
    gen = VARGenerator(cfg, qcfg, GenerateConfig(), device=args.device)
    server = GenerationServer(gen, var_p, vae_p, max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms)
    os.makedirs(args.out, exist_ok=True)
    try:
        futs = [(ci, seed, server.submit(ci, seed))
                for ci, seed in requests(args, cfg.num_classes)]
        for ci, seed, fut in futs:
            save_images_png(fut.result()[None], args.out, ci,
                            start_idx=seed)
        st = server.stats()
    finally:
        server.stop()
    print(f"served {len(futs)} requests in {st['batches']} batches "
          f"({st['pipelined']} pipelined) -> {args.out}")
    return st


if __name__ == "__main__":
    main()
