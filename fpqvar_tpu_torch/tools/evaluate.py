"""Quantize-and-generate evaluation CLI: the eval set as PNGs.

The port's ``scripts/evaluate.py``, with its flags, names and defaults:
one entry point for the reference's eight ``evaluate*.py`` scripts (flags
of ``run.sh:4-25``), model size and resolution as flags.  Checkpoints:
``--var-ckpt`` / ``--vae-ckpt`` (upstream torch ``.pth``, read as tensors
only), ``--packed-ckpt`` (a quantized npz of ``convert_checkpoint``), GALT
vectors from ``--best-s-dir`` (npz or the reference's ``.pt``); without a
checkpoint a seeded random init stands in (smoke mode).  Generation runs
through the engine's fused mode (CUDA graphs), JAX's default.  Without
``--classes`` or a process group, the classes split across hosts with
``--host-id`` / ``--num-hosts``; ``--pack-npz`` packs the PNGs into
``<out>.npz`` at the end.  Runs on ``cuda`` unless
``--device cpu``.

Distributed runs, one process a rank: ``--coordinator host:port`` joins
``--num-hosts`` processes (this one ``--host-id``) as JAX's
``jax.distributed.initialize``; ``torchrun`` sets the same through its
environment.  ``--dp`` / ``--tp`` build the ``{dp, tp}`` mesh over those
ranks (``dp * tp`` of them), shard the tree and generate through the eager
loop (the fused mode is not ported under a mesh); rank 0 writes the PNGs.
Without a mesh each rank generates its ``class_range_for_host`` share of
the classes (of ``--classes`` when given, else of all), and rank 0 packs
the whole set.  The backend is NCCL on cards and gloo on the CPU
(``--dist-backend gloo`` lets two ranks share one card):

    torchrun --nproc-per-node 2 -m fpqvar_tpu_torch.tools.evaluate \
        --tiny --device cpu --tp 2 --out figs_tp2 --classes 0:2

    # the full FPQVAR W4A4 recipe on the int8 backend, VAR-d16
    python -m fpqvar_tpu_torch.tools.evaluate --depth 16 --quant \\
        --w_bit 4 --a_bit 4 --weight_quant per_group --act_quant per_group \\
        --activation_fp_quant --weight_fp_quant --act_fp_type fp_e2 \\
        --weight_fp_type fp_e2 --fc2_fp_type fp_e1m2_neg_e2m1_pos \\
        --rotate --block_rotate --transform --best-s-dir best_s/ \\
        --backend int8 --vae-ckpt vae.pth --var-ckpt d16.pth --out figs_w4a4
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from fpqvar_tpu_torch.config import GenerateConfig, QuantConfig
from fpqvar_tpu_torch.tools._common import (add_dist_backend_flag,
                                            add_model_flags,
                                            init_distributed, model_config,
                                            var_params)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(p, default_depth=30)
    p.add_argument("--vae-ckpt", type=str, default=None)
    p.add_argument("--var-ckpt", type=str, default=None)
    p.add_argument("--packed-ckpt", type=str, default=None,
                   help="pre-quantized npz checkpoint (skips transform)")
    # the reference's flags (evaluate_fp_quant_transform_rotate.py:27-52)
    p.add_argument("--w_bit", type=int, default=32)
    p.add_argument("--a_bit", type=int, default=32)
    p.add_argument("--kv_bit", type=int, default=0)
    p.add_argument("--groupsize", type=int, default=128)
    p.add_argument("--act_sym", action="store_true")
    p.add_argument("--weight_quant", type=str, default="per_channel")
    p.add_argument("--act_quant", type=str, default="per_token")
    p.add_argument("--quant", action="store_true")
    p.add_argument("--fc2_act_log2_quant", action="store_true")
    p.add_argument("--quant_kv", action="store_true")
    p.add_argument("--activation_fp_quant", action="store_true")
    p.add_argument("--weight_fp_quant", action="store_true")
    p.add_argument("--act_fp_type", type=str, default="fp_e2")
    p.add_argument("--weight_fp_type", type=str, default="fp_e2")
    p.add_argument("--fc2_fp_type", type=str, default="fp_e1m2_neg_e2m1_pos")
    p.add_argument("--rotate", action="store_true")
    p.add_argument("--block_rotate", action="store_true")
    p.add_argument("--transform", action="store_true")
    p.add_argument("--best-s-dir", type=str, default=None)
    p.add_argument("--quantize_ada", action="store_true",
                   help="quantize ada_lin/shared_ada_lin (the reference "
                        "intends this but silently no-ops it)")
    p.add_argument("--ada_fp_type", type=str, default="auto")
    # backend / generation
    p.add_argument("--backend", type=str, default="fake",
                   choices=["fake", "packed", "int8"])
    p.add_argument("--kv_backend", type=str, default="fake",
                   choices=["fake", "packed"])
    p.add_argument("--attn_int8", action="store_true",
                   help="int8 attention over packed KV codes (requires "
                        "--kv_backend packed)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--num-img-per-class", type=int, default=50)
    p.add_argument("--classes", type=str, default=None,
                   help="range as a:b (default all)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg", type=float, default=1.5)
    p.add_argument("--top_k", type=int, default=900)
    p.add_argument("--top_p", type=float, default=0.96)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks of the mesh (eager loop)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks of the mesh (eager loop)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of a multi-host run's coordinator "
                        "(tcp:// rendezvous of --num-hosts processes)")
    add_dist_backend_flag(p)
    p.add_argument("--pack-npz", action="store_true",
                   help="pack PNGs to npz when generation finishes")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_configs(args):
    cfg = model_config(args)
    qcfg = QuantConfig(
        enabled=args.quant,
        w_bit=args.w_bit, a_bit=args.a_bit,
        kv_bit=args.kv_bit if args.quant_kv else 0,
        group_size=args.groupsize,
        weight_quant=args.weight_quant, act_quant=args.act_quant,
        act_sym=args.act_sym,
        weight_format=args.weight_fp_type, act_format=args.act_fp_type,
        fc2_format=args.fc2_fp_type, fc2_log2=args.fc2_act_log2_quant,
        int_quant=args.quant and not (
            args.activation_fp_quant or args.weight_fp_quant),
        rotate=args.rotate, block_rotate=args.block_rotate,
        transform=args.transform, backend=args.backend,
        kv_backend=args.kv_backend, attn_int8=args.attn_int8,
        quantize_ada=args.quantize_ada, ada_format=args.ada_fp_type,
    )
    gen = GenerateConfig(cfg=args.cfg, top_k=args.top_k, top_p=args.top_p,
                         seed=args.seed)
    return cfg, qcfg, gen


def load_galt(args):
    from fpqvar_tpu_torch.quantize import galt as G

    if not args.transform:
        return None
    if args.best_s_dir is None:
        raise SystemExit("--transform requires --best-s-dir")
    try:
        return G.load_best_s_pair(args.best_s_dir, args.w_bit)
    except FileNotFoundError as e:
        raise SystemExit(str(e))


def load_trees(args, cfg, qcfg):
    """(VAR tree, VQVAE tree) on ``args.device``: the checkpoints, bf16,
    quantized under ``qcfg`` with the GALT vectors (or the packed npz as it
    is), or seeded random trees with a warning (smoke mode)."""
    from fpqvar_tpu_torch.models.vqvae import init_vqvae_params
    from fpqvar_tpu_torch.quantize import quantize_var_params
    from fpqvar_tpu_torch.quantize.recipe import to_bf16
    from fpqvar_tpu_torch.utils import checkpoint as C

    dev = args.device
    if args.vae_ckpt:
        vae_p = C.convert_vqvae_state_dict(
            C.load_torch_state_dict(args.vae_ckpt), cfg.vae, dev)
    else:
        print("[warn] no --vae-ckpt - random-init VQVAE (smoke-test mode)",
              file=sys.stderr)
        vae_p = init_vqvae_params(cfg.vae, seed=1, device=dev)
    if args.packed_ckpt:
        return C.load_params(args.packed_ckpt, dev), vae_p
    var_p = to_bf16(var_params(
        args, cfg, dev,
        "[warn] no --var-ckpt - random-init VAR (smoke-test mode)"))
    return quantize_var_params(var_p, cfg, qcfg, galt=load_galt(args)), vae_p


def main(argv=None):
    args = parse_args(argv)
    from fpqvar_tpu_torch.config import MeshConfig
    from fpqvar_tpu_torch.eval.pipeline import (class_range_for_host,
                                                generate_eval_set)
    from fpqvar_tpu_torch.models import VARGenerator
    from fpqvar_tpu_torch.parallel import make_mesh, shard_params

    rank, world, device = init_distributed(args)
    args.device = str(device)
    mesh = None
    if args.dp * args.tp > 1:
        mesh = make_mesh(MeshConfig(dp=args.dp, tp=args.tp), device)
    cfg, qcfg, gen_cfg = build_configs(args)
    var_p, vae_p = load_trees(args, cfg, qcfg)
    if mesh is not None:
        var_p = shard_params(var_p, mesh)

    # the model config (the reference logs the module repr,
    # evaluate...py:133-136)
    os.makedirs(args.out, exist_ok=True)
    if rank == 0:
        with open(os.path.join(args.out, "config.json"), "w") as f:
            json.dump({"model": vars(args), "L": cfg.L,
                       "width": cfg.width}, f, indent=2, default=str)

    generator = VARGenerator(cfg, qcfg, gen_cfg, device=device, mesh=mesh,
                             fuse_steps=mesh is None)
    if args.classes:
        a, b = args.classes.split(":")
        every = range(int(a), int(b))
    elif world > 1:
        every = range(cfg.num_classes)
    else:
        every = class_range_for_host(cfg.num_classes, args.host_id,
                                     args.num_hosts)
    classes = every
    if mesh is None and world > 1:
        # each rank of a distributed run without a mesh is one host: the
        # classes split once, by rank
        share = class_range_for_host(len(every), rank, world)
        classes = every[share.start:share.stop]
    batch = args.batch or args.num_img_per_class
    cuda = generator.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(generator.device)
    t0 = time.perf_counter()
    runs = generate_eval_set(
        generator, var_p, vae_p, args.out,
        num_img_per_class=args.num_img_per_class, classes=classes,
        seed=args.seed, batch=args.batch, mesh=mesh)
    secs = time.perf_counter() - t0
    line = {"generations": runs, "batch": batch, "seconds": secs,
            "ms_per_image": secs * 1e3 / max(runs * batch, 1)}
    if cuda:
        line.update(generator.capture_stats(batch))
        line["peak_bytes"] = torch.cuda.max_memory_allocated(generator.device)
    print("evaluate: " + json.dumps(line), flush=True)

    if world > 1:
        dist.barrier()      # every rank's PNGs are on disk
    if args.pack_npz and rank == 0:
        from fpqvar_tpu_torch.eval.imaging import create_npz_from_sample_folder

        npz = create_npz_from_sample_folder(
            args.out, expected=len(every) * args.num_img_per_class)
        print(f"packed: {npz}")
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
