"""VAR training CLI: train steps, auto-resume and the data index stream.

The port's ``scripts/train.py``, with its flags.  Data: an npz with arrays
``label`` [N], ``x`` [N, L - first_l, Cvae] (the teacher-forcing input,
``models/vqvae.py`` ``idxBl_to_var_input``) and ``targets`` [N, L];
without ``--data`` a synthetic dataset is drawn from ``--seed`` (smoke
mode: the repository ships no ImageNet tokens).  The learning rate follows
the reference's warmup + cosine shape (optax's
``warmup_cosine_decay_schedule`` with the JAX CLI's numbers).  Train
states are saved under ``<out>/ckpt`` every ``--save-every`` steps and at
the last, and a run resumes from the newest there; metrics go to
``<out>/metrics.jsonl``.  Each step's label dropout draws from a generator
seeded by ``--seed`` and the step, so a resumed run takes the steps an
uninterrupted one would.  Runs on ``cuda`` unless ``--device cpu``.  One
process and one device: the data- and tensor-parallel flags raise
``NotImplementedError`` until the port's distributed layer exists.

    python -m fpqvar_tpu_torch.tools.train --depth 16 --steps 100 \\
        --bf16 --out runs/d16
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from fpqvar_tpu_torch.config import VARConfig
from fpqvar_tpu_torch.models.var import init_var_params
from fpqvar_tpu_torch.tools._common import add_model_flags, model_config
from fpqvar_tpu_torch.train import (auto_resume, dist_infinite_batches,
                                    make_manager, make_train_state,
                                    save_train_state, train_step)
from fpqvar_tpu_torch.train.trainer import make_optimizer, warmup_cosine_decay
from fpqvar_tpu_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(p, default_depth=16)
    p.add_argument("--data", type=str, default=None, help="npz dataset path")
    p.add_argument("--synthetic-n", type=int, default=64)
    p.add_argument("--glb-batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.05)
    p.add_argument("--warmup-frac", type=float, default=0.005)
    p.add_argument("--label-smooth", type=float, default=0.0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 forward off f32 master params")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations on the "
                        "backward pass (torch.utils.checkpoint)")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--out", type=str, required=True, help="run directory")
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_data(args, cfg: VARConfig):
    """(label, x, targets) as host arrays: the npz's, or a synthetic set
    drawn from ``args.seed`` as the JAX CLI draws it."""
    if args.data:
        d = np.load(args.data)
        label, x, targets = d["label"], d["x"], d["targets"]
    else:
        print("[warn] synthetic dataset (smoke mode)", file=sys.stderr)
        rng = np.random.default_rng(args.seed)
        n = args.synthetic_n
        label = rng.integers(0, cfg.num_classes, n).astype(np.int32)
        x = rng.normal(size=(n, cfg.L - cfg.first_l,
                             cfg.vae.z_channels)).astype(np.float32)
        targets = rng.integers(0, cfg.vae.vocab_size,
                               (n, cfg.L)).astype(np.int32)
    if x.shape[1] != cfg.L - cfg.first_l or targets.shape[1] != cfg.L:
        raise ValueError(f"data of {x.shape[1]} input and {targets.shape[1]}"
                         f" target tokens a row; the model takes "
                         f"{cfg.L - cfg.first_l} and {cfg.L}")
    return label, x, targets


def main(argv=None):
    args = parse_args(argv)
    if args.dp > 1 or args.tp > 1 or args.coordinator or args.num_hosts > 1:
        raise NotImplementedError(
            "data / tensor parallelism and multi-host runs are not ported "
            "yet (ROADMAP.md section 1, item 8: distributed); run with "
            "--dp 1 --tp 1 and no --coordinator")
    device = torch.device(args.device)
    cfg = model_config(args)
    label, x, targets = load_data(args, cfg)

    sched = warmup_cosine_decay(
        init_value=0.005 * args.lr, peak_value=args.lr,
        warmup_steps=max(1, round(args.warmup_frac * args.steps)),
        decay_steps=args.steps, end_value=0.001 * args.lr)
    optimizer = make_optimizer(wd=args.wd, schedule=sched)
    state = make_train_state(
        init_var_params(cfg, seed=args.seed, device=device), optimizer)

    mngr = make_manager(os.path.join(args.out, "ckpt"), max_to_keep=args.keep)
    info, state, start = auto_resume(mngr, state)
    print("\n".join(info))

    # resume the index stream at exactly the (epoch, iter) position step
    # `start` left off at
    iters_per_ep = -(-len(label) // args.glb_batch)
    batches = dist_infinite_batches(
        1, 0, len(label), args.glb_batch, seed=args.seed, fill_last=True,
        start_ep=start // iters_per_ep, start_it=start % iters_per_ep)
    logger = MetricLogger(os.path.join(args.out, "metrics.jsonl"))
    drop_gen = torch.Generator(device=device)
    t0 = time.time()
    for it in range(start, args.steps):
        idx = next(batches)
        batch = {"label": torch.from_numpy(label[idx]).long().to(device),
                 "x": torch.from_numpy(x[idx]).to(device),
                 "targets": torch.from_numpy(targets[idx]).long().to(device)}
        drop_gen.manual_seed(args.seed + 1 + it)
        state, metrics = train_step(
            state, cfg, optimizer, batch, generator=drop_gen,
            mixed_precision=args.bf16, label_smoothing=args.label_smooth,
            remat=args.remat)
        if (it + 1) % args.log_every == 0 or it + 1 == args.steps:
            loss = float(metrics["loss"])
            logger.update(step=it + 1, loss=loss, lr=sched(it),
                          imgs_per_s=args.glb_batch * args.log_every
                          / max(time.time() - t0, 1e-9))
            print(f"step {it + 1}/{args.steps} {logger}")
            t0 = time.time()
        if (it + 1) % args.save_every == 0 or it + 1 == args.steps:
            save_train_state(mngr, state)
    print(f"done: {args.steps} steps, ckpts in {args.out}/ckpt")


if __name__ == "__main__":
    main()
