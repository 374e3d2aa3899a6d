"""Shared CLI plumbing: model-shape flags, VARConfig construction and the
VAR params of a CLI.

Every model-building CLI takes the published shapes via ``--depth`` /
``--resolution``, plus ``--tiny``, which selects
``fpqvar_tpu_torch.config.var_tiny`` so that the whole CLI surface runs in
seconds on the CPU.
"""
from __future__ import annotations

import argparse
import sys

from fpqvar_tpu_torch.config import (PATCH_NUMS_256, PATCH_NUMS_512,
                                     VARConfig, VQVAEConfig, var_tiny)


def add_model_flags(p: argparse.ArgumentParser, default_depth: int = 30):
    p.add_argument("--depth", type=int, default=default_depth,
                   help="transformer depth (width/heads derive from it)")
    p.add_argument("--resolution", type=int, default=256, choices=[256, 512])
    p.add_argument("--tiny", action="store_true",
                   help="depth-2 6x6 smoke config (ignores "
                        "--depth/--resolution)")


def model_config(args) -> VARConfig:
    if args.tiny:
        return var_tiny()
    pns = PATCH_NUMS_512 if args.resolution == 512 else PATCH_NUMS_256
    return VARConfig(depth=args.depth, shared_aln=(args.resolution == 512),
                     patch_nums=pns, vae=VQVAEConfig(patch_nums=pns))


def var_params(args, cfg: VARConfig, device,
               warning: str = "[warn] random init (smoke-test mode)"):
    """The VAR tree of ``args.var_ckpt`` (an upstream torch checkpoint),
    or without one a random init from seed 0, after ``warning`` on
    stderr."""
    from fpqvar_tpu_torch.models.var import init_var_params
    from fpqvar_tpu_torch.utils import checkpoint as C

    if args.var_ckpt:
        return C.convert_var_state_dict(
            C.load_torch_state_dict(args.var_ckpt), cfg, device)
    print(warning, file=sys.stderr)
    return init_var_params(cfg, seed=0, device=device)


def add_dist_backend_flag(p: argparse.ArgumentParser):
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of a multi-process run "
                        "(default nccl on cuda, gloo on cpu; gloo lets "
                        "two ranks share one card)")


def init_distributed(args):
    """Join the process group of a multi-process run and return
    ``(rank, world, device)``: from ``--coordinator host:port`` with
    ``--num-hosts`` ranks (this one ``--host-id``), as JAX's
    ``jax.distributed.initialize``, or from ``torchrun``'s environment
    (``env://``, when ``WORLD_SIZE`` > 1).  A single process returns
    ``(0, 1, args.device)`` and joins nothing.  On a card, rank r takes
    card ``LOCAL_RANK % device_count`` (``host_id`` without torchrun), so
    ranks on one card share it."""
    import os

    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.coordinator is None and world <= 1:
        return 0, 1, torch.device(args.device)
    device = torch.device(args.device)
    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    if args.coordinator is not None:
        dist.init_process_group(backend,
                                init_method=f"tcp://{args.coordinator}",
                                world_size=args.num_hosts,
                                rank=args.host_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return rank, world, device
