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
