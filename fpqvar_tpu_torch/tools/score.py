"""Metric scoring CLI: IS, FID, sFID, precision and recall of a sample set
against a reference set (``openai_evaluator.py:26-59``).

The port's ``scripts/score.py``, with its flags.  The Inception features
come from ``eval/inception.py`` on the card, so no external TF step is
needed.  Each input is one of:

- a PNG folder (as ``tools/evaluate.py`` writes it),
- an image npz (``arr_0``, uint8 [N, H, W, 3], the reference's
  ``pack_figs`` schema), or
- a feature npz (``features`` [N, D], optional ``spatial`` and
  ``probs``): the reference's two-process design still works.

Weights: ``--inception`` names a ``pt_inception-2015-12-05`` (or
torchvision ``inception_v3``) ``.pth`` state dict, read as tensors only
and converted; ``--inception random`` takes seeded random weights (seed 0:
metric values are then meaningless, but the whole path runs).  Runs on
``cuda`` unless ``--device cpu``.

    python -m fpqvar_tpu_torch.tools.score ref.npz figs_w4a4 \\
        --inception pt_inception-2015-12-05.pth --json-out scores.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def load_images(path):
    """[N, H, W, 3] uint8 of a PNG folder or an image npz, else None."""
    if os.path.isdir(path):
        from fpqvar_tpu_torch.eval.imaging import read_png_folder

        return read_png_folder(path)
    with np.load(path) as d:
        return d["arr_0"] if "arr_0" in d else None


def load_or_extract(path, params, batch):
    """(features, spatial, probs) of a folder / image npz / feature npz."""
    if not os.path.isdir(path):
        with np.load(path) as d:
            if "features" in d:
                return (d["features"],
                        d["spatial"] if "spatial" in d else None,
                        d["probs"] if "probs" in d else None)
    imgs = load_images(path)
    if imgs is None:
        raise SystemExit(f"{path}: not a folder, image npz, or feature npz")
    if params is None:
        raise SystemExit(
            f"{path} holds images - pass --inception WEIGHTS (or 'random') "
            "to extract features")
    from fpqvar_tpu_torch.eval.inception import extract_features_batched

    # NHWC uint8 -> NCHW; the division by 255 runs on the device
    return extract_features_batched(params, imgs.transpose(0, 3, 1, 2),
                                    batch=batch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ref", help="reference: folder / image npz / feature npz")
    p.add_argument("sample", help="sample: folder / image npz / feature npz")
    p.add_argument("--inception", type=str, default=None,
                   help=".pth state dict (pt_inception-2015-12-05 or "
                        "torchvision inception_v3), or 'random' for a "
                        "pipeline smoke run")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--save-features", type=str, default=None,
                   help="write the sample features to this npz")
    p.add_argument("--json-out", type=str, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from fpqvar_tpu_torch.eval.inception import load_inception_params
    from fpqvar_tpu_torch.eval.metrics import evaluate_all

    params = None
    if args.inception:
        if args.inception == "random":
            print("[warn] random Inception weights - smoke mode, metric "
                  "values are meaningless", file=sys.stderr)
        params = load_inception_params(args.inception, args.device)

    ref_f, ref_s, _ = load_or_extract(args.ref, params, args.batch)
    sam_f, sam_s, sam_p = load_or_extract(args.sample, params, args.batch)
    if args.save_features:
        np.savez(args.save_features, features=sam_f,
                 **({"spatial": sam_s} if sam_s is not None else {}),
                 **({"probs": sam_p} if sam_p is not None else {}))
    out = evaluate_all(ref_f, sam_f, ref_s, sam_s, sam_p, device=args.device)
    for k, v in out.items():
        print(f"{k}: {v:.4f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
