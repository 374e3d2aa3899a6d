"""Motivation-study figures (the reference's ``search/baseline/plot_*.py``).

The port's ``scripts/motivation_plots.py``, with its flags and JSON keys,
plus ``--device`` (default ``cuda``).  Three studies, computed live from a
calibration store (``tools/calibrate.py``'s ``CalibrationStore``) or from
the weights (``--var-ckpt``, an upstream torch checkpoint, or a seeded
random init in smoke mode):

- ``--plot mse --tensor act``: per-block activation reconstruction MSE per
  FP format (``--bits 4|6``), over at most ``--max-samples`` rows of the
  store's taps; ``--rotate`` measures it in the block-Hadamard-rotated
  domain; ``--kind fc2`` adds the dual-grid formats (AFPQ, DFQ,
  neg-reverse).
- ``--plot mse --tensor weight``: per-block weight MSE per format.
- ``--plot clip``: fc2-style clipping sweep, MSE against the unclipped
  tensor as the clamp at ``strength * absmax`` tightens, per format.
- ``--plot dist``: one block's weight histogram with the INT4 and FP4-E2M1
  per-tensor levels, and both per-tensor MSEs.

Each study writes its JSON (``--out``, or JAX's default name) and, where
matplotlib imports, the PNG beside it::

    python -m fpqvar_tpu_torch.tools.motivation_plots --plot mse \\
        --tensor act --calib calib/ --depth 16 --kind fc2 --rotate
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

# validated categorical palette (fixed assignment order, CVD-checked)
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
          "#008300", "#4a3aa7", "#e34948"]
MARKERS = ["o", "^", "D", "s", "*", "v", "P", "X"]


def _formats(kind: str, bits: int):
    """(label -> quantize fn) in the reference's plotting order."""
    from fpqvar_tpu_torch.ops import quantizers as Q

    gran = dict(granularity="per_group", group_size=128)
    if bits == 6:
        fmts = {
            "INT6": lambda x: Q.fake_quant_int_sym(x, n_bits=6, **gran),
            "E2M3": lambda x: Q.fake_quant_fp(x, "fp6_e2m3", **gran),
            "E3M2": lambda x: Q.fake_quant_fp(x, "fp6_e3m2", **gran),
        }
        if kind == "fc2":
            fmts["INT-neg/E2M3-pos"] = lambda x: Q.fake_quant_dual(
                x, "fp6_int_neg_e2m3_pos", **gran)
        return fmts
    fmts = {
        "E1M2 / INT4": lambda x: Q.fake_quant_fp(x, "fp_e1", **gran),
        "E2M1": lambda x: Q.fake_quant_fp(x, "fp_e2", **gran),
        "E3M0": lambda x: Q.fake_quant_fp(x, "fp_e3", **gran),
    }
    if kind == "fc2":
        fmts["AFPQ"] = lambda x: Q.fake_quant_dual(x, "fp4_afpq", **gran)
        fmts["DFQ"] = lambda x: Q.fake_quant_dual(
            x, "fp_e1m2_neg_e2m1_pos", **gran)
        fmts["NegReverse"] = lambda x: Q.fake_quant_neg_reverse(
            x, group_size=128)
    return fmts


def _clip_formats(xc):
    from fpqvar_tpu_torch.ops import quantizers as Q

    gran = dict(granularity="per_group", group_size=128)
    return {
        "DFQ": Q.fake_quant_dual(xc, "fp_e1m2_neg_e2m1_pos", **gran),
        "AFPQ": Q.fake_quant_dual(xc, "fp4_afpq", **gran),
        "E2M1": Q.fake_quant_fp(xc, "fp_e2", **gran),
    }


def _load_model(args):
    from fpqvar_tpu_torch.config import (PATCH_NUMS_256, PATCH_NUMS_512,
                                         VARConfig, VQVAEConfig)
    from fpqvar_tpu_torch.models.var import init_var_params
    from fpqvar_tpu_torch.utils import checkpoint as C

    pns = PATCH_NUMS_512 if args.resolution == 512 else PATCH_NUMS_256
    cfg = VARConfig(depth=args.depth, shared_aln=(args.resolution == 512),
                    patch_nums=pns, vae=VQVAEConfig(patch_nums=pns))
    if args.var_ckpt:
        var_p = C.convert_var_state_dict(
            C.load_torch_state_dict(args.var_ckpt), cfg, args.device)
    else:
        print("[warn] random init (smoke-test mode)", file=sys.stderr)
        var_p = init_var_params(cfg, seed=0, device=args.device)
    return cfg, var_p


def _block_rotation(c: int, device, seed: int = 42) -> torch.Tensor:
    from fpqvar_tpu_torch.ops import hadamard as H

    qb = torch.as_tensor(H.block_hadamard_block(128, seed), dtype=torch.float32)
    return torch.kron(torch.eye(c // 128), qb).to(device)


def _store_rows(store, kind: str, blk: int, c_in: int, max_samples: int,
                rng) -> np.ndarray:
    """Every step's taps of one block as ``[rows, c_in]``, subsampled to
    ``max_samples`` rows with ``rng``'s draw."""
    x = np.concatenate([store.load(kind, blk, s).reshape(-1, c_in)
                        for s in range(store.steps(kind, blk))], axis=0)
    if x.shape[0] > max_samples:
        x = x[rng.choice(x.shape[0], max_samples, replace=False)]
    return x


def _mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.mean((a - b) ** 2))


def _have_matplotlib() -> bool:
    try:
        import matplotlib
    except ImportError:
        print("[warn] matplotlib does not import: JSON only",
              file=sys.stderr)
        return False
    matplotlib.use("Agg")
    return True


def _plot_lines(xs, curves, png, xlabel, ylabel):
    if not _have_matplotlib():
        return
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=150)
    for i, (name, ys) in enumerate(curves.items()):
        ax.plot(xs if xs is not None else range(len(ys)), ys, label=name,
                color=SERIES[i], linewidth=2, marker=MARKERS[i],
                markersize=5)
    ax.set_xlabel(xlabel, fontsize=12)
    ax.set_ylabel(ylabel, fontsize=12)
    ax.ticklabel_format(axis="y", style="sci", scilimits=(0, 0))
    ax.grid(True, alpha=0.25, linewidth=0.5)
    ax.spines[["top", "right"]].set_visible(False)
    ax.legend(fontsize=10, frameon=False)
    fig.tight_layout()
    fig.savefig(png, bbox_inches="tight")
    plt.close(fig)


def _write(out_json: str, data: dict) -> dict:
    with open(out_json, "w") as f:
        json.dump(data, f, indent=2)
    return data


@torch.inference_mode()
def mse_study(args) -> dict:
    from fpqvar_tpu_torch.quantize.calibration import CalibrationStore

    cfg, var_p = _load_model(args)
    weights = var_p["blocks"][f"{args.kind}_w"].to(torch.float32)
    c_in = weights.shape[-1]
    fmts = _formats(args.kind, args.bits)
    rot = _block_rotation(c_in, weights.device) if args.rotate else None
    rng = np.random.default_rng(0)

    curves = {name: [] for name in fmts}
    store = CalibrationStore(args.calib) if args.tensor == "act" else None
    for blk in range(cfg.depth):
        if store is not None:
            x = torch.as_tensor(_store_rows(store, args.kind, blk, c_in,
                                            args.max_samples, rng),
                                device=weights.device)
        else:
            x = weights[blk]
        if rot is not None:
            x = x @ rot  # MSE is measured in the rotated domain
        for name, fn in fmts.items():
            curves[name].append(_mse(x, fn(x)))
        print(f"block {blk}: " + ", ".join(
            f"{n}={curves[n][-1]:.3e}" for n in fmts), flush=True)

    means = {n: float(np.mean(v)) for n, v in curves.items()}
    print("per-format mean MSE:", json.dumps(means, indent=2))
    stem = (f"{args.tensor}_mse.{'rotate_' if args.rotate else ''}"
            f"{args.kind}")
    out_json = args.out or f"{stem}.json"
    data = _write(out_json, {"kind": args.kind, "tensor": args.tensor,
                             "bits": args.bits, "rotate": args.rotate,
                             "curves": curves, "means": means})
    _plot_lines(None, curves, os.path.splitext(out_json)[0] + ".png",
                "Block Index", "Quantization Error")
    print(f"wrote {out_json}")
    return data


@torch.inference_mode()
def clip_study(args) -> dict:
    """Clipping-strength sweep on the store's activations (the reference's
    ``search/fc2_quant.py`` clipping experiments): reconstruction MSE
    against the ORIGINAL tensor as the clamp at ``strength * absmax``
    tightens, per format, averaged over every sixth block."""
    from fpqvar_tpu_torch.quantize.calibration import CalibrationStore

    cfg, var_p = _load_model(args)
    dev = var_p["blocks"][f"{args.kind}_w"].device
    c_in = var_p["blocks"][f"{args.kind}_w"].shape[-1]
    store = CalibrationStore(args.calib)
    rng = np.random.default_rng(0)
    blocks = list(range(cfg.depth))[:: max(1, cfg.depth // 6)]
    strengths = [round(s, 2) for s in np.arange(0.5, 1.01, 0.05)]

    curves = {name: [0.0] * len(strengths) for name in ("DFQ", "AFPQ",
                                                        "E2M1")}
    for blk in blocks:
        x = torch.as_tensor(_store_rows(store, args.kind, blk, c_in,
                                        args.max_samples, rng), device=dev)
        amax = x.abs().max()
        for i, s in enumerate(strengths):
            xc = torch.clamp(x, -s * amax, s * amax)
            for name, q in _clip_formats(xc).items():
                curves[name][i] += _mse(x, q) / len(blocks)
    best = {n: strengths[int(np.argmin(v))] for n, v in curves.items()}
    print("argmin strength per format:", json.dumps(best))
    out_json = args.out or f"clip_mse.{args.kind}.json"
    data = _write(out_json, {"kind": args.kind, "strengths": strengths,
                             "curves": curves, "best": best,
                             "blocks_sampled": list(blocks)})
    _plot_lines(strengths, curves, os.path.splitext(out_json)[0] + ".png",
                "Clipping Strength", "Quantization Error")
    print(f"wrote {out_json}")
    return data


@torch.inference_mode()
def dist_study(args) -> dict:
    from fpqvar_tpu_torch.ops import grids as G
    from fpqvar_tpu_torch.ops import quantizers as Q

    cfg, var_p = _load_model(args)
    w = var_p["blocks"][f"{args.kind}_w"][args.block].to(torch.float32)
    wn = w.cpu().numpy()
    # per-tensor scales, as the reference's motivation figure uses
    # (`plot_weight_distribution_for_motivation.py:414-421`)
    int_scale = float(np.abs(wn).max()) / 7.0
    int_levels = [v * int_scale for v in range(-8, 8)]
    fp_grid = np.asarray(G.FP4_E2M1)
    fp_scale = float(np.abs(wn).max()) / float(np.abs(fp_grid).max())
    fp_levels = [float(v) * fp_scale for v in fp_grid]
    data = {"kind": args.kind, "block": args.block,
            "mse_int4_per_tensor": _mse(w, Q.fake_quant_int_sym(
                w, n_bits=4, granularity="per_tensor")),
            "mse_fp4_e2m1_per_tensor": _mse(w, Q.fake_quant_fp(
                w, "fp_e2", granularity="per_tensor"))}
    out = args.out or f"weight_distribution_{args.kind}_block{args.block}.png"
    _write(os.path.splitext(out)[0] + ".json", data)
    if _have_matplotlib():
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4.5), dpi=150)
        ax.hist(wn.flatten(), bins=100, alpha=0.75, color=SERIES[0])
        for i, lv in enumerate(int_levels):
            ax.axvline(x=lv, color=SERIES[7], linestyle="--", linewidth=1,
                       label="INT4 levels" if i == 0 else "")
        for i, lv in enumerate(fp_levels):
            ax.axvline(x=lv, color=SERIES[2], linestyle=":", linewidth=1.5,
                       label="FP4-E2M1 levels" if i == 0 else "")
        ax.set_xlabel("Weight Value", fontsize=12)
        ax.set_ylabel("Frequency", fontsize=12)
        ax.spines[["top", "right"]].set_visible(False)
        ax.legend(fontsize=10, frameon=False)
        fig.tight_layout()
        fig.savefig(out, bbox_inches="tight")
        plt.close(fig)
    print(json.dumps(data))
    print(f"wrote {out}")
    return data


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plot", choices=["mse", "dist", "clip"],
                   required=True)
    p.add_argument("--depth", type=int, default=30)
    p.add_argument("--resolution", type=int, default=256,
                   choices=[256, 512])
    p.add_argument("--var-ckpt", type=str, default=None)
    p.add_argument("--kind", type=str, default="mat_qkv",
                   choices=["mat_qkv", "proj", "fc1", "fc2"])
    p.add_argument("--tensor", choices=["act", "weight"], default="act")
    p.add_argument("--calib", type=str, default=None,
                   help="calibration store dir (required for --tensor act)")
    p.add_argument("--bits", type=int, default=4, choices=[4, 6])
    p.add_argument("--rotate", action="store_true",
                   help="block-Hadamard-rotate before quantizing "
                        "(the reference's rotate_* studies)")
    p.add_argument("--block", type=int, default=9,
                   help="block index for --plot dist (reference uses 9)")
    p.add_argument("--max-samples", type=int, default=1024)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ((args.plot == "clip" or
         (args.plot == "mse" and args.tensor == "act")) and not args.calib):
        p.error("this mode requires --calib")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    return {"mse": mse_study, "dist": dist_study, "clip": clip_study}[
        args.plot](args)


if __name__ == "__main__":
    main()
