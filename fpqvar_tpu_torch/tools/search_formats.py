"""FP-format search CLI: the per-block (weight, activation) format grid
search over calibration data, writing
``optimal_quantization_formats_<kind>.json``.

The port's ``scripts/search_formats.py``, with its flags: ``--kind ada``
searches the AdaLN condition input over ``--labels`` class embeddings (a
shared-AdaLN model has one ``shared_ada_lin``, so one entry).  Without
``--var-ckpt`` a seeded random init stands in (smoke mode).  Runs on
``cuda`` unless ``--device cpu``.

    python -m fpqvar_tpu_torch.tools.search_formats --depth 16 \\
        --var-ckpt var_d16.pth --calib calib --kind fc1 --out fc1.json
"""
from __future__ import annotations

import argparse

import numpy as np

from fpqvar_tpu_torch.quantize import search as S
from fpqvar_tpu_torch.quantize.calibration import (CalibrationStore,
                                                   capture_condition)
from fpqvar_tpu_torch.tools._common import (add_model_flags, model_config,
                                            var_params)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_flags(p, default_depth=30)
    p.add_argument("--var-ckpt", type=str, default=None)
    p.add_argument("--calib", type=str, required=True)
    p.add_argument("--kind", type=str, default="fc1",
                   choices=["mat_qkv", "proj", "fc1", "fc2", "ada"])
    p.add_argument("--labels", type=int, default=100,
                   help="ada kind: number of class labels for the "
                        "condition-activation search")
    p.add_argument("--bits", type=int, default=4, choices=[4, 6])
    p.add_argument("--max-samples", type=int, default=1000)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = model_config(args)
    var_p = var_params(args, cfg, args.device)
    space = S.FP4_SPACE if args.bits == 4 else S.FP6_SPACE
    if args.kind == "ada":
        cond = capture_condition(var_p, cfg, np.arange(args.labels))
        if cfg.shared_aln:
            # one shared_ada_lin (the blocks' ada_gss has no linear)
            ada_w = var_p["shared_ada_lin"]["w"][None]
        else:
            ada_w = var_p["blocks"]["ada_lin"]["w"]
        results = S.search_ada_formats(cond, ada_w, space=space,
                                       device=args.device)
    else:
        results = S.search_formats(
            CalibrationStore(args.calib), var_p["blocks"][f"{args.kind}_w"],
            args.kind, space=space, max_samples=args.max_samples,
            device=args.device)
    out = args.out or f"optimal_quantization_formats_{args.kind}.json"
    S.save_formats_json(out, results)
    print(f"wrote {out}")
    for r in results:
        print(r)


if __name__ == "__main__":
    main()
