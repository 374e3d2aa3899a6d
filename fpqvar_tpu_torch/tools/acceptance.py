"""One-command acceptance gate: checkpoints in, metric verdict out.

The port's ``scripts/acceptance.py``, with its flags, artifacts and
``ACCEPTANCE.json`` keys, plus ``--device`` (default ``cuda``).  It chains
the reference's acceptance choreography behind one command: calibration
capture (``evaluate.py:67-80``), GALT training
(``learnable_transformation_{mat_qkv,fc1}_fp4.py``), the 50k-image eval
set (``evaluate_fp_quant_transform_rotate.py:187-207``), npz packing
(``pack_figs.py:8-24``) and the OpenAI evaluator's metrics
(``openai_evaluator.py:26-59``), judged against the published table
(``TARGETS``; BASELINE.md: FP4 full recipe FID 3.58 / IS 241.5, dFID <=
+1.60 against FP16's 1.98)::

    python -m fpqvar_tpu_torch.tools.acceptance --var-ckpt var_d30.pth \\
        --vae-ckpt vae.pth --inception-ckpt pt_inception-2015-12-05.pth \\
        --ref-npz VIRTUAL_imagenet256_labeled.npz --recipe fp4 --out acc/

Every stage resumes from its artifact: the calibration store (all or
nothing, behind ``calib/CAPTURE_COMPLETE``), ``best_s/*_best_s_fp{bit}.npz``,
the per-class PNG sets, ``figs_<tag>.npz`` and ``features_<tag>.npz``.
``--with-fp16`` also generates and scores the bf16 set (the dFID / dIS
columns).  ``--tiny`` runs the whole chain at ``var_tiny`` with random
weights and a random Inception (smoke mode: the verdict is "every stage ran
and the metrics are finite"); ``--tiny --device cpu`` runs on the CPU.
``--dp`` / ``--tp`` generate on a ``{dp, tp}`` mesh of ``dp * tp`` ranks
(``torchrun``, the eager loop; ``--dist-backend``): rank 0 calibrates,
trains GALT, writes the PNGs and scores; every rank generates.  The exit
code is 0 only on a pass.

Recipes (``run.sh:4-25``'s flag sets): ``fp4`` (W4A4 e2m1 per-group-128
+ rotate + block_rotate + GALT + dual-grid fc2), ``fp4_kv6`` (+ 6-bit KV
cache), ``fp6`` (W6A6 e2m3 per-channel / per-token + rotate +
block_rotate), ``fp6_kv6``.  Each runs on the ``fake`` backend, as JAX's
does, so no kernel of the port runs on this path.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from fpqvar_tpu_torch.tools._common import (add_dist_backend_flag,
                                            init_distributed)

# BASELINE.md table (readme_figs/1.png): published numbers for each recipe
# plus the FP16 reference row the deltas are taken against.
TARGETS = {
    "fp16": {"fid": 1.98, "is": 302.0, "precision": 0.82, "recall": 0.60},
    "fp4": {"fid": 3.58, "is": 241.5, "precision": 0.77, "recall": 0.60},
    "fp4_kv6": {"fid": 3.64, "is": 241.3, "precision": 0.77, "recall": 0.60},
    "fp6": {"fid": 2.03, "is": 295.0, "precision": 0.80, "recall": 0.61},
    "fp6_kv6": {"fid": 2.00, "is": 296.8, "precision": 0.81, "recall": 0.61},
}


def recipe_config(name: str):
    from fpqvar_tpu_torch.config import QuantConfig

    fp4 = QuantConfig(
        enabled=True, w_bit=4, a_bit=4,
        weight_quant="per_group", act_quant="per_group", act_sym=True,
        weight_format="fp_e2", act_format="fp_e2",
        fc2_format="fp_e1m2_neg_e2m1_pos",
        rotate=True, block_rotate=True, transform=True)
    fp6 = QuantConfig(
        enabled=True, w_bit=6, a_bit=6,
        weight_quant="per_channel", act_quant="per_token", act_sym=True,
        weight_format="fp6_e2m3", act_format="fp6_e2m3",
        fc2_format="fp6_int_neg_e2m3_pos",
        rotate=True, block_rotate=True, transform=False)
    return {
        "fp4": fp4,
        "fp4_kv6": fp4.replace(kv_bit=6),
        "fp6": fp6,
        "fp6_kv6": fp6.replace(kv_bit=6),
    }[name]


def verdict(recipe: str, metrics: dict, fp16_metrics, *, ref_npz_given: bool,
            smoke: bool, fid_slack: float, is_slack: float,
            n_images: int, wall_s: float) -> dict:
    """The verdict of ``ACCEPTANCE.json`` (JAX's rules, ``scripts/
    acceptance.py:327-365``).  IS is always held to the published IS
    (``is_slack`` below it).  FID: against the published FID (+
    ``fid_slack``) when the reference set is ``--ref-npz``; when the
    reference is the fp16 set itself, against the published dFID budget.
    With fp16 metrics, the dFID to them is held to that budget too.  In
    smoke mode (random weights or Inception) the thresholds mean nothing
    and the only check is that every metric is finite."""
    tgt = TARGETS[recipe]
    dfid_budget = tgt["fid"] - TARGETS["fp16"]["fid"]
    checks = {
        "is_within_published": metrics["inception_score"]
        >= tgt["is"] * (1 - is_slack),
    }
    deltas = None
    if not ref_npz_given:
        checks["fid_vs_fp16_within_delta_budget"] = (
            metrics["fid"] <= dfid_budget + fid_slack)
    else:
        checks["fid_within_published"] = (
            metrics["fid"] <= tgt["fid"] + fid_slack)
    if fp16_metrics is not None:
        deltas = {
            "dfid": metrics["fid"] - fp16_metrics["fid"],
            "dfid_budget": dfid_budget,
            "dis": metrics["inception_score"]
            - fp16_metrics["inception_score"],
        }
        checks["dfid_within_budget"] = (
            deltas["dfid"] <= dfid_budget + fid_slack)
    out = {
        "recipe": recipe,
        "smoke_mode": smoke,
        "n_images": n_images,
        "metrics": {k: round(float(v), 4) for k, v in metrics.items()},
        "fp16_metrics": {k: round(float(v), 4)
                         for k, v in fp16_metrics.items()}
        if fp16_metrics else None,
        "deltas": {k: round(float(v), 4) for k, v in deltas.items()}
        if deltas else None,
        "published": tgt,
        "checks": checks,
        "pass": all(checks.values()),
        "wall_s": round(wall_s, 1),
    }
    if smoke:
        finite = all(np.isfinite(list(metrics.values())))
        out["checks"] = {"pipeline_finite_metrics": bool(finite)}
        out["pass"] = bool(finite)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recipe", default="fp4", choices=list(TARGETS)[1:])
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--resolution", type=int, default=256,
                    choices=[256, 512])
    ap.add_argument("--tiny", action="store_true",
                    help="depth-2 smoke config, random weights + random "
                         "Inception; exercises the full chain in minutes")
    ap.add_argument("--vae-ckpt", type=str, default=None)
    ap.add_argument("--var-ckpt", type=str, default=None)
    ap.add_argument("--inception-ckpt", type=str, default=None,
                    help="pt_inception-2015-12-05 .pth (or 'random')")
    ap.add_argument("--ref-npz", type=str, default=None,
                    help="VIRTUAL_imagenet256_labeled.npz (images or "
                         "features); default: score against the --with-fp16 "
                         "set (deltas only)")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--num-img-per-class", type=int, default=50)
    ap.add_argument("--classes", type=int, default=None,
                    help="restrict to the first N classes (debug runs)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--with-fp16", action="store_true",
                    help="also generate + score the bf16 set (dFID/dIS)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--galt-epochs", type=int, default=50)
    ap.add_argument("--calib-classes", type=int, default=100,
                    help="calibration label count (reference cali_data_size)")
    ap.add_argument("--fid-slack", type=float, default=0.5,
                    help="pass if FID <= published + this")
    ap.add_argument("--is-slack", type=float, default=0.05,
                    help="pass if IS >= published * (1 - this)")
    add_dist_backend_flag(ap)
    ap.add_argument("--device", default="cuda")
    # a mesh's ranks come from torchrun's environment only
    ap.set_defaults(coordinator=None, num_hosts=1, host_id=0)
    return ap.parse_args(argv)


def _calibrate_and_train_galt(args, cfg, qcfg, var_p, vae_p, stamp):
    """GALT vectors of ``best_s/`` (resumed), else a calibration capture
    (all or nothing) and GALT training of mat_qkv and fc1."""
    from fpqvar_tpu_torch.quantize import galt as G
    from fpqvar_tpu_torch.quantize.calibration import (CalibrationStore,
                                                       capture_generation)

    best_dir = os.path.join(args.out, "best_s")
    try:
        galt = G.load_best_s_pair(best_dir, qcfg.w_bit)
        stamp(f"GALT vectors found in {best_dir} (resume)")
        return galt
    except FileNotFoundError:
        pass
    calib_dir = os.path.join(args.out, "calib")
    done_marker = os.path.join(calib_dir, "CAPTURE_COMPLETE")
    if not os.path.exists(done_marker):
        # all-or-nothing: a partial capture (a crash mid-run) would train
        # GALT on a fraction of the calibration set, and append_run
        # concatenates, so resuming the loop would count rows twice
        if os.path.isdir(calib_dir):
            shutil.rmtree(calib_dir)
        store = CalibrationStore(calib_dir)
        stamp(f"calibration capture: {args.calib_classes} classes")
        labels = np.arange(args.calib_classes) % cfg.num_classes
        bs = min(10, args.calib_classes)
        gen = torch.Generator(device=args.device)
        for s in range(0, args.calib_classes, bs):
            gen.manual_seed(int(np.random.SeedSequence(
                [args.seed, s]).generate_state(1)[0]))
            store.append_run(capture_generation(
                var_p, vae_p, cfg, labels[s:s + bs].tolist(), gen))
        with open(done_marker, "w") as f:
            f.write(f"classes={args.calib_classes}\n")
    else:
        store = CalibrationStore(calib_dir)
        stamp("calibration capture complete (resume)")
    os.makedirs(best_dir, exist_ok=True)
    pair = []
    for kind in ("mat_qkv", "fc1"):
        stamp(f"GALT training: {kind} fp{qcfg.w_bit} "
              f"({args.galt_epochs} epochs)")
        w = var_p["blocks"][f"{kind}_w"].to(torch.float32).cpu().numpy()
        s = G.train_galt(store, w, kind, w_bit=qcfg.w_bit,
                         epochs=args.galt_epochs, device=args.device)
        G.save_best_s(os.path.join(
            best_dir, f"{kind}_best_s_fp{qcfg.w_bit}.npz"), s)
        pair.append(s)
    return tuple(pair)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from fpqvar_tpu_torch.config import (GenerateConfig, MeshConfig,
                                         QuantConfig, VARConfig,
                                         var_d36_512, var_tiny)
    from fpqvar_tpu_torch.eval.imaging import create_npz_from_sample_folder
    from fpqvar_tpu_torch.eval.inception import (extract_features_batched,
                                                 load_inception_params)
    from fpqvar_tpu_torch.eval.metrics import evaluate_all
    from fpqvar_tpu_torch.eval.pipeline import generate_eval_set
    from fpqvar_tpu_torch.models import VARGenerator, build_vae_var
    from fpqvar_tpu_torch.parallel import collectives as Coll
    from fpqvar_tpu_torch.parallel import make_mesh, shard_params
    from fpqvar_tpu_torch.quantize import quantize_var_params
    from fpqvar_tpu_torch.quantize.recipe import to_bf16
    from fpqvar_tpu_torch.utils import checkpoint as C

    t0 = time.time()
    rank, world, device = init_distributed(args)
    args.device = str(device)
    os.makedirs(args.out, exist_ok=True)

    def stamp(msg):
        if rank == 0:
            print(f"[acceptance {time.time() - t0:7.1f}s] {msg}", flush=True)

    # ---- model config + checkpoints --------------------------------------
    if args.tiny:
        cfg = var_tiny()
        args.inception_ckpt = args.inception_ckpt or "random"
        args.with_fp16 = True
        if args.classes is None:
            args.classes = 4
        args.num_img_per_class = min(args.num_img_per_class, 2)
        args.calib_classes = 4
        args.galt_epochs = min(args.galt_epochs, 3)
    elif args.resolution == 512:
        cfg = var_d36_512()
    else:
        cfg = VARConfig(depth=args.depth)
    qcfg = recipe_config(args.recipe)
    gen_cfg = GenerateConfig(seed=args.seed)

    if args.vae_ckpt and args.var_ckpt:
        vae_p = C.convert_vqvae_state_dict(
            C.load_torch_state_dict(args.vae_ckpt), cfg.vae, args.device)
        var_p = to_bf16(C.convert_var_state_dict(
            C.load_torch_state_dict(args.var_ckpt), cfg, args.device))
        smoke = False
    else:
        stamp("WARN: missing --vae-ckpt/--var-ckpt -> random init "
              "(smoke mode; the verdict is pipeline-health only)")
        vae_p, var_p = build_vae_var(0, cfg, args.device,
                                     dtype=torch.bfloat16)
        smoke = True

    classes = range(args.classes if args.classes else cfg.num_classes)
    n_expected = len(classes) * args.num_img_per_class

    # ---- stage 1+2: calibration + GALT (fp4 recipes only) -----------------
    galt = None
    if qcfg.transform:
        if rank == 0:
            galt = _calibrate_and_train_galt(args, cfg, qcfg, var_p, vae_p,
                                             stamp)
        if world > 1:
            from fpqvar_tpu_torch.quantize import galt as G

            dist.barrier()
            galt = G.load_best_s_pair(os.path.join(args.out, "best_s"),
                                      qcfg.w_bit)

    # ---- stage 3: mesh + generation legs ---------------------------------
    mesh = None
    if args.dp * args.tp > 1:
        mesh = make_mesh(MeshConfig(dp=args.dp, tp=args.tp), device)

    def generate_leg(tag, leg_qcfg, leg_galt):
        """Generate the leg's PNG set (resumable per class) and pack it;
        returns the npz path.  Skipped entirely when the npz exists."""
        fig_dir = os.path.join(args.out, f"figs_{tag}")
        npz = fig_dir + ".npz"
        exists = os.path.exists(npz)
        if mesh is not None:
            exists = Coll.broadcast_flag(exists, device)
        if exists:
            stamp(f"{tag}: packed npz exists (resume)")
            return npz
        params = quantize_var_params(var_p, cfg, leg_qcfg, galt=leg_galt)
        if mesh is not None:
            params = shard_params(params, mesh)
        stamp(f"{tag}: generating {n_expected} images -> {fig_dir}")
        generate_eval_set(
            VARGenerator(cfg, leg_qcfg, gen_cfg, device=device, mesh=mesh,
                         fuse_steps=mesh is None),
            params, vae_p, fig_dir, num_img_per_class=args.num_img_per_class,
            classes=classes, seed=args.seed, batch=args.batch, mesh=mesh)
        if rank == 0:
            packed = create_npz_from_sample_folder(fig_dir,
                                                   expected=n_expected)
            if packed != npz:
                raise RuntimeError(f"packed {packed}, expected {npz}")
        return npz

    sample_npz = generate_leg(args.recipe, qcfg, galt)
    fp16_npz = None
    if args.with_fp16:
        fp16_npz = generate_leg("fp16", QuantConfig(), None)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
        if rank != 0:
            return {}

    ref = args.ref_npz or fp16_npz
    if ref is None:
        raise SystemExit("need --ref-npz (or --with-fp16 to score against "
                         "the bf16 set)")

    # ---- stage 4: features + metrics -------------------------------------
    if not args.inception_ckpt:
        raise SystemExit("need --inception-ckpt (.pth or 'random')")
    if args.inception_ckpt == "random":
        stamp("WARN: random Inception weights -> metric values are "
              "pipeline-health only")
    inc_p = load_inception_params(args.inception_ckpt, device)

    def features(path, tag):
        """Extract (and cache) pool3 / spatial / probs features of an image
        npz; feature npzs (the reference's precomputed-batch format) pass
        through.  The ref cache is keyed by the source path, so that another
        --ref-npz on the same --out does not reuse the previous reference's
        features."""
        if tag == "ref":
            tag = "ref_" + hashlib.sha1(
                os.path.abspath(path).encode()).hexdigest()[:10]
        cache = os.path.join(args.out, f"features_{tag}.npz")
        if os.path.exists(cache):
            with np.load(cache) as d:
                return d["features"], d["spatial"], d["probs"]
        with np.load(path) as d:
            if "features" in d:
                return d["features"], d.get("spatial"), d.get("probs")
            imgs = d["arr_0"].transpose(0, 3, 1, 2)       # NHWC -> NCHW
        stamp(f"{tag}: extracting Inception features for {len(imgs)} images")
        f, s, pr = extract_features_batched(inc_p, imgs, batch=64)
        np.savez(cache, features=f, spatial=s, probs=pr)
        return f, s, pr

    ref_f, ref_s, _ = features(ref, "ref")
    sam_f, sam_s, sam_p = features(sample_npz, args.recipe)
    metrics = evaluate_all(ref_f, sam_f, ref_s, sam_s, sam_p, device=device)
    fp16_metrics = None
    if fp16_npz and fp16_npz != ref:
        f16_f, f16_s, f16_p = features(fp16_npz, "fp16")
        fp16_metrics = evaluate_all(ref_f, f16_f, ref_s, f16_s, f16_p,
                                    device=device)

    # ---- stage 5: verdict -------------------------------------------------
    out = verdict(args.recipe, metrics, fp16_metrics,
                  ref_npz_given=args.ref_npz is not None,
                  smoke=smoke or args.inception_ckpt == "random",
                  fid_slack=args.fid_slack, is_slack=args.is_slack,
                  n_images=n_expected, wall_s=time.time() - t0)
    with open(os.path.join(args.out, "ACCEPTANCE.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    if not out["pass"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
