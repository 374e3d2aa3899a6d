"""End-to-end quality ladder of the recipe's stages at a small real scale.

The port's ``scripts/quality_ladder.py``, with its stages, flags and JSON
schema: the whole pipeline the reference's acceptance test runs
(``evaluate*.py`` -> ``openai_evaluator.py``), at a scale that trains in
minutes.

1. synthesize a labelled image set (class-dependent gratings and blobs,
   drawn with numpy as JAX draws it, so both packages train on the same
   images);
2. tokenize with a fixed random VQVAE (``img_to_idxBl``) and train a small
   VAR (teacher-forcing cross-entropy, CFG label dropout, optax's warmup +
   cosine schedule: ``train/trainer.py``);
3. optionally plant heavy-tailed activation outliers on the trained model
   (``quantize/outliers.py``, function-preserving), capture calibration
   activations and train the GALT vectors (``quantize/galt.py``);
4. generate an eval set per recipe stage (bf16, naive FP4, + rotation, +
   GALT, + the fc2 dual grid = the full recipe, FP6, and the INT4-RTN and
   per-tensor sensitivity controls) through the engine;
5. score FID and IS against VQVAE reconstructions of held-out images with
   the port's InceptionV3 on fixed random weights (seed 42; a fixed random
   projection is a valid relative metric); ``--inception-seeds 42,0,1``
   scores the same images through further random draws, so that a
   reading's dependence on the Inception draw alone shows.

The reading the study supports is an ordering in units of its own floors
(the same-set split FID and the bf16 / bf16_rep generation cross-FID): the
full recipe within the floor of bf16, naive FP4 and INT4-RTN far above it.
Seeds: each generation batch ``i`` draws from a ``torch.Generator`` seeded
with ``eval.pipeline.batch_seed(5, i)`` (``6`` for the ``*_rep`` stages)
where JAX folds ``PRNGKey(5 or 6)`` with ``i``.  Runs on ``cuda`` unless
``--device cpu``.  ``--study-key K`` merges the result into ``--out``
under ``K``, beside the card's name and power limit (``--out`` is the
port's own study file, ``STUDY_quality_ladder_torch.json``, by default).
``--vae-params PATH`` takes the VQVAE from an npz of ``save_params`` (of
either package) in place of the seed-0 draw: with
``tests/data/ladder_vqvae_jax_init.npz`` the ladder runs on JAX's own
initial VQVAE.

    python -m fpqvar_tpu_torch.tools.quality_ladder --steps 900 \\
        --train-n 2048 --eval-n 2048 --plant-outliers 48 \\
        --outlier-scale 64
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

STAGE_NAMES = ("bf16", "bf16_rep", "fp4_naive", "fp4_rot", "fp4_galt",
               "fp4_full", "fp6_full", "fp4_pertensor", "int4_rtn")


def synth_images(key, n, num_classes, size):
    """Class-conditional synthetic images [n, 3, size, size] in [0, 1]:
    class-dependent grating frequency and orientation, blob position and
    tint (numpy, JAX's draws)."""
    rng = np.random.default_rng(key)
    labels = rng.integers(0, num_classes, n)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.zeros((n, 3, size, size), np.float32)
    for i, c in enumerate(labels):
        ang = 2 * np.pi * c / num_classes
        freq = 2.0 + 1.5 * (c % 3)
        phase = rng.uniform(0, 2 * np.pi)
        grate = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (np.cos(ang) * xx + np.sin(ang) * yy) + phase)
        cy, cx = (0.25 + 0.5 * ((c // 3) % 2), 0.25 + 0.5 * (c % 2))
        cy += rng.uniform(-0.08, 0.08)
        cx += rng.uniform(-0.08, 0.08)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.02))
        tint = np.array([0.4 + 0.6 * ((c >> k) & 1) for k in range(3)],
                        np.float32)
        base = 0.6 * grate + 0.4 * blob
        imgs[i] = np.clip(
            tint[:, None, None] * base[None]
            + rng.normal(0, 0.03, (3, size, size)), 0, 1)
    return imgs.astype(np.float32), labels.astype(np.int32)


@torch.inference_mode()
def reconstruct(vae_p, cfg, imgs: np.ndarray, device) -> torch.Tensor:
    """VQVAE round trip through the multi-scale token pyramid: the
    reference-space images the generated sets are scored against."""
    from fpqvar_tpu_torch.models import vqvae as vq

    x = torch.from_numpy(imgs).to(device)
    idx_list = vq.img_to_idxBl(vae_p, cfg.vae, x * 2 - 1)
    b = imgs.shape[0]
    hw = cfg.patch_nums[-1]
    f_hat = torch.zeros((b, cfg.vae.z_channels, hw, hw), dtype=torch.float32,
                        device=device)
    qp = vae_p["quantize"]
    for si, idx in enumerate(idx_list):
        pn = cfg.patch_nums[si]
        h = vq.embed_idx(qp, idx).transpose(1, 2).reshape(
            b, cfg.vae.z_channels, pn, pn).to(torch.float32)
        f_hat, _ = vq.get_next_autoregressive_input(qp, cfg.vae, si, f_hat, h)
    out = vq.decode(vae_p, cfg.vae, f_hat)
    return torch.clamp(out * 0.5 + 0.5, 0, 1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--train-n", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval-n", type=int, default=256)
    ap.add_argument("--galt-epochs", type=int, default=25)
    ap.add_argument("--out", type=str,
                    default="STUDY_quality_ladder_torch.json")
    ap.add_argument("--stages", type=str, default=None,
                    help="comma list to restrict (" + ",".join(STAGE_NAMES)
                    + ")")
    ap.add_argument("--plant-outliers", type=int, default=16, metavar="N",
                    help="plant N heavy-tailed activation channels "
                         "(quantize/outliers.py, function-preserving): the "
                         "d30-like statistics that make the quantized "
                         "stages separate; 0 disables")
    ap.add_argument("--outlier-scale", type=float, default=32.0)
    ap.add_argument("--plant-when", choices=["init", "post"], default="post",
                    help="init: plant before training (the weights adapt); "
                         "post: plant on the trained model, so naive "
                         "low-bit quantization crushes the small-weight "
                         "columns and the recipe (rotation + GALT trained "
                         "on the planted captures) must migrate them back")
    ap.add_argument("--study-key", type=str, default=None,
                    help="merge the result into --out under this key, "
                         "beside the card's name and power limit")
    ap.add_argument("--inception-seeds", type=str, default="42",
                    help="comma list of random-Inception seeds: the first "
                         "gives the reading; with more, every seed scores "
                         "the same images and the JSON gains "
                         "'inception_seed_sweep'")
    ap.add_argument("--vae-params", type=str, default=None,
                    help="the VQVAE tree from this npz (save_params' "
                         "layout, e.g. JAX's initial draw in "
                         "tests/data/ladder_vqvae_jax_init.npz) in place "
                         "of the seed-0 random init")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device's
    name where there is none."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0].strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device)


def _stages(galt_pair):
    from fpqvar_tpu_torch.config import (QuantConfig, fpqvar_w4a4,
                                         fpqvar_w6a6)

    fp4 = fpqvar_w4a4()
    return {
        "bf16": (QuantConfig(), None),
        # an independent-seed bf16 leg: its FID against the bf16 leg's set
        # is the generation-level floor (sampling and set-size noise)
        "bf16_rep": (QuantConfig(), None),
        # naive: single-grid fc2, no rotation, no GALT (the paper's "FP4
        # baseline" row)
        "fp4_naive": (fp4.replace(rotate=False, block_rotate=False,
                                  transform=False, fc2_format="fp_e2"), None),
        "fp4_rot": (fp4.replace(transform=False, fc2_format="fp_e2"), None),
        "fp4_galt": (fp4.replace(fc2_format="fp_e2"), galt_pair),
        "fp4_full": (fp4, galt_pair),            # + the fc2 dual grid
        "fp6_full": (fpqvar_w6a6(), galt_pair),
        # sensitivity controls: stages that should damage quality (the
        # paper's INT4 RTN row is its catastrophic baseline)
        "fp4_pertensor": (fp4.replace(
            rotate=False, block_rotate=False, transform=False,
            weight_quant="per_tensor", act_quant="per_tensor",
            fc2_format="fp_e2"), None),
        "int4_rtn": (QuantConfig(
            enabled=True, int_quant=True, w_bit=4, a_bit=4,
            weight_quant="per_channel", act_quant="per_token",
            act_sym=True), None),
    }


def main(argv=None):
    args = parse_args(argv)

    from fpqvar_tpu_torch.config import (GenerateConfig, VARConfig,
                                         VQVAEConfig)
    from fpqvar_tpu_torch.eval import inception as I
    from fpqvar_tpu_torch.eval import metrics as M
    from fpqvar_tpu_torch.eval.pipeline import batch_seed
    from fpqvar_tpu_torch.models import VARGenerator
    from fpqvar_tpu_torch.models import vqvae as vq
    from fpqvar_tpu_torch.models.var import init_var_params
    from fpqvar_tpu_torch.models.vqvae import init_vqvae_params
    from fpqvar_tpu_torch.quantize import galt as GALT
    from fpqvar_tpu_torch.quantize import quantize_var_params
    from fpqvar_tpu_torch.quantize.calibration import (CalibrationStore,
                                                       capture_generation)
    from fpqvar_tpu_torch.quantize.outliers import (
        outlier_scale_vector, plant_activation_outliers)
    from fpqvar_tpu_torch.train.trainer import (make_optimizer,
                                                make_train_state, train_step,
                                                tree_map, warmup_cosine_decay)

    dev = torch.device(args.device)
    pn = (1, 2, 3, 4, 6, 8)
    cfg = VARConfig(
        depth=args.depth, embed_dim=args.width, num_heads=args.width // 64,
        patch_nums=pn, num_classes=args.classes, cond_drop_rate=0.1,
        vae=VQVAEConfig(vocab_size=512, z_channels=16, ch=32, ch_mult=(1, 2),
                        num_res_blocks=1, patch_nums=pn))
    img_size = pn[-1] * 2  # one 2x downsample level in ch_mult=(1, 2)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:6.1f}s] {msg}", flush=True)

    if args.vae_params:
        from fpqvar_tpu_torch.utils.checkpoint import load_params

        vae_p = load_params(args.vae_params, dev)
    else:
        vae_p = init_vqvae_params(cfg.vae, seed=0, device=dev)
    var_p = init_var_params(cfg, seed=1, device=dev)
    outlier_s = None

    def plant(params):
        params = tree_map(lambda t: t.detach().to(torch.float32), params)
        return plant_activation_outliers(params, cfg, outlier_s)[0]

    if args.plant_outliers:
        outlier_s = outlier_scale_vector(
            cfg.width, num_hot=args.plant_outliers,
            max_scale=args.outlier_scale, seed=13)
        if args.plant_when == "init":
            var_p = plant(var_p)

    # ---- data + tokenization --------------------------------------------
    imgs, labels = synth_images(11, args.train_n, args.classes, img_size)
    with torch.inference_mode():
        idx_list = vq.img_to_idxBl(vae_p, cfg.vae,
                                   torch.from_numpy(imgs).to(dev) * 2 - 1)
        targets = torch.cat(idx_list, dim=1).long()                # [N, L]
        x_teacher = vq.idxBl_to_var_input(vae_p["quantize"], cfg.vae,
                                          idx_list).to(torch.float32)
    targets, x_teacher = targets.clone(), x_teacher.clone()
    labels_t = torch.from_numpy(labels).long().to(dev)
    log(f"data: {tuple(imgs.shape)} -> targets {tuple(targets.shape)}, "
        f"x {tuple(x_teacher.shape)}")

    # ---- train ------------------------------------------------------------
    sched = warmup_cosine_decay(
        0.0, 6e-4, warmup_steps=min(50, max(1, args.steps // 5)),
        decay_steps=args.steps)
    opt = make_optimizer(schedule=sched)
    state = make_train_state(var_p, opt)
    rng = np.random.default_rng(3)
    drop_gen = torch.Generator(device=dev)
    drop_gen.manual_seed(4)
    for it in range(args.steps):
        sel = torch.from_numpy(
            rng.choice(args.train_n, args.batch, replace=False)).to(dev)
        batch = {"label": labels_t[sel], "x": x_teacher[sel],
                 "targets": targets[sel]}
        state, metr = train_step(state, cfg, opt, batch, generator=drop_gen)
        if it % 100 == 0 or it == args.steps - 1:
            log(f"step {it}: loss {float(metr['loss']):.4f}")
    var_p = tree_map(lambda t: t.detach(), state.params)
    del state
    if outlier_s is not None and args.plant_when == "post":
        # planting on the trained model leaves the bf16 leg's function (and
        # FID) as it was, but every activation quantizer now sees
        # heavy-tailed channels and every weight quantizer anti-scaled
        # columns: the imbalance the recipe exists to migrate
        var_p = plant(var_p)

    # ---- calibration + GALT ----------------------------------------------
    calib_labels = rng.integers(0, args.classes, 32)
    cal_gen = torch.Generator(device=dev)
    cal_gen.manual_seed(7)
    taps = capture_generation(var_p, vae_p, cfg, calib_labels, cal_gen)
    outlier_ratio = {}
    if outlier_s is not None:
        # did the planted channels survive?  hot / cold per-channel absmax
        # ratio of the captured mat_qkv / fc1 inputs
        hot = outlier_s > 1.0
        for kind in ("mat_qkv", "fc1"):
            acts = np.concatenate([np.asarray(t[kind], np.float32)
                                   .reshape(-1, cfg.width) for t in taps])
            am = np.abs(acts).max(axis=0)
            outlier_ratio[kind] = round(
                float(am[hot].mean() / am[~hot].mean()), 2)
        log(f"planted-outlier hot/cold absmax ratio after training: "
            f"{outlier_ratio}")
    tmp = tempfile.mkdtemp(prefix="ladder_calib_")
    try:
        store = CalibrationStore(tmp)
        store.append_run(taps)
        best = {kind: GALT.train_galt(
            store, var_p["blocks"][f"{kind}_w"].float().cpu().numpy(), kind,
            w_bit=4, epochs=args.galt_epochs, max_samples_per_step=128,
            device=dev) for kind in ("mat_qkv", "fc1")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    galt_pair = (best["mat_qkv"], best["fc1"])
    log(f"GALT trained (s range {best['mat_qkv'].min():.3f}.."
        f"{best['mat_qkv'].max():.3f})")

    stages = _stages(galt_pair)
    if args.stages:
        keep = args.stages.split(",")
        stages = {k: v for k, v in stages.items() if k in keep}

    # ---- generate -----------------------------------------------------------
    eval_labels = np.arange(args.eval_n, dtype=np.int64) % args.classes
    stage_imgs = {}
    gen_rng = torch.Generator(device=dev)
    for name, (qcfg, g) in stages.items():
        qp = quantize_var_params(var_p, cfg, qcfg, galt=g)
        gen = VARGenerator(cfg, qcfg, GenerateConfig(), device=dev)
        # *_rep stages draw an independent stream (the floor's control leg)
        base = 6 if name.endswith("_rep") else 5
        outs = []
        for i in range(0, args.eval_n, 64):
            gen_rng.manual_seed(batch_seed(base, i))
            lab = torch.from_numpy(eval_labels[i:i + 64]).to(dev)
            outs.append(gen.generate(qp, vae_p, lab, gen_rng))
        del gen, qp
        stage_imgs[name] = torch.cat(outs)
    ref_imgs, _ = synth_images(99, args.eval_n, args.classes, img_size)
    ref_recon = reconstruct(vae_p, cfg, ref_imgs, dev)
    # metric-sensitivity control: uniform noise must score far above the
    # floor, so that stage rows at the floor read "no measurable harm"
    noise_imgs = np.random.default_rng(123).uniform(
        size=tuple(ref_recon.shape)).astype(np.float32)

    def stats(f):
        return M.FIDStatistics.from_features(f.astype(np.float64))

    def score(inception_seed, say):
        """Floors, noise control and every stage's FID / IS through the
        random Inception of ``inception_seed``."""
        inc_p = I.init_inception_params(inception_seed, dev)

        def features(images, bs=64):
            pools, probs = [], []
            for i in range(0, images.shape[0], bs):
                p3, _, pr = I.inception_features(
                    inc_p, torch.as_tensor(images[i:i + bs]).to(dev))
                pools.append(p3.cpu().numpy())
                probs.append(pr.cpu().numpy())
            return np.concatenate(pools), np.concatenate(probs)

        ref_feats, _ = features(ref_recon)
        ref_stats = stats(ref_feats)
        # noise floor: FID between two halves of the reference set itself
        half = args.eval_n // 2
        fid_floor = stats(ref_feats[:half]).frechet_distance(
            stats(ref_feats[half:]))
        say(f"reference set: {tuple(ref_recon.shape)}, same-set split FID "
            f"floor {fid_floor:.4f}")
        nf, _ = features(noise_imgs)
        fid_noise = stats(nf).frechet_distance(ref_stats)
        say(f"noise-control FID {fid_noise:.3f} (floor {fid_floor:.4f})")
        results, stage_feats = {}, {}
        for name, imgs_s in stage_imgs.items():
            feats, probs = features(imgs_s)
            fid = stats(feats).frechet_distance(ref_stats)
            is_score = M.inception_score(probs, split_size=args.eval_n // 2)
            results[name] = {"fid": round(float(fid), 4),
                             "is": round(float(is_score), 4)}
            stage_feats[name] = feats if name.startswith("bf16") else None
            say(f"{name:10s} FID {fid:8.3f}  IS {is_score:6.3f}")
        fid_gen_floor = None
        if (stage_feats.get("bf16") is not None
                and stage_feats.get("bf16_rep") is not None):
            # cross-FID of two independent bf16 generations: the
            # generation-level floor for this eval-set size
            fid_gen_floor = float(stats(stage_feats["bf16"])
                                  .frechet_distance(
                                      stats(stage_feats["bf16_rep"])))
            say(f"bf16-vs-bf16_rep cross-FID (generation floor) "
                f"{fid_gen_floor:.4f}")
        return {
            "fid_noise_floor_same_set_split": round(float(fid_floor), 4),
            "fid_generation_floor_bf16_cross": (
                round(fid_gen_floor, 4) if fid_gen_floor is not None
                else None),
            "fid_noise_control_uniform_images": round(float(fid_noise), 4),
            "results": results,
        }

    # ---- score -----------------------------------------------------------
    seeds = [int(v) for v in args.inception_seeds.split(",")]
    scored = score(seeds[0], log)
    sweep = [{"inception_seed": seeds[0], **scored}]
    for sd in seeds[1:]:
        sweep.append({"inception_seed": sd, **score(
            sd, lambda msg, sd=sd: log(f"[inception seed {sd}] {msg}"))})

    out = {
        "config": {"depth": args.depth, "width": args.width,
                   "classes": args.classes, "train_n": args.train_n,
                   "steps": args.steps, "eval_n": args.eval_n,
                   "img_size": img_size, "patch_nums": list(pn),
                   "plant_outliers": args.plant_outliers,
                   "outlier_scale": args.outlier_scale},
        "outlier_hot_cold_ratio_after_training": outlier_ratio or None,
        "note": "random-weight Inception features (relative metric); "
                "reference set = VQVAE reconstructions of held-out data",
        **scored,
        "wall_s": round(time.time() - t0, 1),
    }
    if len(seeds) > 1:
        out["inception_seed_sweep"] = sweep
    doc = out
    if args.study_key:
        doc = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                doc = json.load(f)
        doc[args.study_key] = {"card": card_name(dev),
                               "argv": (sys.argv[1:] if argv is None
                                        else list(argv)), **out}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps(out["results"]))
    return out


if __name__ == "__main__":
    main()
