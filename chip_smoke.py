#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fpqvar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the run exits
non-zero:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit from nvidia-smi and turns TF32 off for float32 matmuls and convs;
2. build: compiles the port's CUDA kernel K1 from ``fpqvar_tpu_torch/
   csrc`` with nvcc for sm_90a;
3. kernels: K1 (the grouped int8 GEMM) against its plain PyTorch version at
   the VAR-d16 shapes of the last scale at batch 8 (M = 2*8*256 = 4096) and
   one ragged shape, with times, the card's bound and a library yardstick;
4. small reference: a small generation (width 256, so every linear takes
   the grouped route) on the card against the same generation on the CPU;
5. main path: VAR-d16 with the full d16 VQVAE, random seeded weights,
   ``quantize_var_params`` and ``VARGenerator.generate`` for two batches of
   8 labels under the ``int8`` recipe and under ``bf16``; checks images and
   kernel launch counts and prints img/s;
6. profile: one more batch-8 generation per recipe under torch.profiler,
   after the launch counts were read: device busy time, idle share, K1's
   share and the kernels that take the most device time (the source of
   PERF.md's "Where the time goes"; about 50 s of the run on an H100).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table as one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, H100 SXM
H100_BYTES = 3.35e12         # HBM3 bandwidth, H100 SXM


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs after warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"device: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for float32 matmuls and convolutions "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s))")
    return card


def phase_build():
    from fpqvar_tpu_torch.ops import _build

    name = "int8_group_gemm"
    t0 = time.perf_counter()
    _build.build(name)
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build: {name} for sm_90a in {secs:.2f} s: {'; '.join(regs)}")


def _k1_operands(m, k, n, gen):
    """Realistic K1 operands: fp_e2 codes of a Gaussian activation and of a
    0.02-std weight, both per group of 128."""
    from fpqvar_tpu_torch.ops import packing as P

    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
    ac, asc = P.quant_int_codes(x, "fp_e2", 128)
    pw = P.pack_int_codes(w, "fp_e2", 128)
    return ac, asc, pw.codes, pw.scales


def phase_kernels():
    from fpqvar_tpu_torch.ops import int8_matmul as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = [("qkv", 4096, 1024, 3072), ("proj", 4096, 1024, 1024),
              ("fc1", 4096, 1024, 4096), ("fc2", 4096, 4096, 1024),
              ("ragged", 16, 1024, 1000)]
    rows = []
    for name, m, k, n in shapes:
        ops = _k1_operands(m, k, n, gen)
        y = K.int8_group_gemm(*ops, 128)
        torch.cuda.synchronize()
        ref = K.int8_group_gemm_ref(*ops, 128)
        tol = K.int8_group_gemm_tolerance(*ops, 128)
        err = (y - ref).abs()
        worst = float((err / tol.clamp_min(1e-30)).max())
        if not bool(torch.isfinite(y).all()) or bool((err > tol).any()):
            fail(f"K1 {name} M={m} K={k} N={n}: max err {float(err.max())} "
                 f"exceeds the tolerance (worst err/tol {worst:.3g})")
        a_bf = torch.randn((m, k), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        b_bf = torch.randn((k, n), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        ms = cuda_ms(lambda: K.int8_group_gemm(*ops, 128))
        plain_ms = cuda_ms(lambda: K.int8_group_gemm_ref(*ops, 128), reps=5)
        lib_ms = cuda_ms(lambda: torch.matmul(a_bf, b_bf))
        g = k // 128
        nbytes = m * k + m * g * 4 + n * k + g * n * 4 + m * n * 4
        nops = 2 * m * n * k
        t_bytes, t_ops = nbytes / H100_BYTES * 1e3, nops / H100_INT8_OPS * 1e3
        row = {"shape": name, "M": m, "K": k, "N": n,
               "max_abs_err": float(err.max()), "worst_err_over_tol": worst,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        print(f"kernels: K1 {name:6s} M={m} K={k} N={n}: max err "
              f"{row['max_abs_err']:.3e} (err/tol {worst:.3f} <= 1, tol "
              f"{K.K1_REL_TOL:g}*sum_g|sa*sw*part|); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bf16 torch.matmul {lib_ms:.4f} ms, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    return rows


def phase_small_reference():
    """A width-256 int8 generation (grouped K1 route, G = 2) and a bf16 one
    on the card against the same generations on the CPU, at top_k=1 and
    float32 compute."""
    from fpqvar_tpu_torch.config import GenerateConfig, bench_recipes, var_tiny
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.quantize import quantize_var_params

    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))
    params = init_var_params(cfg, seed=4, device="cpu", adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=5, device="cpu")
    labels = [3, 5, 7]
    for mode in ("int8", "bf16"):
        q = bench_recipes()[mode]
        out = {}
        for dev in ("cpu", "cuda"):
            qp = quantize_var_params(_to(params, dev), cfg, q, galt=galt)
            g = VARGenerator(cfg, q, GenerateConfig(top_k=1, top_p=0.0),
                             cache_dtype=torch.float32,
                             compute_dtype=torch.float32, device=dev)
            out[dev] = g.generate(qp, _to(vae, dev), labels).cpu()
        err = float((out["cpu"] - out["cuda"]).abs().max())
        if out["cuda"].shape != (3, 3, 6, 6) or not err <= 1e-4:
            fail(f"small {mode} generation: card vs CPU max err {err}")
        print(f"small reference: {mode} width-256 generation, card vs CPU "
              f"images max err {err:.3e} (tol 1e-4)")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def phase_main_path(card: str):
    from fpqvar_tpu_torch.config import GenerateConfig, bench_recipes, var_d16
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.ops import int8_matmul as K
    from fpqvar_tpu_torch.quantize import quantize_var_params

    cfg = var_d16()
    K.launches = 0               # counts from here on are the main path's
    t0 = time.perf_counter()
    params = init_var_params(cfg, seed=0, device="cuda", adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=1, device="cuda")
    rng = np.random.default_rng(2)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))
    torch.cuda.synchronize()
    print(f"main path: VAR-d16 (width {cfg.width}, {cfg.heads} heads, depth "
          f"{cfg.depth}, L={cfg.L}) + d16 VQVAE, random init in "
          f"{time.perf_counter() - t0:.1f} s")
    batch, n_batches = 8, 2
    per_gen_launches = cfg.depth * cfg.num_scales * 5
    results, setups = {}, {}
    for mode in ("int8", "bf16"):
        q = bench_recipes()[mode]
        t0 = time.perf_counter()
        qp = quantize_var_params(params, cfg, q, galt=galt)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        gen = VARGenerator(cfg, q, GenerateConfig())
        rng_gen = torch.Generator(device="cuda")
        rng_gen.manual_seed(3)
        before = K.launches
        times = []
        for i in range(n_batches):
            labels = torch.arange(i * batch, (i + 1) * batch, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs = gen.generate(qp, vae, labels, rng_gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if tuple(imgs.shape) != (batch, 3, 256, 256):
                fail(f"{mode}: images of shape {tuple(imgs.shape)}")
            if not bool(torch.isfinite(imgs).all()):
                fail(f"{mode}: non-finite image values")
            lo, hi = float(imgs.min()), float(imgs.max())
            if lo < 0.0 or hi > 1.0:
                fail(f"{mode}: image values outside [0, 1]: {lo}, {hi}")
        n = K.launches - before
        want = per_gen_launches * n_batches if mode == "int8" else 0
        if n != want:
            fail(f"{mode}: K1 launched {n} times over {n_batches} "
                 f"generations, expected {want}")
        steady = times[-1]
        results[mode] = steady
        print(f"main path: {mode}: quantize_var_params {t_quant:.2f} s; "
              f"generation ms/batch-of-{batch} = "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times)} (first includes "
              f"warm-up); steady {batch / steady:.2f} img/s; K1 launches "
              f"{n} ({n // n_batches} per generation); images "
              f"[{batch}, 3, 256, 256] finite in [0, 1]; on {card}")
        setups[mode] = (gen, qp, rng_gen)
    launches = K.launches
    print(f"main path: int8/bf16 steady time ratio "
          f"{results['int8'] / results['bf16']:.3f} on {card}; K1 launches "
          f"over the whole main path {launches}")
    labels = torch.arange(batch, device="cuda")
    for mode, (gen, qp, rng_gen) in setups.items():
        phase_profile(mode, lambda: gen.generate(qp, vae, labels, rng_gen),
                      card)
    return launches


def phase_profile(mode: str, run, card: str):
    """Where one generation's time goes: torch.profiler over one batch-8
    generation (after the main path's counts were read), summing the device
    time of every CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    busy = sum(dev_ms(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    if busy <= 0.0:
        print(f"profile: {mode}: device time not measured (the profiler "
              f"recorded no kernel time); wall {wall_ms:.1f} ms")
        return
    k1 = [e for e in kernels if "int8_group_gemm" in e.key]
    top = sorted(kernels, key=dev_ms, reverse=True)[:6]
    print(f"profile: {mode} batch-8 generation under the profiler: wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms in {n_kernels} "
          f"kernel launches, idle share {1.0 - busy / wall_ms:.3f}; K1 "
          f"{sum(dev_ms(e) for e in k1):.2f} ms in "
          f"{sum(e.count for e in k1)} launches; on {card}")
    for e in top:
        print(f"profile: {mode}   {dev_ms(e):8.2f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def main():
    card = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_small_reference()
    launches = phase_main_path(card)
    head = next(r for r in rows if r["shape"] == "fc1")
    kernels = {"kernels": [{
        "name": "int8_group_gemm",
        "route": "cuda",
        "source": "fpqvar_tpu_torch/csrc/int8_group_gemm.cu",
        "replaces": "fpqvar_tpu/ops/pallas/int8_matmul.py:185",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_shape": "fc1 M=4096 K=1024 N=4096",
        "shapes": rows,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
