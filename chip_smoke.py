#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fpqvar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the run exits
non-zero:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit from nvidia-smi and turns TF32 off for float32 matmuls and convs;
2. build: compiles the port's CUDA kernels K1 to K4 from ``fpqvar_tpu_torch/
   csrc`` with nvcc for sm_90a, one nvcc per source, all started together,
   and prints each kernel's registers and spills;
3. kernels: K1 (the grouped int8 GEMM), K2 (the dequantize-in-register
   GEMM over packed fp4 / fp6 codes), K3 (the full-K int8 GEMM with fused
   rescale) and K4 (per-token quantize inside the full-K int8 GEMM) against
   their plain PyTorch versions at the VAR-d16 shapes of the last scale at
   batch 8 (M = 2*8*256 = 4096) and extra cases, with times, the card's
   bound and a library yardstick; K3 and K4 must equal theirs exactly;
4. small reference: small generations (width 256, so every grouped linear
   has more than one scale group) under ``int8``, ``bf16``, ``packed``,
   ``w4a16p``, W6A6 on the packed backend, ``fake``, ``int8ch``,
   ``int8chs``, ``int8chsnr`` and ``w4a16``, on the card against the same
   generations on the CPU;
5. main path: VAR-d16 with the full d16 VQVAE, random seeded weights,
   ``quantize_var_params`` and ``VARGenerator.generate`` for two batches of
   8 labels under ``int8``, ``bf16``, ``packed``, ``w4a16p``, ``int8ch``,
   ``int8chs``, ``int8chsnr`` and ``w4a16``; checks images and each
   recipe's kernel launch counts and prints img/s;
6. profile: one more batch-8 generation under ``int8``, ``bf16``,
   ``packed`` and ``int8chs`` under torch.profiler, after the launch counts
   were read: device busy time, idle share, the four kernels' shares and
   the kernels that take the most device time (the source of PERF.md's
   "Where the time goes").

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table as one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, H100 SXM
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_BYTES = 3.35e12         # HBM3 bandwidth, H100 SXM
KERNEL_SOURCES = ("int8_group_gemm", "packed_dequant_gemm", "int8ch_gemm",
                  "fused_ch_gemm")
#: the last scale's block linears of VAR-d16 at batch 8: (name, M, K, N)
D16_SHAPES = (("qkv", 4096, 1024, 3072), ("proj", 4096, 1024, 1024),
              ("fc1", 4096, 1024, 4096), ("fc2", 4096, 4096, 1024))


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
    """Every kernel source at once: one nvcc process each."""
    from fpqvar_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        secs = list(pool.map(timed, KERNEL_SOURCES))
    for name, sec in zip(KERNEL_SOURCES, secs):
        regs = [ln.strip() for ln in
                _build.build_logs.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build: {name} for sm_90a in {sec:.2f} s: {'; '.join(regs)}")
    print(f"build: {len(KERNEL_SOURCES)} sources in "
          f"{time.perf_counter() - t0:.2f} s")


def _k1_operands(m, k, n, gen):
    """Realistic K1 operands: fp_e2 codes of a Gaussian activation and of a
    0.02-std weight, both per group of 128."""
    from fpqvar_tpu_torch.ops import packing as P

    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
    ac, asc = P.quant_int_codes(x, "fp_e2", 128)
    pw = P.pack_int_codes(w, "fp_e2", 128)
    return ac, asc, pw.codes, pw.scales


def check_and_time(label: str, row: dict, run, plain, tol, lib, nbytes: int,
                   peak: float, tol_text: str, lib_text: str,
                   int_mm=None) -> dict:
    """Hold ``run()`` (a kernel) against ``plain()`` within ``tol()`` per
    element, or, with ``tol=None``, require the two to be equal
    (``torch.equal``); then time the kernel, its plain version, the library
    yardstick ``lib()`` and, where given and where it runs, the int8
    yardstick ``int_mm()``; ``row`` (shape, M, K, N, ...) gains the numbers.
    The bound is the larger of ``nbytes`` over the memory rate and 2*M*N*K
    operations over ``peak``."""
    y = run()
    torch.cuda.synchronize()
    ref = plain()
    err = (y.float() - ref.float()).abs()
    desc = " ".join(f"{k}={v}" for k, v in row.items() if k != "shape")
    if tol is None:
        worst = 0.0
        if y.dtype != ref.dtype or not torch.equal(y, ref):
            fail(f"{label} {row['shape']} {desc}: kernel and plain version "
                 f"differ (max err {float(err.max())}), exact equality "
                 "required")
    else:
        bound = tol()
        worst = float((err / bound.clamp_min(1e-30)).max())
        if not bool(torch.isfinite(y).all()) or bool((err > bound).any()):
            fail(f"{label} {row['shape']} {desc}: max err {float(err.max())} "
                 f"exceeds the tolerance (worst err/tol {worst:.3g})")
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain, reps=5)
    lib_ms = cuda_ms(lib)
    int_mm_ms = None
    if int_mm is not None:
        try:
            int_mm()
        except RuntimeError as e:       # a yardstick only: absent is fine
            print(f"kernels: {label} {row['shape']}: torch._int_mm does not "
                  f"run here ({str(e).splitlines()[0][:80]})")
        else:
            int_mm_ms = cuda_ms(int_mm)
    t_bytes = nbytes / H100_BYTES * 1e3
    t_ops = 2 * row["M"] * row["N"] * row["K"] / peak * 1e3
    row.update(max_abs_err=float(err.max()), worst_err_over_tol=worst,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    if int_mm is not None:
        row["int_mm_ms"] = int_mm_ms
    check = ("equal to the plain version" if tol is None else
             f"err/tol {worst:.3f} <= 1, tol {tol_text}")
    extra = ("" if int_mm_ms is None else
             f", int8 torch._int_mm {int_mm_ms:.4f} ms")
    print(f"kernels: {label} {row['shape']:8s} {desc}: max err "
          f"{row['max_abs_err']:.3e} ({check}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {lib_text} {lib_ms:.4f} ms{extra}, bound "
          f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    return row


def phase_kernels():
    from fpqvar_tpu_torch.ops import int8_matmul as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = list(D16_SHAPES) + [("ragged", 16, 1024, 1000)]
    rows = []
    for name, m, k, n in shapes:
        ops = _k1_operands(m, k, n, gen) + (128,)
        a_bf = torch.randn((m, k), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        b_bf = torch.randn((k, n), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        g = k // 128
        rows.append(check_and_time(
            "K1", {"shape": name, "M": m, "K": k, "N": n},
            lambda: K.int8_group_gemm(*ops),
            lambda: K.int8_group_gemm_ref(*ops),
            lambda: K.int8_group_gemm_tolerance(*ops),
            lambda: torch.matmul(a_bf, b_bf),
            m * k + m * g * 4 + n * k + g * n * 4 + m * n * 4, H100_INT8_OPS,
            f"{K.K1_REL_TOL:g}*sum_g|sa*sw*part|", "bf16 torch.matmul"))
    return rows


def phase_k2():
    """K2 against ``packed_matmul_ref`` at the d16 shapes with bfloat16 x
    and e2m1 nibbles, then e2m3 bytes at the fc1 shape, float32 x at the
    proj shape and a ragged M.  The bound counts the operations at the
    bf16 tensor-core peak for float32 x too: the kernel runs its product
    there (x split into three exact bf16 parts)."""
    from fpqvar_tpu_torch.ops import packing as P
    from fpqvar_tpu_torch.ops import quant_matmul as QM

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, m, k, n, "fp_e2", bf16) for name, m, k, n in D16_SHAPES]
    cases += [("fc1-e2m3", 4096, 1024, 4096, "fp6_e2m3", bf16),
              ("proj-f32", 4096, 1024, 1024, "fp_e2", f32),
              ("ragged", 16, 1024, 1024, "fp_e2", bf16)]
    rows = []
    for name, m, k, n, fmt, dtype in cases:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        pw = P.pack(w, fmt, 128)
        ops = (x, pw.codes, pw.scales, fmt, 128, pw.nibble_packed)
        b_lib = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        x_name = str(dtype).replace("torch.", "")
        rows.append(check_and_time(
            "K2", {"shape": name, "M": m, "K": k, "N": n, "fmt": fmt,
                   "x": x_name, "nibble": pw.nibble_packed},
            lambda: QM.packed_matmul(*ops),
            lambda: QM.packed_matmul_ref(*ops),
            lambda: QM.packed_matmul_tolerance(*ops),
            lambda: torch.matmul(x, b_lib),
            (x.numel() * x.element_size() + pw.codes.numel()
             + pw.scales.numel() * 4 + m * n * 4), H100_BF16_FLOPS,
            f"{QM.K2_REL_TOL:g}*sum_g|s|*sum_k|x*grid|",
            f"{x_name} torch.matmul"))
    return rows


def _int_mm(m, k, n, gen):
    """The int8 yardstick: ``torch._int_mm`` (s8 x s8 -> s32) on random
    codes of the same shape; the port never calls it."""
    a = torch.randint(-12, 13, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-12, 13, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8).t()
    return lambda: torch._int_mm(a, b)


def phase_k3():
    """K3 against ``int8ch_gemm_ref`` (exact equality) on per-token fp_e2
    codes of a Gaussian activation and per-channel codes of a 0.02-std
    weight: float32 output at the fc2 shape (as ``int8ch`` runs it, the two
    dual-grid halves summed after), bfloat16 output at the other d16
    shapes, and a ragged M and N.  The bound counts codes, scales and the
    output at its dtype."""
    from fpqvar_tpu_torch.ops import int8_matmul as K
    from fpqvar_tpu_torch.ops import packing as P

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, m, k, n, f32 if name == "fc2" else bf16)
             for name, m, k, n in D16_SHAPES]
    cases += [("ragged", 16, 1024, 1000, bf16)]
    rows = []
    for name, m, k, n, out_dtype in cases:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        ac, asc = P.quant_int_codes(x, "fp_e2", k)
        pw = P.pack_int_codes(w, "fp_e2", k)
        ops = (ac, asc, pw.codes, pw.scales, out_dtype)
        a_bf = torch.randn((m, k), generator=gen, device="cuda", dtype=bf16)
        b_bf = torch.randn((k, n), generator=gen, device="cuda", dtype=bf16)
        out_name = str(out_dtype).replace("torch.", "")
        rows.append(check_and_time(
            "K3", {"shape": name, "M": m, "K": k, "N": n, "out": out_name},
            lambda: K.int8ch_gemm(*ops), lambda: K.int8ch_gemm_ref(*ops),
            None, lambda: torch.matmul(a_bf, b_bf),
            m * k + m * 4 + n * k + n * 4 + m * n * (4 if out_dtype == f32
                                                     else 2),
            H100_INT8_OPS, "", "bf16 torch.matmul",
            int_mm=_int_mm(m, k, n, gen)))
    return rows


def phase_k4():
    """K4 against ``fused_ch_gemm_ref`` (exact equality): bfloat16 x and
    fp_e2 at the four d16 shapes (output in x's dtype, as the per-channel
    recipes run it), fp_e1, fp_e3 and fp6_e2m3 at the fc1 shape, float32 x
    at the proj shape, and a ragged M and N with an all-zero row.  The bound
    counts x at its dtype, the weight codes and scales and the output; the
    activation codes never leave the chip."""
    from fpqvar_tpu_torch.ops import int8_matmul as K
    from fpqvar_tpu_torch.ops import packing as P

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, m, k, n, "fp_e2", bf16) for name, m, k, n in D16_SHAPES]
    cases += [(f"fc1-{fmt}", 4096, 1024, 4096, fmt, bf16)
              for fmt in ("fp_e1", "fp_e3", "fp6_e2m3")]
    cases += [("proj-f32", 4096, 1024, 1024, "fp_e2", f32),
              ("ragged", 16, 1024, 1000, "fp_e2", bf16)]
    rows = []
    for name, m, k, n, fmt, dtype in cases:
        x = (torch.randn((m, k), generator=gen, device="cuda") * 3.0)
        if name == "ragged":
            x[m // 2] = 0.0                                # an all-zero row
        x = x.to(dtype)
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        pw = P.pack_int_codes(w, fmt, k)
        ops = (x, pw.codes, pw.scales, fmt, dtype)
        b_lib = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        x_name = str(dtype).replace("torch.", "")
        rows.append(check_and_time(
            "K4", {"shape": name, "M": m, "K": k, "N": n, "fmt": fmt,
                   "x": x_name},
            lambda: K.fused_ch_gemm(*ops), lambda: K.fused_ch_gemm_ref(*ops),
            None, lambda: torch.matmul(x, b_lib),
            (x.numel() * x.element_size() + pw.codes.numel()
             + pw.scales.numel() * 4 + m * n * x.element_size()),
            H100_INT8_OPS, "", f"{x_name} torch.matmul",
            int_mm=_int_mm(m, k, n, gen)))
    return rows


def _small_recipes():
    """The small-reference recipes: ``bench_recipes`` entries and W6A6 on
    the packed backend."""
    from fpqvar_tpu_torch.config import bench_recipes, fpqvar_w6a6

    recipes = {m: bench_recipes()[m]
               for m in ("int8", "bf16", "packed", "w4a16p", "fake", "int8ch",
                         "int8chs", "int8chsnr", "w4a16")}
    recipes["w6a6-packed"] = fpqvar_w6a6().replace(backend="packed")
    return recipes


def phase_small_reference():
    """Width-256 generations (every grouped linear has more than one scale
    group) on the card against the same generations on the CPU, at top_k=1
    and float32 compute."""
    from fpqvar_tpu_torch.config import GenerateConfig, var_tiny
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
    for mode, q in _small_recipes().items():
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


#: kernel -> the module attribute that counts its launches
COUNTERS = {"K1": ("int8_matmul", "launches"),
            "K2": ("quant_matmul", "launches"),
            "K3": ("int8_matmul", "ch_launches"),
            "K4": ("int8_matmul", "fused_launches")}
#: the recipes profiled after the main path (phase 6)
PROFILED = ("int8", "bf16", "packed", "int8chs")


def _counter_modules():
    from fpqvar_tpu_torch.ops import int8_matmul, quant_matmul

    return {"int8_matmul": int8_matmul, "quant_matmul": quant_matmul}


def reset_counts():
    mods = _counter_modules()
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)


def read_counts() -> dict:
    mods = _counter_modules()
    return {k: getattr(mods[mod], attr) for k, (mod, attr) in COUNTERS.items()}


def phase_main_path(card: str):
    """Each recipe's generations with every launch count set to 0 just
    before them and read just after: K1 runs exactly under ``int8``, K2
    exactly under ``packed`` and ``w4a16p``, K3 and K4 exactly under the
    per-channel recipes."""
    from fpqvar_tpu_torch.config import GenerateConfig, bench_recipes, var_d16
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.quantize import quantize_var_params

    cfg = var_d16()
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
    blocks = cfg.depth * cfg.num_scales
    # launches per generation (160 block forwards, CFG's doubled batch in
    # one call): int8 runs fc2 as two K1 GEMMs (dual grid); packed fake-
    # quantizes fc2's dual grid first and runs one K2 GEMM; int8ch runs K4
    # on qkv, proj and fc1 and fc2's dual grid as two K3 GEMMs; int8chs and
    # int8chsnr run K4 on all four; w4a16 runs no kernel (wonly_dot)
    none = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    per_gen = {"int8": {**none, "K1": blocks * 5},
               "bf16": none,
               "packed": {**none, "K2": blocks * 4},
               "w4a16p": {**none, "K2": blocks * 4},
               "int8ch": {**none, "K3": blocks * 2, "K4": blocks * 3},
               "int8chs": {**none, "K4": blocks * 4},
               "int8chsnr": {**none, "K4": blocks * 4},
               "w4a16": none}
    totals = dict(none)
    results, setups = {}, {}
    for mode in per_gen:
        q = bench_recipes()[mode]
        t0 = time.perf_counter()
        qp = quantize_var_params(params, cfg, q, galt=galt)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        gen = VARGenerator(cfg, q, GenerateConfig())
        rng_gen = torch.Generator(device="cuda")
        rng_gen.manual_seed(3)
        times = []
        reset_counts()
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
        counts = read_counts()
        for kern, n in counts.items():
            want = per_gen[mode][kern] * n_batches
            if n != want:
                fail(f"{mode}: {kern} launched {n} times over {n_batches} "
                     f"generations, expected {want}")
            totals[kern] += n
        steady = times[-1]
        results[mode] = steady
        per = ", ".join(f"{k} {n // n_batches}" for k, n in counts.items())
        print(f"main path: {mode}: quantize_var_params {t_quant:.2f} s; "
              f"generation ms/batch-of-{batch} = "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times)} (first includes "
              f"warm-up); steady {batch / steady:.2f} img/s; launches per "
              f"generation {per}; images [{batch}, 3, 256, 256] finite in "
              f"[0, 1]; on {card}")
        if mode in PROFILED:
            setups[mode] = (gen, qp, rng_gen)
    print("main path: steady time against bf16: " + ", ".join(
        f"{m} {results[m] / results['bf16']:.3f}" for m in results)
        + f" on {card}; launches over the main path: "
        + ", ".join(f"{k} {n}" for k, n in totals.items()))
    labels = torch.arange(batch, device="cuda")
    for mode in PROFILED:
        gen, qp, rng_gen = setups[mode]
        phase_profile(mode, lambda: gen.generate(qp, vae, labels, rng_gen),
                      card)
    return totals


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
    ours = []
    for label, key in (("K1", "int8_group_gemm"),
                       ("K2", "packed_dequant_gemm"), ("K3", "int8ch_gemm"),
                       ("K4", "fused_ch_gemm")):
        hits = [e for e in kernels if key in e.key]
        ours.append(f"{label} {sum(dev_ms(e) for e in hits):.2f} ms in "
                    f"{sum(e.count for e in hits)} launches")
    top = sorted(kernels, key=dev_ms, reverse=True)[:6]
    print(f"profile: {mode} batch-8 generation under the profiler: wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms in {n_kernels} "
          f"kernel launches, idle share {1.0 - busy / wall_ms:.3f}; "
          f"{'; '.join(ours)}; on {card}")
    for e in top:
        print(f"profile: {mode}   {dev_ms(e):8.2f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def _kernel_row(name, source, replaces, launches, rows, timed="fc1"):
    """One kernel of the JSON table: timed at the d16 shape ``timed``, the
    max error over every shape it was checked at."""
    head = next(r for r in rows if r["shape"] == timed)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "timed_shape": f"{timed} M={head['M']} K={head['K']} "
                           f"N={head['N']}", "shapes": rows}


def main():
    card = phase_device()
    phase_build()
    k1_rows = phase_kernels()
    k2_rows = phase_k2()
    k3_rows = phase_k3()
    k4_rows = phase_k4()
    phase_small_reference()
    launches = phase_main_path(card)
    src = "fpqvar_tpu_torch/csrc/"
    kernels = {"kernels": [
        _kernel_row("int8_group_gemm", src + "int8_group_gemm.cu",
                    "fpqvar_tpu/ops/pallas/int8_matmul.py:185",
                    launches["K1"], k1_rows),
        _kernel_row("packed_dequant_gemm", src + "packed_dequant_gemm.cu",
                    "fpqvar_tpu/ops/pallas/quant_matmul.py:87",
                    launches["K2"], k2_rows),
        # K3 runs on the main path only at fc2 (int8ch's dual grid)
        _kernel_row("int8ch_gemm", src + "int8ch_gemm.cu",
                    "fpqvar_tpu/ops/pallas/int8_matmul.py:274",
                    launches["K3"], k3_rows, timed="fc2"),
        _kernel_row("fused_ch_gemm", src + "fused_ch_gemm.cu",
                    "fpqvar_tpu/ops/pallas/int8_matmul.py:381",
                    launches["K4"], k4_rows),
    ]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
