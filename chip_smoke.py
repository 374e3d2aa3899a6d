#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fpqvar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the run exits
non-zero:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit from nvidia-smi and turns TF32 off for float32 matmuls and convs;
2. build: compiles the port's CUDA kernels K1 to K7 from ``fpqvar_tpu_torch/
   csrc`` with nvcc for sm_90a, one nvcc per source, all started together,
   prints each kernel's build time, registers and spills, and counts the
   warpgroup MMA instructions (``HGMMA``, ``IGMMA``) in each library's SASS
   (``cuobjdump -sass``): K2 and K7 must hold ``HGMMA``, K1, K3, K4, K5
   and K6 ``IGMMA``, and ptxas must not have serialized the wgmmas of any
   of them (its "wgmma ... serialized" warning);
3. kernels: K1 (the grouped int8 GEMM), K2 (the dequantize-in-register
   GEMM over packed fp4 / fp6 codes), K3 (the full-K int8 GEMM with fused
   rescale), K4 (per-token quantize inside the full-K int8 GEMM), K5 (K1's
   sum over [B, T, K] written once as bf16 or f32), K6 (the rate probe's
   full-K int8 GEMM with a bf16 output) and K7 (its bf16 GEMM) against
   their plain PyTorch versions at the VAR-d16 shapes of the last scale at
   batch 8 (M = 2*8*256 = 4096), the probe's shapes and extra cases, with
   times (back-to-back calls, and again with every call queued before the
   first starts: the kernels' device time and the host's time to queue a
   call, apart), the card's bound and a library yardstick; K3, K4 and K6 must
   equal theirs exactly, and K5 must also equal K1 followed by a cast; K4's
   two kernels (the row quantize and the s8 GEMM) are also timed apart
   under torch.profiler, and K7 is printed as a ratio to torch.matmul;
4. small reference: small generations (width 256, so every grouped linear
   has more than one scale group) under ``int8``, ``bf16``, ``packed``,
   ``w4a16p``, W6A6 on the packed backend, ``fake``, ``int8ch``,
   ``int8chs``, ``int8chsnr``, ``w4a16``, ``int8kv`` and ``int8att``, on
   the card against the same generations on the CPU: the same tokens at
   every scale, images within 1e-4;
5. main path: VAR-d16 with the full d16 VQVAE, random seeded weights,
   ``quantize_var_params`` and ``VARGenerator.generate`` for two batches of
   8 labels under ``int8``, ``bf16``, ``packed``, ``w4a16p``, ``int8ch``,
   ``int8chs``, ``int8chsnr``, ``w4a16``, ``int8kv`` and ``int8att``;
   checks images and each recipe's kernel launch counts and prints img/s,
   the host thread's CPU time inside each ``generate`` call, the KV cache's
   bytes and the peak of device memory the generations allocated above
   what was resident before them (weights and earlier recipes' leftovers);
6. profile: one more batch-8 generation under ``int8``, ``bf16``,
   ``packed``, ``int8ch``, ``int8chs`` and ``int8kv`` under
   torch.profiler, after the launch counts were read: device busy time,
   idle share, the port kernels' shares (K4's two kernels apart) and the
   kernels that take the most device time (the source of PERF.md's "Where
   the time goes");
7. serving: the d16 ``int8`` and ``bf16`` generators of phase 5 behind a
   ``GenerationServer`` (max_batch 8): one request alone, then a burst of
   20 with that request again inside it; images finite in [0, 1], the
   repeat equal to its lone twin, the depth-2 pipeline used, K5 480 and
   K1 320 launches per ``int8`` batch; one direct generation runs with
   CUDA's sync debug mode set to raise, to show that ``generate`` does not
   wait for the device; then ``tools/serving_bench.run_recipe`` under
   ``int8`` with small counts;
8. probe: ``tools/int8_rate_probe.run`` at its default shapes (library
   bf16 and int8 GEMMs, K6, K7), with the launches of K6 and K7 counted.

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
from pathlib import Path

import numpy as np
import torch

H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, H100 SXM
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_BYTES = 3.35e12         # HBM3 bandwidth, H100 SXM
KERNEL_SOURCES = ("int8_group_gemm", "packed_dequant_gemm", "int8ch_gemm",
                  "fused_ch_gemm", "int8_nd_gemm", "int8_probe_gemm",
                  "bf16_probe_gemm")
#: the sources whose GEMMs run on wgmma, and the SASS instruction of it
WGMMA_SOURCES = {"int8_group_gemm": "IGMMA", "packed_dequant_gemm": "HGMMA",
                 "int8ch_gemm": "IGMMA", "fused_ch_gemm": "IGMMA",
                 "int8_nd_gemm": "IGMMA", "int8_probe_gemm": "IGMMA",
                 "bf16_probe_gemm": "HGMMA"}
#: the last scale's block linears of VAR-d16 at batch 8: (name, M, K, N)
D16_SHAPES = (("qkv", 4096, 1024, 3072), ("proj", 4096, 1024, 1024),
              ("fc1", 4096, 1024, 4096), ("fc2", 4096, 4096, 1024))
#: K4's two kernels, (a) the row quantize and (b) the s8 GEMM, by a part
#: of their names (the GEMM by its epilogue)
K4_KERNELS = {"a": "fused_ch_quantize_kernel", "b": "FusedChRescale"}
#: the port kernels of the generation path, by parts of their kernels'
#: names: K1, K3, K4 (b) and K5 by their epilogues (K1 and K5 share one
#: wgmma instantiation's fold, K3 and K4 (b) one's rescale, each under a
#: type name of its own), K2's wgmma kernel (bf16 x) and its mma.sync one
#: (f32 x), K4's two kernels apart; no key is a part of another's
PORT_KERNELS = {"K1": ("GroupFold",),
                "K2": ("rs_gemm_kernel", "packed_dequant_gemm_kernel"),
                "K3": ("Int8ChRescale",), "K4 (a)": (K4_KERNELS["a"],),
                "K4 (b)": (K4_KERNELS["b"],), "K5": ("NdGroupSum",)}
#: the int8 rate probe's default shapes: (name, M, K, N)
PROBE_SHAPES = (("probe-1920", 4096, 1920, 5760),
                ("probe-4096", 4096, 4096, 4096))


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


def queued_ms(fn, reps: int = 20) -> tuple:
    """``(device_ms, host_ms)`` per call of ``fn()`` over ``reps`` runs
    after warm-up.  The device first sleeps for twice the host time of the
    warm-up call times ``reps`` (at 2 GHz or less), so that all runs are
    queued before the first starts: ``device_ms`` (CUDA events) is the
    kernels' time alone, where ``cuda_ms`` also holds the gaps of a call
    whose host work outlasts its kernels, and ``host_ms`` is the host's
    time to queue one call (its Python, allocations and launches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * reps * host_s, 1.0) * 2e9))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def profiled_ms(fn, keys: dict, reps: int = 20) -> dict:
    """Device ms per call of ``fn()`` of the kernels whose names hold each
    of ``keys``' values, from torch.profiler over ``reps`` calls after a
    warm-up; None where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for label, key in keys.items():
        total = sum(_self_device_us(e) for e in events if key in e.key)
        out[label] = total / 1e3 / reps if total > 0 else None
    return out


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


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

    def gmma(name):
        sass = subprocess.run([cuobjdump, "-sass", str(_build.build(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        return {op: sass.count(op) for op in ("HGMMA", "IGMMA")}

    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        secs = list(pool.map(timed, KERNEL_SOURCES))
        counts = dict(zip(KERNEL_SOURCES, pool.map(gmma, KERNEL_SOURCES)))
    for name, sec in zip(KERNEL_SOURCES, secs):
        regs = [ln.strip() for ln in
                _build.build_logs.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln]
        ops = ", ".join(f"{op} {n}" for op, n in counts[name].items())
        print(f"build: {name} for sm_90a in {sec:.2f} s, SASS {ops}: "
              f"{'; '.join(regs)}")
    print(f"build: {len(KERNEL_SOURCES)} sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, op in WGMMA_SOURCES.items():
        if counts[name][op] == 0:
            fail(f"build: {name} holds no {op} instruction: its GEMM does "
                 "not run on wgmma")
        log = _build.build_logs.get(name)
        if log is None:
            fail(f"build: no ptxas report for {name}")
        serial = [ln.strip() for ln in log.splitlines()
                  if "wgmma" in ln and "serialized" in ln]
        if serial:
            fail(f"build: ptxas serialized the wgmmas of {name}: "
                 f"{serial[0]}")


def _k1_operands(m, k, n, gen, group=128):
    """Realistic K1 operands: fp_e2 codes of a Gaussian activation and of a
    0.02-std weight, both per group of ``group``."""
    from fpqvar_tpu_torch.ops import packing as P

    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
    ac, asc = P.quant_int_codes(x, "fp_e2", group)
    pw = P.pack_int_codes(w, "fp_e2", group)
    return ac, asc, pw.codes, pw.scales


def check_and_time(label: str, row: dict, run, plain, tol, lib, nbytes: int,
                   peak: float, tol_text: str, lib_text: str,
                   int_mm=None, extras=()) -> dict:
    """Hold ``run()`` (a kernel) against ``plain()`` within ``tol()`` per
    element, or, with ``tol=None``, require the two to be equal
    (``torch.equal``); then time the kernel, its plain version, the library
    yardstick ``lib()`` (None: there is none), where given and where it
    runs the int8 yardstick ``int_mm()``, and each ``(key, fn)`` of
    ``extras`` (as ``<key>_ms``); ``row`` (shape, M, K, N, ...) gains the
    numbers.  The bound is the larger of ``nbytes`` over the memory rate
    and 2*M*N*K operations over ``peak``."""
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
    device_ms, host_ms = queued_ms(run)
    plain_ms = cuda_ms(plain, reps=5)
    lib_ms = None if lib is None else cuda_ms(lib)
    for key, fn in extras:
        row[f"{key}_ms"] = cuda_ms(fn)
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
               ms=ms, device_ms=device_ms, host_ms=host_ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    if int_mm is not None:
        row["int_mm_ms"] = int_mm_ms
    check = ("equal to the plain version" if tol is None else
             f"err/tol {worst:.3f} <= 1, tol {tol_text}")
    extra = ("" if int_mm_ms is None else
             f", int8 torch._int_mm {int_mm_ms:.4f} ms")
    extra += "".join(f", {key} {row[key + '_ms']:.4f} ms"
                     for key, _ in extras)
    lib_part = "" if lib is None else f", {lib_text} {lib_ms:.4f} ms"
    print(f"kernels: {label} {row['shape']:8s} {desc}: max err "
          f"{row['max_abs_err']:.3e} ({check}); kernel {ms:.4f} ms "
          f"(queued: device {device_ms:.4f} ms, host {host_ms:.4f} ms a "
          f"call), plain {plain_ms:.4f} ms{lib_part}{extra}, bound "
          f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    return row


def phase_kernels():
    from fpqvar_tpu_torch.ops import int8_matmul as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = [(name, m, k, n, 128) for name, m, k, n in D16_SHAPES]
    shapes += [("ragged", 16, 1024, 1000, 128),
               ("ragged-g256", 16, 1024, 1000, 256),
               ("fc2-g256", 4096, 4096, 1024, 256)]
    rows = []
    for name, m, k, n, group in shapes:
        ops = _k1_operands(m, k, n, gen, group) + (group,)
        a_bf = torch.randn((m, k), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        b_bf = torch.randn((k, n), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        g = k // group
        rows.append(check_and_time(
            "K1", {"shape": name, "M": m, "K": k, "N": n, "group": group},
            lambda: K.int8_group_gemm(*ops),
            lambda: K.int8_group_gemm_ref(*ops),
            lambda: K.int8_group_gemm_tolerance(*ops),
            lambda: torch.matmul(a_bf, b_bf),
            m * k + m * g * 4 + n * k + g * n * 4 + m * n * 4, H100_INT8_OPS,
            f"{K.K1_REL_TOL:g}*sum_g|sa*sw*part|", "bf16 torch.matmul"))
    return rows


def phase_k2():
    """K2 against ``packed_matmul_ref`` at the d16 shapes with bfloat16 x
    and e2m1 nibbles, then with e2m3 bytes, float32 x at the proj shape, a
    ragged M (16 and 144 rows: the 16-row tile, and two 128-row tiles, the
    second nearly empty), a ragged N of bytes and groups of 256.  The
    bound counts the operations at the bf16 tensor-core peak for float32 x
    too: the kernel runs its product there (x split into three exact bf16
    parts)."""
    from fpqvar_tpu_torch.ops import packing as P
    from fpqvar_tpu_torch.ops import quant_matmul as QM

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, m, k, n, "fp_e2", bf16, 128)
             for name, m, k, n in D16_SHAPES]
    cases += [(name + "-e2m3", m, k, n, "fp6_e2m3", bf16, 128)
              for name, m, k, n in D16_SHAPES]
    cases += [("proj-f32", 4096, 1024, 1024, "fp_e2", f32, 128),
              ("ragged", 16, 1024, 1024, "fp_e2", bf16, 128),
              ("m144", 144, 1024, 3072, "fp_e2", bf16, 128),
              ("ragged-e2m3", 16, 1024, 1000, "fp6_e2m3", bf16, 128),
              ("fc2-g256", 4096, 4096, 1024, "fp_e2", bf16, 256)]
    rows = []
    for name, m, k, n, fmt, dtype, group in cases:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        pw = P.pack(w, fmt, group)
        ops = (x, pw.codes, pw.scales, fmt, group, pw.nibble_packed)
        b_lib = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        x_name = str(dtype).replace("torch.", "")
        rows.append(check_and_time(
            "K2", {"shape": name, "M": m, "K": k, "N": n, "fmt": fmt,
                   "x": x_name, "nibble": pw.nibble_packed, "group": group},
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
        row = check_and_time(
            "K4", {"shape": name, "M": m, "K": k, "N": n, "fmt": fmt,
                   "x": x_name},
            lambda: K.fused_ch_gemm(*ops), lambda: K.fused_ch_gemm_ref(*ops),
            None, lambda: torch.matmul(x, b_lib),
            (x.numel() * x.element_size() + pw.codes.numel()
             + pw.scales.numel() * 4 + m * n * x.element_size()),
            H100_INT8_OPS, "", f"{x_name} torch.matmul",
            int_mm=_int_mm(m, k, n, gen))
        phases = profiled_ms(lambda: K.fused_ch_gemm(*ops), K4_KERNELS)
        row.update({f"{p}_ms": v for p, v in phases.items()})
        print(f"kernels: K4 {name:8s} phases under torch.profiler: "
              + ", ".join(f"({p}) " + ("not measured" if v is None else
                                       f"{v:.4f} ms")
                          for p, v in phases.items())
              + f"; whole call {row['ms']:.4f} ms")
        rows.append(row)
    return rows


def phase_k5():
    """K5 against ``int8_group_gemm_nd_ref`` within its tolerance, on
    ``[B, T, K]`` fp_e2 codes per group of 128: bfloat16 output at the d16
    qkv, proj and fc1 shapes of the last scale (B = 16 rows of CFG's
    doubled batch 8, T = 256), float32 output at fc1, and the first scales'
    ragged T = 9 (N = 1000) and T = 1.  K5 must also equal K1 followed by
    a cast (the route it replaces, timed beside it): the two run one
    wgmma instantiation's group fold, whose f32 sum K5 rounds once."""
    from fpqvar_tpu_torch.ops import int8_matmul as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, 16, 256, k, n, bf16) for name, _, k, n in D16_SHAPES
             if name != "fc2"]
    cases += [("fc1-f32", 16, 256, 1024, 4096, f32),
              ("ragged", 16, 9, 1024, 1000, bf16),
              ("T=1", 16, 1, 1024, 3072, bf16)]
    rows = []
    for name, b, t, k, n, out_dtype in cases:
        m, g = b * t, k // 128
        ac, asc, wc, ws = _k1_operands(m, k, n, gen)
        ac, asc = ac.reshape(b, t, k), asc.reshape(b, t, g)
        ops = (ac, asc, wc, ws, 128, out_dtype)
        k1_cast = (lambda: K.int8_group_gemm(ac.reshape(m, k),
                                             asc.reshape(m, g), wc, ws,
                                             128).to(out_dtype))
        y = K.int8_group_gemm_nd(*ops)
        if not torch.equal(y.reshape(m, n), k1_cast()):
            fail(f"K5 {name}: differs from K1 followed by a cast")
        a_bf = torch.randn((m, k), generator=gen, device="cuda", dtype=bf16)
        b_bf = torch.randn((k, n), generator=gen, device="cuda", dtype=bf16)
        out_name = str(out_dtype).replace("torch.", "")
        rows.append(check_and_time(
            "K5", {"shape": name, "B": b, "T": t, "M": m, "K": k, "N": n,
                   "out": out_name},
            lambda: K.int8_group_gemm_nd(*ops),
            lambda: K.int8_group_gemm_nd_ref(*ops),
            lambda: K.int8_group_gemm_nd_tolerance(*ops),
            lambda: torch.matmul(a_bf, b_bf),
            m * k + m * g * 4 + n * k + g * n * 4
            + m * n * (4 if out_dtype == f32 else 2), H100_INT8_OPS,
            f"{K.K1_REL_TOL:g}*sum_g|sa*sw*part| (+1 bf16 gap)",
            "bf16 torch.matmul", extras=(("k1_cast", k1_cast),)))
    return rows


#: an s8 row pair whose dot is 2^24 + 2^16 + 1: rounded to float32 and then
#: to bfloat16 (PyTorch's and JAX's conversion) it is 2^24, rounded once it
#: would be 2^24 + 2^17
WITNESS = ((127, 127, 1044), (63, 64, 1), (45, 1, 1))


def phase_k6():
    """K6 against ``int8_probe_gemm_ref`` (exact equality) on random codes
    in [-60, 60] (the probe's) at the d16 and probe shapes, and on codes
    of +-127 at K = 4096 whose signs agree in most places, so that most
    sums exceed 2^24; its first two rows and columns hold ``WITNESS`` and
    its negation, where one rounding of the exact sum would differ from
    the conversion's two.  The library yardstick is ``torch._int_mm``
    (s8 x s8 -> s32, no conversion), timed with and without ``.to(bf16)``;
    the bound counts the codes and the bf16 output."""
    from fpqvar_tpu_torch.ops import probe_gemm as PG

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    cases = [(name, m, k, n) for name, m, k, n in D16_SHAPES + PROBE_SHAPES]
    cases.append(("acc>2^24", 1024, 4096, 1024))
    rows = []
    for name, m, k, n in cases:
        if name == "acc>2^24":
            def signs(shape):
                u = torch.rand(shape, generator=gen, device="cuda")
                return torch.where(u < 0.9, 127, -127).to(torch.int8)
            a, b = signs((m, k)), signs((n, k))
            a[:2], b[:2] = 0, 0
            col = 0
            for va, vb, count in WITNESS:
                a[0, col:col + count], b[0, col:col + count] = va, vb
                col += count
            a[1], b[1] = -a[0], b[0]
        else:
            a = torch.randint(-60, 61, (m, k), generator=gen, device="cuda",
                              dtype=torch.int8)
            b = torch.randint(-60, 61, (n, k), generator=gen, device="cuda",
                              dtype=torch.int8)
        row = {"shape": name, "M": m, "K": k, "N": n}
        if name == "acc>2^24":
            y = PG.int8_probe_gemm(a, b).float()
            exact = a.double() @ b.double().T
            row["share_acc_ge_2^24"] = float(
                (exact.abs() >= 2.0 ** 24).double().mean())
            if float(y[0, 0]) != 2.0 ** 24 or float(y[1, 0]) != -2.0 ** 24:
                fail(f"K6 {name}: the witness sum converts to "
                     f"{float(y[0, 0])}, {float(y[1, 0])}, not +-2^24")
        rows.append(check_and_time(
            "K6", row, lambda: PG.int8_probe_gemm(a, b),
            lambda: PG.int8_probe_gemm_ref(a, b), None,
            lambda: torch._int_mm(a, b.t()),
            m * k + n * k + m * n * 2, H100_INT8_OPS, "",
            "int8 torch._int_mm",
            extras=(("int_mm_bf16",
                     lambda: torch._int_mm(a, b.t()).to(torch.bfloat16)),)))
    return rows


def phase_k7():
    """K7 against ``bf16_probe_gemm_ref`` within its tolerance on standard
    normal bf16 values at the d16 and probe shapes and at a ragged M = 16,
    N = 1000.  The library yardstick
    is ``torch.matmul`` of the same operands: one PyTorch call computing
    the same function (bf16 in, f32 sums, bf16 out)."""
    from fpqvar_tpu_torch.ops import probe_gemm as PG

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    rows = []
    for name, m, k, n in (D16_SHAPES + PROBE_SHAPES
                          + (("ragged", 16, 1024, 1000),)):
        a = torch.randn((m, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        b = torch.randn((n, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        row = check_and_time(
            "K7", {"shape": name, "M": m, "K": k, "N": n},
            lambda: PG.bf16_probe_gemm(a, b),
            lambda: PG.bf16_probe_gemm_ref(a, b),
            lambda: PG.bf16_probe_gemm_tolerance(a, b),
            lambda: torch.matmul(a, b.t()),
            2 * (m * k + n * k + m * n), H100_BF16_FLOPS,
            f"{PG.K7_TOL_PER_K:.3g}*K*sum_k|a*b| + 1 bf16 gap",
            "bf16 torch.matmul")
        row["over_library"] = row["ms"] / row["library_ms"]
        print(f"kernels: K7 {name:8s} / torch.matmul "
              f"{row['over_library']:.3f}, "
              f"{2 * m * n * k / row['ms'] / 1e9:.1f} TFLOP/s, "
              f"{row['bound_ms'] / row['ms']:.3f} of the bound")
        rows.append(row)
    return rows


def _small_recipes():
    """The small-reference recipes: ``bench_recipes`` entries and W6A6 on
    the packed backend."""
    from fpqvar_tpu_torch.config import bench_recipes, fpqvar_w6a6

    recipes = {m: bench_recipes()[m]
               for m in ("int8", "bf16", "packed", "w4a16p", "fake", "int8ch",
                         "int8chs", "int8chsnr", "w4a16", "int8kv",
                         "int8att")}
    recipes["w6a6-packed"] = fpqvar_w6a6().replace(backend="packed")
    return recipes


def phase_small_reference():
    """Width-256 generations (every grouped linear has more than one scale
    group) on the card against the same generations on the CPU, at top_k=1
    and float32 compute: the sampled tokens of every scale must be the
    same, and the images within 1e-4.

    ``int8att`` rounds q and the softmax weights to int8 codes, so a
    last-bit difference between the card's and the CPU's float32 scores
    (sums in another order) can move one code by one step, 1/127 of its
    row's absmax: a shift of the logits' last bits that changes an argmax
    only where two logits lie that close.  Its images need no wider
    bound than the others': at top_k=1 with the same tokens, ``f_hat`` and
    the image depend on the tokens alone, through the VQVAE, whose float32
    convolutions the 1e-4 bound covers.  So the phase holds the tokens
    identical for every recipe and prints the largest logit difference
    beside the images' (for ``int8att`` the trace of such steps)."""
    from fpqvar_tpu_torch.config import GenerateConfig, var_tiny
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.models import var as V
    from fpqvar_tpu_torch.quantize import quantize_var_params

    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))
    params = init_var_params(cfg, seed=4, device="cpu", adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=5, device="cpu")
    labels = [3, 5, 7]
    sample = V.sample_with_top_k_top_p
    seen = []

    def recorded(logits, *args, **kw):
        idx = sample(logits, *args, **kw)
        seen.append((idx.cpu(), logits.float().cpu()))
        return idx

    V.sample_with_top_k_top_p = recorded
    try:
        for mode, q in _small_recipes().items():
            out, steps = {}, {}
            for dev in ("cpu", "cuda"):
                qp = quantize_var_params(_to(params, dev), cfg, q, galt=galt)
                g = VARGenerator(cfg, q, GenerateConfig(top_k=1, top_p=0.0),
                                 cache_dtype=torch.float32,
                                 compute_dtype=torch.float32, device=dev)
                seen.clear()
                out[dev] = g.generate(qp, _to(vae, dev), labels).cpu()
                steps[dev] = list(seen)
            err = float((out["cpu"] - out["cuda"]).abs().max())
            if out["cuda"].shape != (3, 3, 6, 6) or not err <= 1e-4:
                fail(f"small {mode} generation: card vs CPU max err {err}")
            if len(steps["cuda"]) != cfg.num_scales or not all(
                    torch.equal(a[0], b[0])
                    for a, b in zip(steps["cpu"], steps["cuda"])):
                fail(f"small {mode} generation: card and CPU sampled other "
                     "tokens at top_k=1")
            lerr = max(float((a[1] - b[1]).abs().max())
                       for a, b in zip(steps["cpu"], steps["cuda"]))
            print(f"small reference: {mode} width-256 generation, card vs "
                  f"CPU: tokens identical at all {cfg.num_scales} scales, "
                  f"logits max diff {lerr:.3e}, images max err {err:.3e} "
                  "(tol 1e-4)")
    finally:
        V.sample_with_top_k_top_p = sample


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
            "K4": ("int8_matmul", "fused_launches"),
            "K5": ("int8_matmul", "nd_launches"),
            "K6": ("probe_gemm", "int8_launches"),
            "K7": ("probe_gemm", "bf16_launches")}
#: the recipes profiled after the main path (phase 6)
PROFILED = ("int8", "bf16", "packed", "int8ch", "int8chs", "int8kv")


def _counter_modules():
    from fpqvar_tpu_torch.ops import int8_matmul, probe_gemm, quant_matmul

    return {"int8_matmul": int8_matmul, "quant_matmul": quant_matmul,
            "probe_gemm": probe_gemm}


def reset_counts():
    mods = _counter_modules()
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)


def read_counts() -> dict:
    mods = _counter_modules()
    return {k: getattr(mods[mod], attr) for k, (mod, attr) in COUNTERS.items()}


def phase_main_path(card: str):
    """Each recipe's generations with every launch count set to 0 just
    before them and read just after: K1 and K5 run exactly under ``int8``,
    K2 exactly under ``packed`` and ``w4a16p``, K3 and K4 exactly under the
    per-channel recipes (``int8kv`` and ``int8att`` as ``int8ch``: the
    packed KV cache adds no kernel), K6 and K7 under none.  Returns the
    launch totals, the profiled recipes' (gen, params, generator) and the
    VQVAE params."""
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
    # one call): int8 runs qkv, proj and fc1 through K5 and fc2 as two K1
    # GEMMs (dual grid); packed fake-quantizes fc2's dual grid first and
    # runs one K2 GEMM; int8ch runs K4 on qkv, proj and fc1 and fc2's dual
    # grid as two K3 GEMMs; int8chs and int8chsnr run K4 on all four; w4a16
    # runs no kernel (wonly_dot); int8kv and int8att are int8ch with the
    # packed KV cache
    none = {k: 0 for k in COUNTERS}
    per_gen = {"int8": {**none, "K1": blocks * 2, "K5": blocks * 3},
               "bf16": none,
               "packed": {**none, "K2": blocks * 4},
               "w4a16p": {**none, "K2": blocks * 4},
               "int8ch": {**none, "K3": blocks * 2, "K4": blocks * 3},
               "int8chs": {**none, "K4": blocks * 4},
               "int8chsnr": {**none, "K4": blocks * 4},
               "w4a16": none,
               "int8kv": {**none, "K3": blocks * 2, "K4": blocks * 3},
               "int8att": {**none, "K3": blocks * 2, "K4": blocks * 3}}
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
        times, host_cpu = [], []
        kv_bytes = sum(t.nbytes for t in gen.init_cache(batch).values())
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for i in range(n_batches):
            labels = torch.arange(i * batch, (i + 1) * batch, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c0 = time.thread_time()
            imgs = gen.generate(qp, vae, labels, rng_gen)
            # the host thread's own work in the call (generate only queues)
            host_cpu.append(time.thread_time() - c0)
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
        peak = torch.cuda.max_memory_allocated() - resident
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
              f"warm-up), host CPU ms in generate "
              f"{', '.join(f'{t * 1e3:.1f}' for t in host_cpu)}; steady "
              f"{batch / steady:.2f} img/s; launches per "
              f"generation {per}; KV cache {kv_bytes} bytes "
              f"({kv_bytes / 1e6:.1f} MB), peak allocated above the "
              f"{resident / 1e9:.3f} GB resident before the generations "
              f"{peak} bytes ({peak / 1e9:.3f} GB); images [{batch}, 3, 256, "
              f"256] finite in [0, 1]; on {card}")
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
                      card, per_gen[mode])
    return totals, setups, vae


def phase_profile(mode: str, run, card: str, launches: dict):
    """Where one generation's time goes: torch.profiler over one batch-8
    generation (after the main path's counts were read), summing the device
    time of every CUDA kernel; each port kernel must show as many launches
    as the generation makes (``launches``, by K1..K7), so that its time is
    found under its name."""
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
        return _self_device_us(e) / 1e3

    busy = sum(dev_ms(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    if busy <= 0.0:
        print(f"profile: {mode}: device time not measured (the profiler "
              f"recorded no kernel time); wall {wall_ms:.1f} ms")
        return
    ours = []
    for label, keys in PORT_KERNELS.items():
        hits = [e for e in kernels if any(k in e.key for k in keys)]
        n = sum(e.count for e in hits)
        want = launches[label.split()[0]]
        if n != want:
            fail(f"profile: {mode}: {n} kernels named like {label} "
                 f"({', '.join(keys)}), {want} launches expected")
        ms = sum(dev_ms(e) for e in hits)
        ours.append(f"{label} {ms:.2f} ms in {n} launches "
                    f"({ms / busy:.3f} of busy)")
    top = sorted(kernels, key=dev_ms, reverse=True)[:6]
    print(f"profile: {mode} batch-8 generation under the profiler: wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms in {n_kernels} "
          f"kernel launches, idle share {1.0 - busy / wall_ms:.3f}; "
          f"{'; '.join(ours)}; on {card}")
    for e in top:
        print(f"profile: {mode}   {dev_ms(e):8.2f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def _images_ok(label: str, img, shape) -> None:
    if tuple(img.shape) != shape:
        fail(f"{label}: image of shape {tuple(img.shape)}, expected {shape}")
    if not bool(torch.isfinite(img).all()):
        fail(f"{label}: non-finite image values")
    lo, hi = float(img.min()), float(img.max())
    if lo < 0.0 or hi > 1.0:
        fail(f"{label}: image values outside [0, 1]: {lo}, {hi}")


def phase_serving(setups, vae, card: str):
    """The d16 ``int8`` and ``bf16`` generators of the main path behind a
    ``GenerationServer`` with max_batch 8, with the launch counts set to 0
    just before each recipe and read just after.  Beside it, direct batch-8
    generations on the main thread, timed in the same phase: with one
    generator and with one per row (the server's call)."""
    from fpqvar_tpu_torch.config import bench_recipes
    from fpqvar_tpu_torch.serving import GenerationServer, row_seed
    from fpqvar_tpu_torch.tools import serving_bench

    max_batch, n_burst, repeat_at = 8, 20, 11
    for mode in ("int8", "bf16"):
        gen, qp, _ = setups[mode]
        blocks = gen.cfg.depth * gen.cfg.num_scales
        # generate only queues work: with CUDA's sync debug mode set to
        # raise, one direct call with per-row generators must not wait
        labels = torch.arange(max_batch, device="cuda")

        def row_gens():
            gens = []
            for i in range(max_batch):
                g = torch.Generator(device="cuda")
                g.manual_seed(row_seed(0, i))
                gens.append(g)
            return gens

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gen.generate(qp, vae, labels, row_gens())
        finally:
            torch.cuda.set_sync_debug_mode("default")

        def direct(gens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.generate(qp, vae, labels, gens)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        one = torch.Generator(device="cuda")
        one.manual_seed(3)
        t_one = min(direct(one) for _ in range(2))
        t_rows = min(direct(row_gens()) for _ in range(2))

        server = GenerationServer(gen, qp, vae, max_batch=max_batch,
                                  max_wait_ms=30.0)
        try:
            reset_counts()
            lone = server.submit(207, 5).result()
            st0 = server.stats()
            t0 = time.perf_counter()
            subs = []
            for i in range(n_burst):
                req = (207, 5) if i == repeat_at else (i * 37 % 1000, 100 + i)
                subs.append((time.perf_counter(), server.submit(*req)))
            imgs, lat = [], []
            for ts, fut in subs:
                imgs.append(fut.result())
                lat.append(time.perf_counter() - ts)
            wall = time.perf_counter() - t0
            st = server.stats()
            counts = read_counts()
        finally:
            server.stop()
        for i, img in enumerate([lone] + imgs):
            _images_ok(f"serving {mode} request {i}", img, (3, 256, 256))
        if not torch.equal(imgs[repeat_at], lone):
            diff = float((imgs[repeat_at] - lone).abs().max())
            fail(f"serving {mode}: the repeated request differs from its "
                 f"lone twin (max diff {diff})")
        burst_batches = st["batches"] - st0["batches"]
        pipelined = st["pipelined"] - st0["pipelined"]
        if pipelined < 1:
            fail(f"serving {mode}: the burst was never pipelined ({st})")
        batches = st["batches"]
        want = {k: 0 for k in COUNTERS}
        if mode == "int8":
            want.update(K1=blocks * 2 * batches, K5=blocks * 3 * batches)
        if counts != want:
            fail(f"serving {mode}: launches {counts} over {batches} batches, "
                 f"expected {want}")
        lat_ms = np.asarray(lat) * 1e3
        rate = n_burst / wall
        print(f"serving: {mode}: direct batch-{max_batch} generate, best of "
              f"2: {t_one * 1e3:.1f} ms with one generator, "
              f"{t_rows * 1e3:.1f} ms with one per row "
              f"({max_batch / t_rows:.3f} img/s)")
        print(f"serving: {mode}: lone request and a burst of {n_burst} "
              f"(max_batch {max_batch}): saturated {rate:.3f} img/s "
              f"({rate * t_rows / max_batch:.3f}x direct per-row generate; "
              f"{n_burst}/{burst_batches * max_batch} rows are requests), "
              f"burst wall {wall * 1e3:.1f} ms, latency p50 "
              f"{np.percentile(lat_ms, 50):.1f} ms p99 "
              f"{np.percentile(lat_ms, 99):.1f} ms, {burst_batches} burst "
              f"batches, pipelined {pipelined}; repeat equal to its lone "
              f"twin; launches per batch "
              + ", ".join(f"{k} {n // batches}" for k, n in counts.items()
                          if n)
              + f"; generate queued without a host sync; on {card}")
    res = serving_bench.run_recipe(gen.cfg, bench_recipes()["int8"], vae,
                                   salt=12345, n=16, unloaded=2, poisson=0,
                                   max_batch=max_batch)
    brief = {k: ({kk: vv for kk, vv in v.items() if kk != "samples_ms"}
                 if isinstance(v, dict) else v) for k, v in res.items()}
    print(f"serving: tools/serving_bench.run_recipe int8 d16 (n 16, "
          f"unloaded 2, max_batch {max_batch}) on {card}: "
          f"{json.dumps(brief)}")


def phase_probe(card: str):
    """``tools/int8_rate_probe.run`` at its default shapes, with the launch
    counts set to 0 just before and read just after: every leg of K6 and
    K7 is one warm-up call and 5 windows of 100 calls a shape."""
    from fpqvar_tpu_torch.tools import int8_rate_probe

    iters, windows = 100, int8_rate_probe.WINDOWS
    reset_counts()
    rows = int8_rate_probe.run(int8_rate_probe.DEFAULT_SHAPES, iters=iters)
    counts = read_counts()
    n_shapes = len(PROBE_SHAPES)
    want = {k: 0 for k in COUNTERS}
    want.update(K6=n_shapes * (1 + iters * windows),
                K7=n_shapes * (1 + iters * windows))
    if counts != want:
        fail(f"probe: launches {counts}, expected {want}")
    print("probe: " + "; ".join(
        f"{r['shape']} {r['leg']} "
        + (f"{r['rate']:.1f} T(FL)OP/s" if "rate" in r else "did not run")
        for r in rows) + f"; on {card}")
    return counts


def _kernel_row(name, source, replaces, launches, rows, timed="fc1"):
    """One kernel of the JSON table: timed at the d16 shape ``timed``, the
    max error over every shape it was checked at."""
    head = next(r for r in rows if r["shape"] == timed)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "host_ms": head["host_ms"], "plain_ms": head["plain_ms"],
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
    k5_rows = phase_k5()
    k6_rows = phase_k6()
    k7_rows = phase_k7()
    phase_small_reference()
    launches, setups, vae = phase_main_path(card)
    phase_serving(setups, vae, card)
    del setups
    probe_launches = phase_probe(card)
    src = "fpqvar_tpu_torch/csrc/"
    kernels = {"kernels": [
        # K1 runs on the main path only at fc2 (int8's dual grid)
        _kernel_row("int8_group_gemm", src + "int8_group_gemm.cu",
                    "fpqvar_tpu/ops/pallas/int8_matmul.py:185",
                    launches["K1"], k1_rows, timed="fc2"),
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
        _kernel_row("int8_nd_gemm", src + "int8_nd_gemm.cu",
                    "fpqvar_tpu/ops/pallas/int8_matmul.py:117",
                    launches["K5"], k5_rows),
        # K6 and K7 run on the rate probe's path (phase 8)
        _kernel_row("int8_probe_gemm", src + "int8_probe_gemm.cu",
                    "scripts/int8_rate_probe.py:106",
                    probe_launches["K6"], k6_rows, timed="probe-4096"),
        _kernel_row("bf16_probe_gemm", src + "bf16_probe_gemm.cu",
                    "scripts/int8_rate_probe.py:148",
                    probe_launches["K7"], k7_rows, timed="probe-4096"),
    ]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
