"""int8 GEMM rate probe: does an int8 GEMM beat bf16 on this stack?

For each ``MxKxN`` shape it times four legs on the card and prints one
T(FL)OP/s line each (2*M*K*N operations per call):

- ``bf16-torch.matmul``: the library bf16 GEMM (a yardstick);
- ``int8-torch._int_mm``: the library s8 x s8 -> s32 GEMM (a yardstick);
- ``int8-k6-<tile>``: kernel K6 (``ops/probe_gemm.int8_probe_gemm``), the
  port of the probe's Pallas int8 kernel (full-K int32 accumulator, bf16
  output);
- ``bf16-k7-<tile>``: kernel K7 (``ops/probe_gemm.bf16_probe_gemm``), the
  port of its Pallas bf16 kernel, the control for what a hand-written
  kernel costs against the library.

The TPU probe swept Pallas tilings; the tile of each CUDA kernel is fixed
when it is compiled, and the leg names it (BM x BN x BK, BK in elements).

Timing: CUDA events around ``iters`` back-to-back launches on the same
inputs, the median of 5 such windows after a warm-up.  The TPU probe needed
two defences that eager CUDA does not: a dependent carry between its
iterations (inside one jitted loop, XLA dropped matmul work whose output
was unused) and inputs perturbed per window (its remote runtime memoized
whole calls).  Here every launch is a separate kernel that runs in full,
whether or not its output is read, and nothing caches results.  A
library leg that fails (``torch._int_mm`` is missing on some builds or
shapes) is reported and skipped; a K6 or K7 leg that fails raises.

    python -m fpqvar_tpu_torch.tools.int8_rate_probe \\
        [--iters 100] [--shapes 4096x1920x5760,4096x4096x4096]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fpqvar_tpu_torch.ops import probe_gemm as PG

DEFAULT_SHAPES = "4096x1920x5760,4096x4096x4096"
#: the compiled tiles of K6 and K7 (csrc/int8_probe_gemm.cu,
#: csrc/bf16_probe_gemm.cu), BM x BN x BK with BK in elements
K6_TILE = "128x256x128"
K7_TILE = "128x256x64"
#: timed windows per leg; the leg's time is their median
WINDOWS = 5


def parse_shapes(text: str):
    """``"MxKxN,..."`` -> [(M, K, N), ...]."""
    return [tuple(int(v) for v in sh.split("x")) for sh in text.split(",")]


def time_leg(fn, iters: int) -> float:
    """Median over ``WINDOWS`` of the mean device time of one call (ms),
    each window ``iters`` back-to-back calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def run(shapes=DEFAULT_SHAPES, iters: int = 100, device="cuda"):
    """Time every leg at every shape on ``device`` (a CUDA device), print
    one line per leg and return the rows: ``{"shape", "leg", "ms",
    "rate"}`` with ``rate`` in T(FL)OP/s, or ``"error"`` for a library leg
    that did not run."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the rate probe measures a CUDA device; none is "
                           "available")
    if isinstance(shapes, str):
        shapes = parse_shapes(shapes)
    print(f"int8 rate probe on {torch.cuda.get_device_name(dev)}: "
          f"{iters} calls a window, median of {WINDOWS} windows",
          flush=True)
    rows = []
    for m, k, n in shapes:
        ops = 2.0 * m * k * n
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        xb = torch.randn((m, k), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        wb = torch.randn((k, n), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        xi = torch.randint(-60, 61, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wi = torch.randint(-60, 61, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        # K6, K7 and torch._int_mm take the second operand K-contiguous:
        # transposed once here, outside the timed windows
        wb_nk = wb.t().contiguous()
        wi_nk = wi.t().contiguous()
        print(f"== {m}x{k}x{n} ({ops / 1e12:.4f} T(FL)OP a call) ==",
              flush=True)
        legs = [("bf16-torch.matmul", True, lambda: torch.matmul(xb, wb)),
                ("int8-torch._int_mm", True,
                 lambda: torch._int_mm(xi, wi_nk.t())),
                (f"int8-k6-{K6_TILE}", False,
                 lambda: PG.int8_probe_gemm(xi, wi_nk)),
                (f"bf16-k7-{K7_TILE}", False,
                 lambda: PG.bf16_probe_gemm(xb, wb_nk))]
        for name, library, fn in legs:
            row = {"shape": f"{m}x{k}x{n}", "leg": name}
            try:
                ms = time_leg(fn, iters)
            except RuntimeError as e:
                if not library:
                    raise
                row["error"] = str(e).splitlines()[0][:200]
                print(f"  {name:24s} FAILED (a yardstick, skipped): "
                      f"{row['error']}", flush=True)
            else:
                row.update(ms=ms, rate=ops / (ms * 1e-3) / 1e12)
                print(f"  {name:24s} {row['rate']:8.1f} T(FL)OP/s "
                      f"({ms:.4f} ms a call)", flush=True)
            rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--shapes", type=str, default=DEFAULT_SHAPES)
    args = ap.parse_args(argv)
    run(args.shapes, args.iters)


if __name__ == "__main__":
    main()
