"""VQVAE convolution routes on a card: PyTorch's own convolution against cuDNN.

The port runs the VQVAE's float32 convolutions through PyTorch's own
im2col + cuBLAS route (``ops/precision.py`` ``conv2d_plain``) because
cuDNN reserves a workspace as large as free memory allows for the
decoder's 128 px convolutions, which a fused generation's CUDA graph pool
then holds.  This probe measures both routes on the same seeded d16 VQVAE
and inputs, with TF32 pinned off in both (``ieee_f32``):

- ``encode``: ``img_to_idxBl`` + ``idxBl_to_var_input`` of 256 px images
  in [-1, 1] (the tokenizer of training and of the quality ladder);
- ``decode``: ``decode`` of random ``f_hat`` at 16 x 16 (a generation's
  last step).

It prints one JSON line a (stage, batch, route): ``ms`` (the median of
``--reps`` timed calls after a warm-up), ``peak_bytes`` above what was
allocated before the call, ``conv_peak_bytes`` (the largest peak of one
convolution above what was allocated before it: its output and
workspace), ``convs`` and ``max_abs_diff`` of the output from the plain
route's.  Then the card's name and power limit.

    python -m fpqvar_tpu_torch.tools.conv_route_probe \\
        [--encode-batches 8] [--decode-batches 8,50] [--reps 3]

Runs on ``cuda`` unless ``--device cpu`` (``--tiny`` for ``var_tiny``'s
VQVAE); on the CPU both routes are ``F.conv2d`` and the times are the
CPU's.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

ROUTES = ("plain", "cudnn")
#: the VQVAE's weights and inputs are drawn from this seed
SEED = 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--encode-batches", default="8")
    ap.add_argument("--decode-batches", default="8,50")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _cudnn_conv(x, w, b=None, stride=1, padding=0):
    """The route the VQVAE took before ``conv2d_plain``: ``F.conv2d``
    (cuDNN on a card) in float32."""
    from fpqvar_tpu_torch.ops.precision import ieee_f32

    with ieee_f32():
        return F.conv2d(x, w, b, stride=stride, padding=padding)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _allocated(dev) -> int:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def measure(fn, dev, reps: int):
    """(median ms, peak bytes above the allocation before, output) of
    ``fn()`` after one warm-up call."""
    out = fn()
    _sync(dev)
    del out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    base = _allocated(dev)
    _reset_peak(dev)
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], max(_peak(dev) - base, 0), out


def conv_peaks(fn, dev):
    """Each convolution's peak allocation above what was allocated
    before it, over one call of ``fn`` through the VQVAE's current
    convolution."""
    from fpqvar_tpu_torch.models import vqvae as vq

    conv, seen = vq.conv2d_plain, []

    def recorded(*args, **kw):
        _sync(dev)
        before = _allocated(dev)
        _reset_peak(dev)
        y = conv(*args, **kw)
        _sync(dev)
        seen.append(max(_peak(dev) - before, 0))
        return y

    vq.conv2d_plain = recorded
    try:
        fn()
    finally:
        vq.conv2d_plain = conv
    return seen


def main(argv=None):
    args = parse_args(argv)

    from fpqvar_tpu_torch.config import var_d16, var_tiny
    from fpqvar_tpu_torch.models import vqvae as vq
    from fpqvar_tpu_torch.tools.quality_ladder import card_name

    dev = torch.device(args.device)
    cfg = (var_tiny() if args.tiny else var_d16()).vae
    vae = vq.init_vqvae_params(cfg, seed=SEED, device=dev)
    side = cfg.patch_nums[-1] * cfg.downsample
    hw = cfg.patch_nums[-1]
    plain = vq.conv2d_plain
    convs = {"plain": plain, "cudnn": _cudnn_conv}
    gen = torch.Generator(device=dev)

    def encode_fn(img):
        def run():
            idx = vq.img_to_idxBl(vae, cfg, img)
            return vq.idxBl_to_var_input(vae["quantize"], cfg, idx)
        return run

    def decode_fn(f_hat):
        return lambda: vq.decode(vae, cfg, f_hat)

    work = []
    for b in (int(v) for v in args.encode_batches.split(",") if v):
        gen.manual_seed(SEED * 1000 + b)
        img = torch.rand((b, 3, side, side), generator=gen,
                         device=dev) * 2.0 - 1.0
        work.append(("encode", b, encode_fn(img)))
    for b in (int(v) for v in args.decode_batches.split(",") if v):
        gen.manual_seed(SEED * 1000 + 500 + b)
        f_hat = torch.randn((b, cfg.z_channels, hw, hw), generator=gen,
                            device=dev)
        work.append(("decode", b, decode_fn(f_hat)))

    rows = []
    with torch.inference_mode():
        for stage, b, fn in work:
            ref = None
            for route in ROUTES:
                vq.conv2d_plain = convs[route]
                try:
                    ms, peak, out = measure(fn, dev, args.reps)
                    if ref is None:
                        ref = out.float()
                    diff = float((out.float() - ref).abs().max())
                    del out
                    seen = conv_peaks(fn, dev)
                finally:
                    vq.conv2d_plain = plain
                row = {"stage": stage, "batch": b, "route": route,
                       "ms": round(ms, 3), "peak_bytes": peak,
                       "conv_peak_bytes": max(seen), "convs": len(seen),
                       "max_abs_diff": diff}
                rows.append(row)
                print("conv_route_probe: " + json.dumps(row), flush=True)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            del ref
    print(f"conv_route_probe: on {card_name(dev)}")
    return rows


if __name__ == "__main__":
    main()
