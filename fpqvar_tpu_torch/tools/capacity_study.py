"""Per-mode max-batch capacity study: device memory -> throughput.

The port's ``scripts/capacity_study.py``, with its flags, its search and
its JSON lines, plus ``--device`` (default ``cuda``) and ``--out``.  Low-bit
storage buys memory: int8 weight codes (2x), packed fp4 codes (4x) and a
packed int8 KV cache (~2x at d36-512's L = 2240) leave room for more batch
rows, and images/s keeps rising with the batch until the card's math
saturates.  A same-batch comparison therefore understates a quantized
mode wherever ``bf16`` is the first to run out of memory.

The study finds each mode's largest batch that fits by doubling from
``--start`` up to ``--cap``, then one bisection probe between the last fit
and the first out-of-memory batch, and reports images/s at each mode's
best batch.  Every (mode, batch) probe runs in a FRESH PROCESS (this
module with ``--probe``), one at a time: an out-of-memory error must not
leave the parent's allocator in a bad state, and two probes must not share
device memory.

The probe builds the mode's tree on the device
(``quantize.recipe.synth_device_params``, seed 0, GALT vectors of ones
where the mode transforms, so that the online GALT multiply is paid), a
seed-1 VQVAE cast to bf16, and a ``VARGenerator`` in its default fused
mode (CUDA graphs).  One warm-up generation (the engine's eager warm-up,
then the capture of its two graphs), then ``--rounds`` generations, each
timed on the host clock up to a synchronize: img/s = batch / median.  The
images must be finite.  It prints one JSON line (``PROBE_TAG``, then the
record): the rate, ``torch.cuda.max_memory_allocated`` and
``max_memory_reserved``, the bytes of the weights and of the KV cache of
2 * batch rows (``VARGenerator.init_cache``; both from the real tensors),
the graphs' pool bytes, the allocated and reserved bytes where the
capture starts, and the port kernels' launches in the eager
warm-up and in the capture (the host counters of
``latency_breakdown.read_launches``).  It catches PyTorch's out-of-memory
error itself and says so on a line of its own (``OOM_LINE``); the parent
takes a probe for out-of-memory by that line or by JAX's ``OOM_MARKERS``
in its errors.  Any other failure (a launch error, an illegal address,
non-finite images, a timeout) raises in the parent.  There is no
fallback: no CPU, no plain version, no eager mode to fit more.

    python -m fpqvar_tpu_torch.tools.capacity_study --preset d36
    python -m fpqvar_tpu_torch.tools.capacity_study --preset d16 \\
        --cap 256 --out capacity.json --study-key d16
    python -m fpqvar_tpu_torch.tools.capacity_study --preset tiny \\
        --device cpu --modes bf16,int8 --cap 4 --rounds 1

Writes one JSON line per mode and a final summary line to stdout, JAX's
keys and rounding.  ``--out`` also writes every probe's record as JSON
(``--study-key K``: merged into ``--out`` under ``K``, beside the card's
name and power limit).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
               "OOM", "Resource exhausted")
#: the prefix of a probe's result line
PROBE_TAG = "capacity-probe-result "
#: the line a probe prints where the device memory ran out
OOM_LINE = "capacity-probe: device memory exhausted"
#: the study's first batch per preset
START = {"tiny": 2, "d16": 8, "d30": 8, "d36": 2}


# ---------------------------------------------------------------------------
# The probe (child process)
# ---------------------------------------------------------------------------

def tensor_bytes(tree) -> int:
    """Bytes of every tensor of a tree of dicts, lists, tuples and
    dataclasses (``IntPack``, ``PackedTensor``)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tensor_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def measure(preset: str, mode: str, batch: int, rounds: int,
            device: str) -> dict:
    """One (mode, batch) reading in this process (module docstring)."""
    import numpy as np
    import torch

    from fpqvar_tpu_torch.config import GenerateConfig, bench_recipes
    from fpqvar_tpu_torch.models import VARGenerator
    from fpqvar_tpu_torch.models.vqvae import init_vqvae_params
    from fpqvar_tpu_torch.quantize.recipe import synth_device_params, to_bf16
    from fpqvar_tpu_torch.tools.latency_breakdown import (build_cfg,
                                                          read_launches)

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = build_cfg(preset)
    qcfg = bench_recipes()[mode]
    galt = tuple(np.ones((cfg.depth, cfg.width), np.float32)
                 for _ in range(2))
    params = synth_device_params(cfg, qcfg, seed=0, galt=galt, device=dev)
    vae_p = to_bf16(init_vqvae_params(cfg.vae, seed=1, device=dev))
    eng = VARGenerator(cfg, qcfg, GenerateConfig(), device=dev)
    cache = eng.init_cache(batch)
    weight_bytes, cache_bytes = tensor_bytes(params), tensor_bytes(cache)
    del cache
    sync()
    resident = torch.cuda.memory_allocated(dev) if cuda else None

    # the launch counters after each VQVAE decode: the first fused call
    # decodes once in its eager warm-up and once in its capture (on the
    # CPU, once: no capture); and the allocator's allocated and reserved
    # bytes where the capture of the steps graph starts (after the
    # warm-up and the engine's empty_cache)
    marks, at_capture = [], []
    decode, steps = eng._decode, eng._steps

    def counted_decode(vae_params, f_hat):
        out = decode(vae_params, f_hat)
        marks.append(read_launches())
        return out

    def marked_steps(*a, **kw):
        if cuda and torch.cuda.is_current_stream_capturing():
            at_capture.append((torch.cuda.memory_allocated(dev),
                               torch.cuda.memory_reserved(dev)))
        return steps(*a, **kw)

    eng._decode, eng._steps = counted_decode, marked_steps
    label = torch.arange(batch, device=dev) % cfg.num_classes
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    start = read_launches()
    t0 = time.perf_counter()
    img = eng.generate(params, vae_p, label, gen)
    sync()
    first_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(img).all())
    warmup = _delta(marks[0], start)
    capture = _delta(marks[1], marks[0]) if len(marks) > 1 else None
    eng._decode, eng._steps = decode, steps
    dts = []
    for r in range(rounds):
        gen.manual_seed(1 + r)
        sync()
        t0 = time.perf_counter()
        img = eng.generate(params, vae_p, label, gen)
        sync()
        dts.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(img).all())
    if not finite:
        raise RuntimeError(f"{mode} batch={batch}: non-finite images")
    median = float(np.median(dts))
    stats = eng.capture_stats(batch)
    return {
        "preset": preset, "mode": mode, "batch": batch, "rounds": rounds,
        "ips": batch / median, "median_s": median, "round_s": dts,
        "first_call_s": first_s, "images_finite": finite,
        "image_shape": list(img.shape),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if cuda else None),
        "max_memory_reserved": (torch.cuda.max_memory_reserved(dev)
                                if cuda else None),
        "resident_bytes": resident,
        "capture_start_allocated": at_capture[0][0] if at_capture else None,
        "capture_start_reserved": at_capture[0][1] if at_capture else None,
        "weight_bytes": weight_bytes, "cache_bytes": cache_bytes,
        "static_bytes": weight_bytes + cache_bytes,
        "pool_bytes": stats.get("pool_bytes"),
        "warmup_s": stats.get("warmup_s"), "capture_s": stats.get("capture_s"),
        "warmup_launches": warmup, "capture_launches": capture,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }


def probe_main(args) -> int:
    """The child: one reading, printed as ``PROBE_TAG`` + JSON, or
    ``OOM_LINE`` (exit code 3) where the device memory ran out."""
    import torch

    try:
        rec = measure(args.preset, args.mode, args.batch, args.rounds,
                      args.device)
    except torch.cuda.OutOfMemoryError as e:
        print(OOM_LINE, flush=True)
        print(str(e).splitlines()[0] if str(e) else repr(e),
              file=sys.stderr, flush=True)
        return 3
    print(PROBE_TAG + json.dumps(rec), flush=True)
    return 0


# ---------------------------------------------------------------------------
# The study (parent process)
# ---------------------------------------------------------------------------

def _gb(n) -> str:
    return "n/a" if n is None else f"{n / 2**30:.2f}"


def _static(rec: dict) -> str:
    """The probe's memory in one parenthesis for the log line (GiB)."""
    return (f"(peak allocated {_gb(rec['max_memory_allocated'])}, reserved "
            f"{_gb(rec['max_memory_reserved'])}, weights "
            f"{_gb(rec['weight_bytes'])}, KV cache {_gb(rec['cache_bytes'])}"
            f", graph pool {_gb(rec['pool_bytes'])} GiB)")


def probe(preset: str, mode: str, batch: int, rounds: int, timeout: int,
          device: str = "cuda") -> dict:
    """One (mode, batch) measurement in a fresh process.

    Returns {"ok": True, "ips": float, "static": str, "record": dict} or
    {"ok": False, "oom": bool, "err": tail}.
    """
    cmd = [sys.executable, "-m", "fpqvar_tpu_torch.tools.capacity_study",
           "--probe", "--preset", preset, "--mode", mode,
           "--batch", str(batch), "--rounds", str(rounds),
           "--device", device]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=REPO)
    except subprocess.TimeoutExpired:
        return {"ok": False, "oom": False, "err": "probe timeout"}
    if r.returncode == 0:
        line = [l for l in r.stdout.splitlines()
                if l.startswith(PROBE_TAG)][-1]
        rec = json.loads(line[len(PROBE_TAG):])
        return {"ok": True, "ips": float(rec["ips"]), "static": _static(rec),
                "record": rec}
    tail = r.stderr.strip().splitlines()[-15:]
    oom = (OOM_LINE in r.stdout.splitlines()
           or any(mk in r.stderr for mk in OOM_MARKERS))
    return {"ok": False, "oom": oom, "err": "\n".join(tail)}


def find_max_batch(preset: str, mode: str, start: int, cap: int,
                   rounds: int, timeout: int, device: str = "cuda",
                   records: dict = None):
    """Doubling search up from `start`, then one bisection probe between
    the last fit and the first out-of-memory batch (JAX's search, probe
    for probe).  Returns {batch: img/s} of the batches that fit; each
    probe's record (or ``{"oom": True}``) goes into ``records`` by batch
    where one is given."""
    records = {} if records is None else records
    results = {}          # batch -> ips
    batch, last_ok, first_bad = start, None, None
    while batch <= cap:
        print(f"# probe {mode} batch={batch} ...", file=sys.stderr,
              flush=True)
        r = probe(preset, mode, batch, rounds, timeout, device)
        if r["ok"]:
            results[batch] = r["ips"]
            records[batch] = r.get("record")
            print(f"#   fits: {r['ips']:.3f} img/s {r['static']}",
                  file=sys.stderr, flush=True)
            last_ok, batch = batch, batch * 2
        else:
            if not r["oom"]:
                raise RuntimeError(
                    f"{mode} batch={batch} failed (not OOM):\n{r['err']}")
            print("#   OOM", file=sys.stderr, flush=True)
            records[batch] = {"oom": True, "err": r["err"]}
            first_bad = batch
            break
    if last_ok is not None and first_bad is not None:
        mid = (last_ok + first_bad) // 2
        if mid not in results and mid != last_ok:
            print(f"# probe {mode} batch={mid} (bisect) ...",
                  file=sys.stderr, flush=True)
            r = probe(preset, mode, mid, rounds, timeout, device)
            if r["ok"]:
                results[mid] = r["ips"]
                records[mid] = r.get("record")
                print(f"#   fits: {r['ips']:.3f} img/s {r['static']}",
                      file=sys.stderr, flush=True)
            else:
                records[mid] = {"oom": r["oom"], "err": r["err"]}
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="d36",
                    choices=["tiny", "d16", "d30", "d36"])
    ap.add_argument("--modes", default=None,
                    help="comma list of config.bench_recipes names "
                         "(default: bf16,int8kv for d36; "
                         "bf16,int8chs,packed otherwise)")
    ap.add_argument("--start", type=int, default=None,
                    help="first batch to probe (default: preset batch)")
    ap.add_argument("--cap", type=int, default=64,
                    help="largest batch to attempt")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=3600,
                    help="per-probe wall clock (covers a first nvcc build)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write every probe's record as JSON here")
    ap.add_argument("--study-key", default=None,
                    help="merge the records into --out under this key, "
                         "beside the card's name and power limit")
    # the child's own flags
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mode", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--batch", type=int, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _write(args, argv, doc: dict) -> None:
    from fpqvar_tpu_torch.tools.quality_ladder import card_name

    doc = {"card": card_name(args.device),
           "argv": sys.argv[1:] if argv is None else list(argv), **doc}
    if args.study_key:
        whole = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                whole = json.load(f)
        whole[args.study_key] = doc
        doc = whole
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)


def main(argv=None) -> dict:
    """The study (or, with ``--probe``, one child's reading).  Returns
    ``{"modes": {mode: JAX's per-mode summary}, "probes": {mode: {batch:
    record}}, "summary": the summary line or None}``."""
    args = parse_args(argv)
    if args.probe:
        sys.exit(probe_main(args))

    if args.modes:
        modes = args.modes.split(",")
    elif args.preset == "d36":
        modes = ["bf16", "int8kv"]
    else:
        modes = ["bf16", "int8chs", "packed"]
    start = args.start or START[args.preset]

    summary, probes, line = {}, {}, None
    for mode in modes:
        probes[mode] = {}
        curve = find_max_batch(args.preset, mode, start, args.cap,
                               args.rounds, args.timeout, args.device,
                               probes[mode])
        if not curve:
            raise RuntimeError(f"{mode}: starting batch {start} already OOMs")
        best_b = max(curve, key=lambda b: curve[b])
        summary[mode] = {"max_batch": max(curve), "best_batch": best_b,
                         "best_ips": round(curve[best_b], 3),
                         "curve": {str(b): round(v, 3)
                                   for b, v in sorted(curve.items())}}
        print(json.dumps({"mode": mode, **summary[mode]}), flush=True)

    if "bf16" in summary and len(summary) > 1:
        quant = {m: s for m, s in summary.items() if m != "bf16"}
        best_m = max(quant, key=lambda m: quant[m]["best_ips"])
        line = {
            "metric": f"capacity study VAR-{args.preset}: best "
                      f"images/sec/chip at each mode's own max batch "
                      f"(bf16 b={summary['bf16']['best_batch']} vs "
                      f"{best_m} b={quant[best_m]['best_batch']})",
            "value": quant[best_m]["best_ips"],
            "unit": "images/sec/chip",
            "vs_baseline": round(
                quant[best_m]["best_ips"] / summary["bf16"]["best_ips"], 4),
        }
        print(json.dumps(line), flush=True)
    out = {"modes": summary,
           "probes": {m: {str(b): r for b, r in sorted(p.items())}
                      for m, p in probes.items()},
           "summary": line}
    if args.out:
        _write(args, argv, {"preset": args.preset, "start": start,
                            "cap": args.cap, "rounds": args.rounds, **out})
    return out


if __name__ == "__main__":
    main()
