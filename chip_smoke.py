#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fpqvar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the run exits
non-zero:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit from nvidia-smi and turns TF32 off for float32 matmuls and convs;
2. build: compiles the port's CUDA kernels K1 to K7, the quantizers
   Q1 to Q3 and the attention A1 from ``fpqvar_tpu_torch/csrc`` with nvcc
   for sm_90a, one nvcc per source, all started together,
   prints each kernel's build time, registers and spills, and counts the
   warpgroup MMA instructions (``HGMMA``, ``IGMMA``) in each library's SASS
   (``cuobjdump -sass``): K2 and K7 must hold ``HGMMA``, K1, K3, K4, K5
   and K6 ``IGMMA``, and ptxas must not have serialized the wgmmas of any
   of them (its "wgmma ... serialized" warning); A1 must hold ``HMMA``
   (``mma.sync``) and no ``HGMMA``;
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
   then the quantizers Q1 (fake quantization onto one grid or a dual
   grid), Q2 (int8 value codes or grid indices and float32 scales) and Q3
   (linear INT fake quantization) against their plain versions bit for
   bit (int views) at the d16 last-scale shapes of their recipes, timed
   beside a bytes-only bound (no library call computes them), and over
   adversarial inputs on every grid and dual-grid half (normals,
   midpoints, grid values, +-0, +-inf, NaN, +-1e30, denormal scales,
   halves whose absmax is the smallest subnormal, groups of one strict
   sign, and their neighbours; bfloat16 and float32; per group and per
   token); Q1-Q3 bit for bit, one launch a call, at the layouts of their
   groups over threads (``QUANT_LAYOUTS``: groups of 12 to 256 values,
   rows of 1,024 to 9,216, group counts that fill no whole block, 16
   rows); and Q3 at each scale of a d16 batch-8 generation (``M = 16 *
   pn**2``: symmetric ``[M, 1024]``, asymmetric ``[M, 4096]``), timed
   beside its bound, with 16 blocks times a scale set's four calls
   summed: the Q3 time of one generation, which phase 10 prints beside
   the ``int4_rtn`` replay's; then A1 (attention over the packed KV
   cache's value codes) against its plain chain within its tolerance at
   each scale of a VAR-d36-512 batch-8 generation and at VAR-d30's last
   scale at batch 32 (bf16 q; float32 q at three scales), one launch a
   call, timed beside its bound, at the two last scales also the plain
   chain, ``F.scaled_dot_product_attention`` on the decoded keys and
   values (the yardstick) and 4 or 8 warps a block; the ten d36 scales'
   sum for a generation; and its refusals on the card;
4. small reference: small generations (width 256, so every grouped linear
   has more than one scale group) under ``int8``, ``bf16``, ``packed``,
   ``w4a16p``, W6A6 on the packed backend, ``fake``, ``int8ch``,
   ``int8chs``, ``int8chsnr``, ``w4a16``, ``int8kv``, ``int8att`` and the
   paper's ``fp4``, ``fp4_kv6``, ``fp6``, ``fp6_kv6``, ``int4_rtn`` and
   ``fp4_pertensor``, and of a shared-AdaLN model under ``bf16`` and
   ``fp4_kv6``, on the card against the same generations on the CPU: the
   same tokens at every scale, images within 1e-4;
5. main path: VAR-d16 with the full d16 VQVAE, random seeded weights,
   ``quantize_var_params`` and ``VARGenerator.generate`` for two batches of
   8 labels under ``int8``, ``bf16``, ``packed``, ``w4a16p``, ``int8ch``,
   ``int8chs``, ``int8chsnr``, ``w4a16``, ``int8kv``, ``int8att`` and the
   paper's ``fp4_kv6``, ``fp6_kv6`` and ``int4_rtn`` (the fake backend:
   Q1 or Q3 and no GEMM of the port); checks images and each recipe's kernel
   launch
   counts and prints img/s, the host thread's CPU time inside each
   ``generate`` call, the KV cache's bytes and the peak of device memory
   the generations allocated above what was resident before them (weights
   and earlier recipes' leftovers);
6. profile: one more batch-8 generation under ``int8``, ``bf16``,
   ``packed``, ``int8ch``, ``int8chs``, ``int8kv``, ``fp4_kv6``,
   ``fp6_kv6`` and ``int4_rtn`` under
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
   Then the same server over a fused generator (CUDA graphs): the repeat
   equal to its lone twin, every image equal to the eager server's,
   the pipeline used, one replay under the sync debug mode; saturated
   img/s and p50 / p99 beside the eager server's;
8. probe: ``tools/int8_rate_probe.run`` at its default shapes (library
   bf16 and int8 GEMMs, K6, K7), with the launches of K6 and K7 counted;
9. d36-512: VAR-d36-512 at its full width and depth (shared AdaLN, L =
   2240, the 512 px VQVAE), random seeded weights, two generations of 2
   labels under ``bf16`` and ``fp4_kv6``: images ``[2, 3, 512, 512]``
   finite in [0, 1], no GEMM of the port launched and Q1 exactly six
   times a block forward under ``fp4_kv6``; prints ms per generation,
   img/s, the quantize time with the float64 host rotation apart and the
   device transform's time beside it (with the weights where the two
   differ counted), the KV cache's bytes and the peak of device memory;
   one eager generation's kernel launches under torch.profiler; then a
   fused generator's two generations, ``torch.equal`` to the eager ones;
10. fused (run after phase 6, on phase 5's trees): the engine's fused mode
   (``VARGenerator(fuse_steps=True)``, CUDA graphs) under the profiled
   recipes of phase 6: two generations from phase 5's generator seed and
   labels must equal phase 5's images (``torch.equal``), and one replay
   under torch.profiler must launch each port kernel as often as one
   eager generation (phase 5's counts: the host counters see only the
   warm-up and the capture); prints eager and fused ms per batch and
   img/s, host CPU ms inside ``generate``, warm-up and capture times, the
   graphs' pool bytes and the replay's idle share;
11. transform: the device transform (``transform_blocks_traced``) at width
   256 under ``int8``, ``packed`` and ``fake`` on the card against the
   CPU (rotated weights within the float32 bound, the quantize stage bit
   for bit, differing codes counted), and a fused generation from
   ``synth_device_params`` of each, finite in [0, 1];
12. teacher forcing and training, at VAR-d16 full width and depth: K1-K5
   at the teacher-forcing forward's M = 5440 against their plain
   versions (K5 as ``[8, 680, K]``), timed as in phase 3; (a) one
   ``var_forward`` at batch 8 under ``bf16``, ``int8``, ``packed`` and
   ``int8ch`` with its exact launches (K5 48 + K1 32 + Q2 64, K2 64 + Q1
   64, K4 48 + K3 32 + Q2 16, none) and ms, and the KV-cached scale loop
   against one masked
   ``run_blocks`` within a derived float32 bound; (b) width-256 logits
   and capture taps, card against CPU, within 1e-4 (the quantized
   recipes' logits within 1e-3: an activation code at a near-tie moves
   them by ~2e-4); (c) the d16 VQVAE
   encoder and tokenizer at 256 px, batch 8, and card against CPU tokens
   under the near-tie rule; (d) mixed-precision training on those tokens
   (the loss falls), step ms and tokens/s, the peak memory with and
   without ``remat`` and their gradients, a checkpoint and ``auto_resume``
   equal to the uninterrupted step, and the training CLI run twice;
13. offline pipeline, at VAR-d16 full width and depth in a temporary
   directory removed at its end: (a) seeded d16 VAR and VQVAE trees under
   the upstream torch keys, ``torch.save``d and read back through
   ``load_torch_state_dict`` and the converters (keys =
   ``expected_var_keys``, trees equal leaf for leaf, a ``bf16`` batch-8
   generation ``torch.equal`` to the source trees'); (b)
   ``capture_generation`` of 1 label and a 640-file ``CalibrationStore``,
   ``capture_condition`` of 100 labels; (c) ``search_formats`` for fc1
   and ``search_ada_formats`` (JAX's JSON schema, finite losses >= 0); (d)
   ``train_galt`` for mat_qkv and fc1, 16 blocks, 10 epochs (every block's
   best loss at most its loss at s = 1; seconds and ms a step); (e) bf16
   cast, ``quantize_var_params`` under ``int8`` with (d)'s vectors,
   ``save_params`` / ``load_params`` (the tree equal, bf16 leaves bf16),
   the reloaded tree's batch-8 generation with exactly K1 320 + K5 480 +
   Q2 640 launches and images ``torch.equal`` to the in-memory tree's, and
   a ``fake`` generation under (c)'s mixed activation formats (Q1 640); (f) at
   width
   256, card against CPU: capture tokens and taps, the search's pair
   losses and choice, two GALT epochs within twice the CPU's own one-ulp
   response;
14. evaluation, at VAR-d16 full width and depth in a temporary directory
   removed at its end: (a) ``generate_eval_set`` with an eager ``int8``
   generator on the ``evaluate`` CLI's W4A4 trees (classes 0-1, 8 images
   each, batch 8; GALT vectors of ones in the reference's ``.pt`` format)
   with exactly K1 640 + K5 960 + Q2 1,280 launches, 16 PNGs, their npz, and
   PNG
   resume (a complete set runs nothing; a deleted PNG runs exactly one
   generation and comes back byte-equal); (b) the ``evaluate`` CLI, fused,
   in a subprocess (whose PNGs must be byte-equal to (a)'s), then one class
   at the protocol's default of 50 images at batch 50 (ms an image, peak
   memory and the graph pool's bytes, each within a bound that cuDNN's
   workspace would break) and an eager ``packed`` class with exactly K2
   640 + Q1 640; (c) Inception on the card against
   the CPU at 256 and 512 px within a derived bound, features a second at
   batch 64, the ``score`` CLI in a subprocess (PyTorch's default TF32
   flags) saving features ``torch.equal`` to this process's, and
   ``evaluate_all`` of 256 features against themselves (precision = recall
   = 1) and against uniform noise (a larger FID); (d) ``ManifoldEstimator``
   on 10,000 x 2,048 features with its seconds, and a 500-row subset
   against float64 within the counted near-tie pairs; (e) a short
   ``tools/quality_ladder.py`` run (finite FIDs and ISs, JAX's JSON keys).

15. distributed: K1, K2 and K3 at a d16 tp = 2 rank's shard shapes
   (``TP2_SHAPES``, M = 4096) against their plain versions (K3 exactly),
   timed as in phase 3; then two ranks on ``cuda:0`` over gloo (NCCL does not put two
   ranks on one device), each a process of this script started with
   torchrun's environment, at VAR-d16 full width and depth: each rank
   builds the seeded trees on the card (``synth_device_params``), keeps
   its shards (``parallel.shard_params``) and generates eagerly at batch 2
   under ``bf16``, ``int8``, ``packed``, ``int8ch`` and ``int8kv`` on a tp
   2 and a dp 2 mesh, with exact launches per rank (``DIST_PER_BLOCK``:
   K1 800 under ``int8``, K2 640 under ``packed``, K3 320 at tp 2 and 800
   at dp 2 under the per-channel recipes, K4 and K5 none; Q2 640 under
   ``int8`` and ``int8ch``, 960 under ``int8kv``, Q1 640 under
   ``packed``) and each rank's
   KV cache exactly half of the one-device cache; rank 0 runs the
   one-device generation of the same trees and generators (one per row):
   at dp 2 the images ``torch.equal`` to it where the one-device run is
   itself row-invariant between 4 and 2 rows, else within its own change
   between those batch sizes; at tp 2 the images ``torch.equal`` to it and
   every scale's logits within ``TP2_LOGIT_REL`` of the largest logit; on
   both meshes every token equal to it.  Then one float32 d16
   ``train_step`` (batch 8, ``remat``) on each mesh against rank 0's
   one-device step: the loss and every leaf's update within three times
   that step's own response to its batch rows reversed (plus 1e-6 of the
   loss, 1e-3 of the update).  Prints each generation's ms, the weight and cache bytes a
   rank holds, and the calls, bytes and host seconds of each collective
   (gloo through the host: no yardstick for NVLink).

16. the user-facing CLIs, at VAR-d16 full width and depth: (a) the
   native host library (``utils/native.py``, built with g++ from
   ``csrc/fpq_native.cpp``; where this machine has no g++ or zlib.h the
   phase says so and holds the numpy fallback instead): its build seconds,
   both zlib versions, every function equal to the port's torch
   counterparts on the card, PNGs equal to ``eval/png.py``'s and both
   writers' images/s; (b) ``tools/latency_breakdown.main`` (``bf16`` and
   ``int8``, batch 8, 3 rounds): per-stage ms of prepare, the ten scales
   and the decode, every eager ``int8`` pass exactly K1 320 + K5 480 + Q2
   640, finite stepwise images; (c) ``tools/serve.main`` (W4A4 on the int8
   backend, 8 demo requests, ``max_batch`` 8) under torch.profiler: JAX's
   PNG names, K1 320 + K5 480 + Q2 640 for the warm-up and for each
   served batch's replay, and pixels equal to the same requests through an
   eager
   ``GenerationServer`` over the CLI's trees.

17. the capacity study: ``tools/capacity_study.main`` at VAR-d16 full
   width and depth (``bf16`` and ``int8kv``, batches 8 and 16, 2 rounds):
   four probe children, each a fresh process that builds its mode's tree
   on the card, warms up and captures a fused generator and times its
   replays; each child's eager warm-up launches exactly none under
   ``bf16`` and K4 480 + K3 320 + Q2 480 under ``int8kv`` (its capture
   as many), its images are finite, and the study prints both modes'
   lines and the summary line; prints each child's img/s, peak
   allocated and reserved bytes, weight and KV-cache bytes and the graph
   pool's bytes, and the phase's seconds.

The phases run in the order 1-6, 10, 7-9, 11, 12, 13, 14, 15, 16, 17.  Phases 4-6 and the
launch gates of phases 7 and 9 run the eager loop (``fuse_steps=False``),
whose every launch the wrappers' host counters see.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table as one JSON object.

    python3 chip_smoke.py --quant-ab DIR [OUT]

times Q1, Q2 and Q3 at phase 3's shapes (``QUANT_CASES``, ``Q3_CASES``
and Q3's per-scale shapes) as built from this checkout and from the
checkout at DIR (its ``fpqvar_tpu_torch/csrc``, whose kernels take the
same C arguments), in one process on one card, in the order DIR, this,
this, DIR at each shape, each held bit for bit to the plain version; it
prints a line a shape and each tree's per-scale sum for a generation,
and writes every time as JSON to the file OUT where one is given.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
                  "bf16_probe_gemm", "fake_quant_grid", "grid_codes",
                  "fake_quant_int", "stage_mark", "packed_attention")
#: the sources that compute nothing: the stage marker of a device trace
TRACE_SOURCES = ("stage_mark",)
#: the attention source (A1: its products on mma.sync, in registers
#: between them; no GEMM pipeline, no quantizer) and the SASS instruction
#: of its products
ATTN_SOURCES = {"packed_attention": "HMMA"}
#: the quantizer sources (no GEMM) and their kernels
QUANT_SOURCES = {"fake_quant_grid": "Q1", "grid_codes": "Q2",
                 "fake_quant_int": "Q3"}
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
#: (f32 x), K4's two kernels apart; the quantizers Q1 (one grid, dual
#: grid), Q2 (one grid, dual grid) and Q3 and the attention A1 by their
#: kernels' names; no key is a part of another's
PORT_KERNELS = {"K1": ("GroupFold",),
                "K2": ("rs_gemm_kernel", "packed_dequant_gemm_kernel"),
                "K3": ("Int8ChRescale",), "K4 (a)": (K4_KERNELS["a"],),
                "K4 (b)": (K4_KERNELS["b"],), "K5": ("NdGroupSum",),
                "Q1": ("fake_grid_kernel", "fake_dual_kernel"),
                "Q2": ("grid_codes_kernel", "dual_codes_kernel"),
                "Q3": ("fake_int_kernel",),
                "A1": ("packed_attention_kernel",)}
#: the block linears of the VAR-d16 teacher-forcing forward at batch 8, all
#: L = 680 tokens of a row in one call: (name, M, K, N); M = 5440 = 42 *
#: 128 + 64 ends in a half-filled row tile, and K5 takes it as [8, 680, K]
TF_SHAPES = (("qkv", 5440, 1024, 3072), ("proj", 5440, 1024, 1024),
             ("fc1", 5440, 1024, 4096), ("fc2", 5440, 4096, 1024))
#: each recipe's port-kernel launches per d16 teacher-forcing forward (16
#: blocks, as a generation's scale step launches them, once): the GEMMs
#: and the activation quantizers (Q2 on int8's four linears and on
#: int8ch's fc2, Q1 on packed's four)
TF_LAUNCHES = {"bf16": {}, "int8": {"K5": 48, "K1": 32, "Q2": 64},
               "packed": {"K2": 64, "Q1": 64},
               "int8ch": {"K4": 48, "K3": 32, "Q2": 16}}
#: GALT epochs a kind in phase 13 (d) (the CLI's default is 50)
OFFLINE_GALT_EPOCHS = 10
#: the int8 rate probe's default shapes: (name, M, K, N)
PROBE_SHAPES = (("probe-1920", 4096, 1920, 5760),
                ("probe-4096", 4096, 4096, 4096))
#: the dual grids of the main path's fc2: fp4 (packed, fp4_kv6, int8) and
#: fp6 (fp6_kv6)
DUAL4, DUAL6 = "fp_e1m2_neg_e2m1_pos", "fp6_int_neg_e2m3_pos"
#: phase 3's timed cases of Q1 and Q2: (kernel, name, recipes, call,
#: format, granularity or group, shape, dtype name, amplitude); calls
#: ``fp`` / ``dual`` (Q1's one grid or dual grid), ``codes`` /
#: ``dual_codes`` / ``pack`` (Q2's value codes, dual codes, grid-index
#: codes of ``pack``).  VAR-d16's last scale at batch 8 (M = 4096 rows of
#: 1024 or 4096; the KV cache's k or v ``[16, 256, 16, 64]`` per row of 64;
#: a weight ``[4096, 1024]``), then the rows of VAR-d30 (1920) and
#: VAR-d36-512 (2304; fc2's 9216) at their last scales (M = 4096 at batch
#: 8 and 2)
QUANT_CASES = (
    ("Q1", "qkv-fp_e2-g128", "packed, fp4_kv6: qkv, proj, fc1", "fp",
     "fp_e2", "per_group", (4096, 1024), "bfloat16", 3.0),
    ("Q1", "fc2-e1m2/e2m1-g128", "packed, fp4_kv6: fc2", "dual", DUAL4,
     "per_group", (4096, 4096), "bfloat16", 3.0),
    ("Q1", "qkv-fp6_e2m3-token", "fp6_kv6: qkv, proj, fc1", "fp",
     "fp6_e2m3", "per_token", (4096, 1024), "bfloat16", 3.0),
    ("Q1", "fc2-int/e2m3-token", "fp6_kv6: fc2", "dual", DUAL6,
     "per_token", (4096, 4096), "bfloat16", 3.0),
    ("Q1", "kv-fp6_e2m3-row64", "the _kv6 dense cache: k, v", "fp",
     "fp6_e2m3", "per_token", (16, 256, 16, 64), "bfloat16", 3.0),
    ("Q1", "w-fp_e2-g128-f32", "search, GALT's STE, fake weights", "fp",
     "fp_e2", "per_group", (4096, 1024), "float32", 0.02),
    ("Q1", "d30-fp6_e2m3-token", "fp6_kv6 at d30: qkv, proj, fc1", "fp",
     "fp6_e2m3", "per_token", (4096, 1920), "bfloat16", 3.0),
    ("Q1", "d36-fp6_e2m3-token", "fp6_kv6 at d36-512: qkv, proj, fc1",
     "fp", "fp6_e2m3", "per_token", (4096, 2304), "bfloat16", 3.0),
    ("Q1", "d36-fc2-int/e2m3-token", "fp6_kv6 at d36-512: fc2", "dual",
     DUAL6, "per_token", (4096, 9216), "bfloat16", 3.0),
    ("Q2", "qkv-fp_e2-g128", "int8: qkv, proj, fc1", "codes", "fp_e2", 128,
     (4096, 1024), "bfloat16", 3.0),
    ("Q2", "fc2-e1m2/e2m1-g128", "int8: fc2", "dual_codes", DUAL4, 128,
     (4096, 4096), "bfloat16", 3.0),
    ("Q2", "fc2-e1m2/e2m1-token", "int8ch, int8kv, int8att: fc2",
     "dual_codes", DUAL4, 4096, (4096, 4096), "bfloat16", 3.0),
    ("Q2", "kv-fp_e2-row64", "int8kv, int8att: the packed KV encode",
     "codes", "fp_e2", 64, (16, 256, 16, 64), "bfloat16", 3.0),
    ("Q2", "pack-fp_e2-g128-f32", "pack, pack_int_codes: weights", "pack",
     "fp_e2", 128, (4096, 1024), "float32", 0.02),
    ("Q2", "pack-fp8_e4m3-g128", "pack: a 255-value grid, bf16", "pack",
     "fp8_e4m3", 128, (4096, 1024), "bfloat16", 3.0),
    ("Q2", "d36-fc2-e1m2/e2m1-token", "int8ch, int8kv at d36-512: fc2",
     "dual_codes", DUAL4, 9216, (4096, 9216), "bfloat16", 3.0),
)
#: phase 3's timed cases of Q3 at VAR-d16's last scale at batch 8: (name,
#: recipes, shape, dtype name, amplitude, bits, asymmetric, granularity)
Q3_CASES = (
    ("qkv-sym-token", "int4_rtn: qkv, proj, fc1", (4096, 1024), "bfloat16",
     3.0, 4, False, "per_token"),
    ("fc2-asym-token", "int4_rtn: fc2", (4096, 4096), "bfloat16", 3.0, 4,
     True, "per_token"),
    ("kv-sym-row64-f32", "the int_sym dense cache (float32)",
     (16, 256, 16, 64), "float32", 3.0, 4, False, "per_token"),
    ("w-sym-g128-f32", "int_sym_ste (GALT)", (4096, 1024), "float32", 0.02,
     4, False, "per_group"),
)
#: VAR-d16's patch sizes: a batch-8 generation with CFG quantizes M = 16 *
#: pn**2 rows at each scale, Q3 four times a block under int4_rtn (qkv,
#: proj and fc1 symmetric on [M, 1024], fc2 asymmetric on [M, 4096])
D16_PATCH_NUMS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
#: phase 3's layouts of Q1-Q3 (group, shape): groups of 64, 128 and
#: 256 values, of 24, 40 and 12 (3 and 5 vectors of 16 bytes in bf16; 6,
#: 10 and 3 in f32), rows of 1,024 to 9,216 (a warp; a block of 2, 3, 4
#: or 9 warps in bf16), each in a count that fills no whole warp or
#: block, and the main path's smallest M (16 rows, the first scale at
#: batch 8); bfloat16 and float32 where a group is a multiple of 16 bytes
QUANT_LAYOUTS = ((64, (2, 3, 5, 4160)), (128, (2, 3, 5, 4224)),
                 (256, (2, 3, 5, 4352)), (24, (2, 3, 5, 4104)),
                 (40, (2, 3, 5, 4120)), (12, (2, 3, 5, 4104)),
                 (1024, (30, 1024)), (1920, (30, 1920)), (2304, (30, 2304)),
                 (4096, (30, 4096)), (9216, (30, 9216)), (128, (16, 1024)),
                 (1024, (16, 1024)), (4096, (16, 4096)))


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def count_captures(gen) -> list:
    """Count the graph captures of the fused generator ``gen``: each one
    appends its batch size to the list returned."""
    made, capture = [], gen._capture

    def counted(fz):
        made.append(fz.labels.shape[0])
        return capture(fz)

    gen._capture = counted
    return made


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
        _open_window()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    out = {}
    for label, key in keys.items():
        total = sum(_self_device_us(e) for e in events if key in e.key)
        out[label] = total / 1e3 / reps if total > 0 else None
    return out


#: spin kernels that open every profiler window, before the work it
#: measures: on the card torch.profiler was seen to drop a varying few of
#: a window's first kernel records (once 4 of a generation's K2 launches;
#: PERF.md, section 6), so each window starts on these
#: (``torch.cuda._sleep``'s ``spin_kernel``) and a pause, and every count
#: and sum leaves them out
PAD_KERNELS = 1024
PAD_KEY = "spin_kernel"


def _open_window() -> None:
    """Pad the start of a profiler window (``PAD_KERNELS``)."""
    for _ in range(PAD_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(0.05)


def _device_events(prof) -> list:
    """The CUDA kernels of a profiler window, its padding left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and PAD_KEY not in e.key]


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
        return {op: sass.count(op) for op in ("HGMMA", "IGMMA", "HMMA")}

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
    for name, op in ATTN_SOURCES.items():
        if counts[name][op] == 0 or counts[name]["HGMMA"]:
            fail(f"build: {name} holds {counts[name]}: its products should "
                 f"run on mma.sync ({op})")


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


# ---------------------------------------------------------------------------
# Phase 3, the quantizers Q1-Q3
# ---------------------------------------------------------------------------

def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal: float tensors compared as their int views (-0 is not
    +0, and a NaN's bits count), codes as they are."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return torch.equal(a, b)


def _bit_check(kern: str, what: str, got, want) -> float:
    """Fail unless every output of a quantizer kernel is bit-equal to its
    plain version's (NaN bits included); returns the largest |difference|
    of the finite values (0 where bit-equal)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not _same_bits(a, b):
            n = (int((a.float() != b.float()).sum())
                 if a.shape == b.shape else -1)
            fail(f"{kern} {what}: output {i} ({a.dtype} {tuple(a.shape)}) "
                 f"differs from the plain version's ({b.dtype} "
                 f"{tuple(b.shape)}) in {n} values: bit-equality required")
        d = (a.float() - b.float()).abs()
        d = d[torch.isfinite(d)]
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def check_quant(kern: str, name: str, note: str, run, plain,
                nbytes: int) -> dict:
    """Hold ``run()`` (a quantizer kernel through its public wrapper)
    bit for bit to ``plain()``, then time both as ``check_and_time`` does
    (20 back-to-back calls; 20 queued; the plain version 3 calls).  The
    bound is bytes only: each input read once and each output written
    once, ``nbytes``, at 3.35 TB/s; no single PyTorch call computes these
    functions, so there is no library yardstick."""
    err = _bit_check(kern, name, run(), plain())
    ms = cuda_ms(run)
    device_ms, host_ms = queued_ms(run)
    plain_ms = cuda_ms(plain, reps=3)
    bound = nbytes / H100_BYTES * 1e3
    row = {"shape": name, "recipes": note, "bytes": nbytes,
           "max_abs_err": err, "ms": ms, "device_ms": device_ms,
           "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound, "bound_by": "bytes"}
    print(f"kernels: {kern} {name:22s} ({note}): bit-equal to the plain "
          f"version; kernel {ms:.4f} ms (queued: device {device_ms:.4f} "
          f"ms, host {host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, "
          f"bound {bound * 1e3:.2f} us ({nbytes} bytes), "
          f"{bound / device_ms:.3f} of it; library: none")
    return row


def _neighbours(v: torch.Tensor) -> torch.Tensor:
    """``v`` and each value's two neighbours in its dtype (its bits +- 1)."""
    view = torch.int16 if v.element_size() == 2 else torch.int32
    bits = v.view(view)
    return torch.cat([v, (bits + 1).view(v.dtype), (bits - 1).view(v.dtype)])


def _led_groups(vals: torch.Tensor, lead, gs: int = 128) -> torch.Tensor:
    """``vals`` in groups of ``gs`` whose first values are ``lead``."""
    k = 0 if lead is None else lead.numel()
    n = gs - k
    reps = -(-vals.numel() // n)
    body = vals.repeat(-(-reps * n // vals.numel()))[:reps * n].view(reps, n)
    if lead is not None:
        body = torch.cat([lead.expand(reps, k), body], dim=1)
    return body.reshape(-1)


def _adversarial(grid, dtype, gen, lead=None) -> torch.Tensor:
    """``[rows, 1024]`` of ``dtype``: 65,536 normals scaled to the grid's
    range; groups of 128 led by the grid's absmax (scale ~1) holding
    every midpoint, grid value and +-0 with each one's neighbours;
    groups holding +-inf, NaN, +-1e30 among them; groups of a denormal
    scale; groups where the absmax of one half (of both: the whole
    group's) is the dtype's smallest subnormal, so that the half's scale
    rounds to 0 where its product with ``1 / max|grid|`` can; a group of
    a dozen magnitudes all strictly negative and one all strictly
    positive, whose min and max no zero may enter."""
    g = torch.tensor(np.asarray(grid, np.float32), device="cuda")
    gmax = float(g.abs().max())
    lead = torch.tensor([gmax, -gmax] if lead is None else lead,
                        device="cuda").to(dtype)
    normals = torch.randn(65536, generator=gen, device="cuda") * gmax / 3
    exact = _neighbours(torch.cat([(g[1:] + g[:-1]) * 0.5, g, torch.tensor(
        [0.0, -0.0], device="cuda")]).to(dtype))
    wild = _neighbours(torch.tensor(
        [math.inf, -math.inf, math.nan, 1e30, -1e30, 0.0, 1.0],
        device="cuda").to(dtype))
    sub = torch.tensor(2.0 ** -133 if dtype == torch.bfloat16
                       else 2.0 ** -149, device="cuda")
    mag = normals[:1024].abs()
    zeros = torch.tensor([0.0, -0.0, math.nan], device="cuda")
    signed = (torch.linspace(0.05, 0.95, 12, device="cuda") * gmax).to(dtype)
    x = torch.cat([normals.to(dtype), _led_groups(exact, lead),
                   _led_groups(torch.cat([wild, exact]), None),
                   _led_groups(wild.flip(0), None),
                   (normals[:4096] * 1e-39).to(dtype),
                   _led_groups(torch.stack([sub, -sub, sub * 0, -sub * 0])
                               .to(dtype), None),
                   _led_groups(torch.cat([-mag, zeros, sub[None]]).to(dtype),
                               sub[None].to(dtype)),
                   _led_groups(torch.cat([mag, zeros, -sub[None]])
                               .to(dtype), -sub[None].to(dtype)),
                   _led_groups(-signed, None), _led_groups(signed, None)])
    pad = -x.numel() % 1024
    return torch.cat([x, x[:pad]]).view(-1, 1024)


def _quant_sweep(gen) -> int:
    """Q1-Q3 bit-equal to their plain versions on ``_adversarial`` inputs:
    every grid of ``G.GRIDS`` (Q1 per group and per token, with the clamp
    of the per-token fp4 formats; Q2's grid-index codes of ``pack`` and
    of the KV codec; Q2's value codes per group and per token where the
    format has them), both halves of every dual grid (Q1; Q2's codes), Q3
    symmetric and asymmetric at 4, 6 and 8 bits per group and per token;
    bfloat16 and float32.  Returns the number of checks."""
    from fpqvar_tpu_torch.ops import grids as G
    from fpqvar_tpu_torch.ops import packing as P
    from fpqvar_tpu_torch.ops import quant_kernels as QK
    from fpqvar_tpu_torch.ops import quantizers as Q

    checks = 0
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for fmt, grid in G.GRIDS.items():
            x = _adversarial(grid, dtype, gen)
            for gran in ("per_group", "per_token"):
                clip = (3.0 if gran == "per_token" and fmt.startswith("fp_e")
                        else None)
                kw = dict(granularity=gran, clip_abs=clip)
                _bit_check("Q1", f"{fmt} {gran} {dt}",
                           Q.fake_quant_fp(x, fmt, **kw),
                           Q.fake_quant_fp_ref(x, fmt, **kw))
            codes, scales = P.pack_codes_ref(x, fmt)
            _bit_check("Q2", f"pack {fmt} {dt}", QK.pack_codes(x, fmt),
                       (codes.to(torch.int8), scales))
            rows = x.view(-1, 64)
            _bit_check("Q2", f"KV grid index {fmt} {dt}",
                       QK.grid_index_codes(rows, fmt),
                       P.grid_index_codes_ref(rows, fmt))
            checks += 4
            for gs in ((128, 1024) if fmt in P.CODE_MULT else ()):
                _bit_check("Q2", f"codes {fmt} group {gs} {dt}",
                           P.quant_int_codes(x, fmt, gs),
                           P.quant_int_codes_ref(x, fmt, gs))
                checks += 1
        for fmt, (neg, pos) in G.DUAL_GRIDS.items():
            lead = [-float(np.abs(neg).max()), float(np.abs(pos).max())]
            for grid in (neg, pos):
                x = _adversarial(grid, dtype, gen, lead)
                for gran in ("per_group", "per_token"):
                    _bit_check("Q1", f"{fmt} {gran} {dt}",
                               Q.fake_quant_dual(x, fmt, granularity=gran),
                               Q.fake_quant_dual_ref(x, fmt,
                                                     granularity=gran))
                    checks += 1
                for gs in ((128, 1024) if fmt in P.DUAL_CODE_MULT else ()):
                    _bit_check("Q2", f"dual codes {fmt} group {gs} {dt}",
                               P.quant_int_codes_dual(x, fmt, gs),
                               P.quant_int_codes_dual_ref(x, fmt, gs))
                    checks += 1
        for n_bits in (4, 6, 8):
            q_max = 2 ** (n_bits - 1) - 1
            x = _adversarial(np.arange(-q_max - 1, q_max + 1), dtype, gen)
            for asym in (False, True):
                fn, ref = ((Q.fake_quant_int_asym, Q.fake_quant_int_asym_ref)
                           if asym else (Q.fake_quant_int_sym,
                                         Q.fake_quant_int_sym_ref))
                kind = "asym" if asym else "sym"
                for gran in ("per_group", "per_token"):
                    _bit_check("Q3", f"int{n_bits} {kind} {gran} {dt}",
                               fn(x, n_bits, granularity=gran),
                               ref(x, n_bits, granularity=gran))
                    checks += 1
    return checks


def _quant_case(call: str, fmt: str, arg, x) -> tuple:
    """``(run, plain, bytes)`` of a Q1 or Q2 call on ``x``: its public
    wrapper, its plain version and the bytes of x read once and of its
    outputs written once.  ``arg`` is a granularity (``fp``, ``dual``) or
    a group size."""
    from fpqvar_tpu_torch.ops import packing as P
    from fpqvar_tpu_torch.ops import quant_kernels as QK
    from fpqvar_tpu_torch.ops import quantizers as Q

    n = x.numel()
    read = n * x.element_size()
    if call in ("fp", "dual"):
        fn, ref = ((Q.fake_quant_dual, Q.fake_quant_dual_ref)
                   if call == "dual"
                   else (Q.fake_quant_fp, Q.fake_quant_fp_ref))
        kw = ({"granularity": arg} if isinstance(arg, str)
              else {"granularity": "per_group", "group_size": arg})
        return (lambda: fn(x, fmt, **kw), lambda: ref(x, fmt, **kw),
                2 * read)
    if call == "codes":
        return (lambda: P.quant_int_codes(x, fmt, arg),
                lambda: P.quant_int_codes_ref(x, fmt, arg),
                read + n + n // arg * 4)
    if call == "dual_codes":
        return (lambda: P.quant_int_codes_dual(x, fmt, arg),
                lambda: P.quant_int_codes_dual_ref(x, fmt, arg),
                read + 2 * (n + n // arg * 4))
    if call == "pack":
        def plain():
            codes, scales = P.pack_codes_ref(x, fmt, arg)
            return codes.to(torch.int8), scales

        return (lambda: QK.pack_codes(x, fmt, arg), plain,
                read + n + n // arg * 4)
    raise ValueError(call)


def _quant_input(shape, dtype: str, amp: float, gen) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device="cuda")
            * amp).to(getattr(torch, dtype))


def _q3_case(x, n_bits: int, asym: bool, gran) -> tuple:
    """``(run, plain, bytes)`` of Q3 on ``x``, as ``_quant_case``;
    ``gran`` is a granularity or a group size."""
    from fpqvar_tpu_torch.ops import quantizers as Q

    fn, ref = ((Q.fake_quant_int_asym, Q.fake_quant_int_asym_ref) if asym
               else (Q.fake_quant_int_sym, Q.fake_quant_int_sym_ref))
    kw = ({"granularity": gran} if isinstance(gran, str)
          else {"granularity": "per_group", "group_size": gran})
    return (lambda: fn(x, n_bits, **kw), lambda: ref(x, n_bits, **kw),
            2 * x.numel() * x.element_size())


def _quant_layouts(gen) -> int:
    """Q1 (one grid, dual grid), Q2 (value codes, dual codes) and Q3
    (symmetric, asymmetric) at every layout of ``QUANT_LAYOUTS``, bfloat16
    and float32: bit-equal to the plain versions, one launch a call.  Each
    input holds an all-zero group, a group of x's smallest subnormals, a
    group all strictly negative and one all strictly positive.  Returns
    the number of checks."""
    from fpqvar_tpu_torch.ops import quant_kernels as QK

    calls = (("fp", "fp_e2", "grid_launches"),
             ("dual", DUAL6, "grid_launches"),
             ("codes", "fp6_e2m3", "codes_launches"),
             ("dual_codes", DUAL4, "codes_launches"),
             ("int_sym", None, "int_launches"),
             ("int_asym", None, "int_launches"))
    kern = {"grid_launches": "Q1", "codes_launches": "Q2",
            "int_launches": "Q3"}
    checks = 0
    for dtype in ("bfloat16", "float32"):
        for gs, shape in QUANT_LAYOUTS:
            x = _quant_input(shape, dtype, 3.0, gen)
            if (gs * x.element_size()) % 16:
                continue
            flat = x.view(-1)
            flat[:gs] = 0.0
            flat[gs:2 * gs] = 2.0 ** (-133 if dtype == "bfloat16" else -149)
            flat[2 * gs:3 * gs] = -flat[2 * gs:3 * gs].abs() - 0.25
            flat[3 * gs:4 * gs] = flat[3 * gs:4 * gs].abs() + 0.25
            for call, fmt, counter in calls:
                run, plain, _ = (
                    _q3_case(x, 4, call == "int_asym", gs) if fmt is None
                    else _quant_case(call, fmt, gs, x))
                before = getattr(QK, counter)
                got = run()
                if getattr(QK, counter) != before + 1:
                    fail(f"{call} {fmt} group {gs} {tuple(shape)} {dtype}: "
                         f"{getattr(QK, counter) - before} launches, not 1")
                _bit_check(kern[counter],
                           f"{call} {fmt} group {gs} {tuple(shape)} {dtype}",
                           got, plain())
                checks += 1
    return checks


def _q3_scale_inputs(gen) -> list:
    """Q3's calls of one d16 batch-8 ``int4_rtn`` scale set, each scale's
    ``M = 16 * pn**2`` rows (``D16_PATCH_NUMS``): ``(name, calls a block,
    x, asymmetric)`` for the symmetric ``[M, 1024]`` (qkv, proj, fc1) and
    the asymmetric ``[M, 4096]`` (fc2), bfloat16."""
    cases = []
    for pn in D16_PATCH_NUMS:
        m = 16 * pn * pn
        cases.append((f"sym-[{m},1024]", 3,
                      _quant_input((m, 1024), "bfloat16", 3.0, gen), False))
        cases.append((f"asym-[{m},4096]", 1,
                      _quant_input((m, 4096), "bfloat16", 3.0, gen), True))
    return cases


def _generation_ms(rows: list, key: str) -> float:
    """16 blocks times the sum of a scale set's Q3 calls (``rows`` of
    ``_q3_scale_inputs``, each with its calls a block): one d16 batch-8
    ``int4_rtn`` generation's Q3 time from the per-scale times ``key``."""
    return 16 * sum(r["calls"] * r[key] for r in rows)


def phase_quant() -> dict:
    """Q1 and Q2 at ``QUANT_CASES``, Q3 at ``Q3_CASES``, each against its
    plain version bit for bit and timed; then ``_quant_sweep``'s
    adversarial inputs over every grid and ``_quant_layouts``; then Q3 at
    every scale of a d16 generation (``_q3_scale_inputs``), bit for bit,
    timed as ``check_quant`` times (the plain version left out) and summed
    for one generation.  Returns each kernel's rows and, under
    ``"Q3 scales"``, the per-scale rows and that sum."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    rows = {"Q1": [], "Q2": [], "Q3": []}
    for kern, name, note, call, fmt, arg, shape, dtype, amp in QUANT_CASES:
        x = _quant_input(shape, dtype, amp, gen)
        run, plain, nbytes = _quant_case(call, fmt, arg, x)
        rows[kern].append(check_quant(kern, name, note, run, plain, nbytes))
    for name, note, shape, dtype, amp, n_bits, asym, gran in Q3_CASES:
        x = _quant_input(shape, dtype, amp, gen)
        rows["Q3"].append(check_quant("Q3", name, note,
                                      *_q3_case(x, n_bits, asym, gran)))
    t0 = time.perf_counter()
    checks = _quant_sweep(gen)
    print(f"kernels: Q1-Q3 bit-equal to their plain versions in {checks} "
          f"adversarial checks (every grid and dual-grid half, bfloat16 and "
          f"float32, per group and per token; normals, midpoints, grid "
          f"values, +-0, +-inf, NaN, +-1e30, denormal scales, halves of a "
          f"subnormal absmax, groups of one strict sign and their "
          f"neighbours; NaN bits included) in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    checks = _quant_layouts(gen)
    print(f"kernels: Q1-Q3 bit-equal to their plain versions, one "
          f"launch a call, in {checks} checks of {len(QUANT_LAYOUTS)} "
          f"layouts (groups of 12 to 9,216 values, bfloat16 and float32) "
          f"in {time.perf_counter() - t0:.1f} s")
    scales = []
    for name, calls, x, asym in _q3_scale_inputs(gen):
        run, plain, nbytes = _q3_case(x, 4, asym, "per_token")
        _bit_check("Q3", name, run(), plain())
        dev, host = queued_ms(run)
        scales.append({"shape": name, "calls": calls, "bytes": nbytes,
                       "ms": cuda_ms(run), "device_ms": dev, "host_ms": host,
                       "bound_ms": nbytes / H100_BYTES * 1e3})
    for r in scales:
        print(f"kernels: Q3 per scale {r['shape']:18s} x{r['calls']} a "
              f"block: dev {r['device_ms'] * 1e3:.2f} us (ms "
              f"{r['ms'] * 1e3:.2f}, host {r['host_ms'] * 1e3:.2f}), bound "
              f"{r['bound_ms'] * 1e3:.2f} us, "
              f"{r['bound_ms'] / r['device_ms']:.3f} of it")
    gen_ms = _generation_ms(scales, "device_ms")
    bound_ms = _generation_ms(scales, "bound_ms")
    print(f"kernels: Q3 per scale, 16 blocks x a scale set's four calls: "
          f"{gen_ms:.3f} ms of device time a d16 batch-8 int4_rtn "
          f"generation (bound {bound_ms:.3f} ms); each shape bit-equal")
    rows["Q3 scales"] = {"rows": scales, "gen_ms": gen_ms,
                         "bound_ms": bound_ms}
    return rows


#: A1's cases: (name, rows, heads, l, end, cache rows): each scale of
#: VAR-d36-512 at batch 8 (16 rows with the guidance twins, 36 heads,
#: the queries of the scale over every token so far, in a cache of L =
#: 2,240) and VAR-d30's last scale at batch 32 (64 rows, 30 heads, 256
#: queries over 680)
ATTN_CASES = tuple(
    [(f"d36-s{si}-pn{pn}", 16, 36, pn * pn,
      sum(p * p for p in (1, 2, 3, 4, 6, 9, 13, 18, 24, 32)[:si + 1]), 2240)
     for si, pn in enumerate((1, 2, 3, 4, 6, 9, 13, 18, 24, 32))]
    + [("d30-last", 64, 30, 256, 680, 680)])
#: the cases timed against the plain chain and the library, and those
#: checked with float32 q (the float32 compute dtype) besides
ATTN_TIMED = ("d36-s9-pn32", "d30-last")
ATTN_F32 = ("d36-s0-pn1", "d36-s5-pn9", "d36-s8-pn24")
#: the share of bf16 outputs A1 may move off the chain's: a kernel that
#: rounds the weights before the division by the row sum moves 30-40%
ATTN_MOVED = 0.01


def _attn_operands(rows, heads, l, end, cache_rows, gen):
    """A1's operands as a block forward hands them: q (float32) l2-normalised
    per head and scaled by 1 to 30 (``scale_mul``), and the fp_e2 codes
    and scales of l2-normalised keys and Gaussian values through the
    ``int8kv`` codec (Q2), as rows ``[0, end)`` of cache leaves of
    ``cache_rows`` tokens."""
    from fpqvar_tpu_torch.quantize.runtime import make_kv_codec

    hd = 64
    q = torch.randn((rows, l, heads, hd), device="cuda", generator=gen)
    hs = torch.exp(torch.rand(heads, device="cuda", generator=gen)
                   * math.log(30.0))
    q = (q / q.norm(dim=-1, keepdim=True) * hs.reshape(1, 1, heads, 1))
    codec = make_kv_codec("fp_e2")
    out = [q]
    for is_k in (True, False):
        t = torch.randn((rows, end, heads, hd), device="cuda",
                        generator=gen)
        if is_k:
            t = t / t.norm(dim=-1, keepdim=True)
        tc, ts = codec.encode(t.to(torch.bfloat16))
        codes = torch.zeros((rows, heads, cache_rows, hd), dtype=torch.int8,
                            device="cuda")
        scales = torch.zeros((rows, heads, cache_rows), device="cuda")
        codes[:, :, :end] = tc.transpose(1, 2)
        scales[:, :, :end] = ts[..., 0].transpose(1, 2)
        out += [codes[:, :, :end], scales[:, :, :end]]
    q, kc, ks, vc, vs = out
    return q, kc, ks, vc, vs


def _attn_library(q, kc, ks, vc, vs):
    """The yardstick: ``F.scaled_dot_product_attention`` on the decoded
    bf16 keys and values (scale 1), which the port never calls."""
    import torch.nn.functional as F

    k = (kc.float() * ks[..., None]).to(torch.bfloat16)
    v = (vc.float() * vs[..., None]).to(torch.bfloat16)
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, k, v, scale=1.0)


def _attn_check(name, ops):
    """A1 against the plain chain within ``packed_attention.tolerance``,
    and at bf16 equal to it on all but ``ATTN_MOVED`` of the outputs (the
    weights round where the chain rounds them: an output differs only
    where a float32 sum lands across a rounding point); one launch a call.
    Returns (max abs err, worst err / tol, share of outputs that
    differ)."""
    from fpqvar_tpu_torch.ops import packed_attention as PA

    before = PA.attn_launches
    y = PA.packed_attention(*ops)
    torch.cuda.synchronize()
    if PA.attn_launches != before + 1:
        fail(f"kernels: A1 {name}: {PA.attn_launches - before} launches in "
             "one call")
    ref = PA.packed_attention_ref(*ops)
    tol = PA.tolerance(*ops)
    err = (y.float() - ref.float()).abs()
    if (y.dtype != ref.dtype or y.shape != ref.shape
            or not bool(torch.isfinite(y).all()) or bool((err > tol).any())):
        fail(f"kernels: A1 {name} {ops[0].dtype}: max err "
             f"{float(err.max())} exceeds the tolerance (worst err/tol "
             f"{float((err / tol.clamp_min(1e-30)).max()):.3g})")
    moved = float((err > 0).double().mean())
    if y.dtype == torch.bfloat16 and moved >= ATTN_MOVED:
        fail(f"kernels: A1 {name}: {moved:.2%} of the outputs differ from "
             f"the chain (under {ATTN_MOVED:.0%} where the weights round "
             "as the chain rounds them)")
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max()), moved


def phase_attention() -> dict:
    """A1 (``ops/packed_attention.py``, ``csrc/packed_attention.cu``)
    against the plain chain (``packed_attention_ref``) within
    ``packed_attention.tolerance`` at every case of ``ATTN_CASES`` (bf16
    q) and of ``ATTN_F32`` (float32 q), one launch a call; each case
    timed (ms, and queued: device and host ms a call) beside its bound
    (``max(bytes / HBM, 4 * rows * heads * l * end * 64 / bf16 peak)``,
    each operand read once); at ``ATTN_TIMED`` the plain chain and the
    library yardstick (``_attn_library``) besides; the sum over a
    d36-512 generation's ten scales (36 blocks, per image of batch 8); and
    the wrapper's refusals on the card (an ``attn_bias``, float16 q,
    head_dim 32, codes of another layout).
    Returns the rows and that sum."""
    from fpqvar_tpu_torch.ops import packed_attention as PA

    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    rows = []
    for name, b, h, l, end, cache_rows in ATTN_CASES:
        q32, *codes = _attn_operands(b, h, l, end, cache_rows, gen)
        ops = (q32.to(torch.bfloat16), *codes)
        err, worst, moved = _attn_check(name, ops)
        f32 = None
        if name in ATTN_F32:
            f32 = _attn_check(name, (q32, *codes))
        del q32, codes
        run = lambda ops=ops: PA.packed_attention(*ops)   # noqa: E731
        dev, host = queued_ms(run)
        flops = 4 * b * h * l * end * 64
        nbytes = 2 * b * l * h * 64 * 2 + 2 * b * h * end * (64 + 4)
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES * 1e3
        row = {"shape": name, "rows": b, "heads": h, "l": l, "end": end,
               "warps": PA.warps_for(l), "max_abs_err": err,
               "worst_err_over_tol": worst, "moved_share": moved,
               "ms": cuda_ms(run),
               "device_ms": dev, "host_ms": host,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / dev * 1e-9}
        if f32 is not None:
            row["f32_max_abs_err"], row["f32_worst_err_over_tol"] = f32[:2]
        if name in ATTN_TIMED:
            row["plain_ms"] = cuda_ms(
                lambda: PA.packed_attention_ref(*ops), reps=3)
            row["library_ms"] = cuda_ms(_attn_library(*ops))
        rows.append(row)
        del ops
        extra = ("" if "plain_ms" not in row else
                 f"; plain chain {row['plain_ms']:.4f} ms, library (SDPA on "
                 f"decoded bf16 k, v) {row['library_ms']:.4f} ms")
        f32_part = ("" if f32 is None else
                    f"; f32 q err/tol {f32[1]:.3f}")
        print(f"kernels: A1 {name:12s} rows {b} heads {h} l {l} end {end} "
              f"({row['warps']} warps): max err {err:.3e} (err/tol "
              f"{worst:.3f} <= 1), {moved:.3%} of outputs off the chain's"
              f"{f32_part}; kernel {row['ms']:.4f} ms "
              f"(queued: device {dev:.4f} ms, host {host:.4f} ms a call), "
              f"{row['tflops']:.1f} TFLOP/s, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
              f"{row['bound_ms'] / dev:.3f} of it{extra}")
    d36 = [r for r in rows if r["shape"].startswith("d36")]
    gen_ms = sum(r["device_ms"] for r in d36) * 36 / 8
    bound_ms = sum(r["bound_ms"] for r in d36) * 36 / 8
    print(f"kernels: A1 over a d36-512 generation (10 scales x 36 blocks, "
          f"per image of batch 8): {gen_ms:.3f} ms of device time an image "
          f"(bound {bound_ms:.3f} ms)")
    q32, *codes = _attn_operands(2, 2, 4, 9, 16, gen)
    ops = (q32.to(torch.bfloat16), *codes)
    bad = {"attn_bias": (ops, {"attn_bias": torch.zeros(
               (1, 1, 4, 9), device="cuda")}),
           "float16": (((ops[0].half(),) + ops[1:]), {}),
           "head_dim 32": ((ops[0][..., :32], ops[1][..., :32], ops[2],
                            ops[3][..., :32], ops[4]), {}),
           "codes layout": ((ops[0], ops[1].contiguous().transpose(1, 2)
                             .contiguous().transpose(1, 2), ops[2],
                             ops[3].contiguous().transpose(1, 2)
                             .contiguous().transpose(1, 2), ops[4]), {})}
    before = PA.attn_launches
    for what, (args, kw) in bad.items():
        try:
            PA.packed_attention(*args, **kw)
        except (ValueError, TypeError, RuntimeError):
            continue
        fail(f"kernels: A1 took operands with {what}")
    if PA.attn_launches != before:
        fail("kernels: A1 launched on operands it refuses")
    print(f"kernels: A1 refuses {', '.join(bad)} on the card without a "
          "launch")
    return {"rows": rows, "gen_ms": gen_ms, "bound_ms": bound_ms}


def _other_lib(root: str, name: str, like):
    """``csrc/<name>.cu`` of the checkout at ``root``, built as this
    checkout's sources are and loaded with the C signature of ``like``
    (this checkout's library of the same source)."""
    import ctypes

    from fpqvar_tpu_torch.ops import _build

    csrc = Path(root) / "fpqvar_tpu_torch" / "csrc"
    src = csrc / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    nvcc = _build._nvcc()
    path = _build._compile(name, text, _build.NVCC_FLAGS,
                           lambda out: [nvcc, *_build.NVCC_FLAGS, "-o", out,
                                        str(src)])
    lib = ctypes.CDLL(str(path))
    for fn in (name, f"{name}_error_string"):
        mine, theirs = getattr(like, fn), getattr(lib, fn)
        theirs.argtypes, theirs.restype = mine.argtypes, mine.restype
    regs = [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
            if "registers" in ln or "spill" in ln]
    return lib, regs


def quant_ab(root: str, out_path: str = None) -> int:
    """``--quant-ab``: Q1, Q2 and Q3 of this checkout beside those of the
    checkout at ``root``, at every ``QUANT_CASES`` and ``Q3_CASES`` shape
    and at Q3's per-scale shapes, the rows written to ``out_path`` as JSON
    where given (see the module docstring)."""
    from fpqvar_tpu_torch.ops import _build
    from fpqvar_tpu_torch.ops import quant_kernels as QK

    card = phase_device()
    mine = {"fake_quant_grid": QK._grid_lib(), "grid_codes": QK._codes_lib(),
            "fake_quant_int": QK._int_lib()}
    libs = {"this": dict(mine), "other": {}}
    for name, lib in mine.items():
        libs["other"][name], regs = _other_lib(root, name, lib)
        print(f"quant_ab: {name} of {root}: {'; '.join(regs)}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    cases = []
    for kern, name, note, call, fmt, arg, shape, dtype, amp in QUANT_CASES:
        x = _quant_input(shape, dtype, amp, gen)
        cases.append((kern, name, note, None, *_quant_case(call, fmt, arg, x)))
    for name, note, shape, dtype, amp, n_bits, asym, gran in Q3_CASES:
        x = _quant_input(shape, dtype, amp, gen)
        cases.append(("Q3", name, note, None,
                      *_q3_case(x, n_bits, asym, gran)))
    for name, calls, x, asym in _q3_scale_inputs(gen):
        cases.append(("Q3", name, "int4_rtn per scale", calls,
                      *_q3_case(x, 4, asym, "per_token")))
    out = []
    for kern, name, note, calls, run, plain, nbytes in cases:
        want = plain()
        times = {"this": [], "other": []}
        for tree in ("other", "this", "this", "other"):
            _build._libs.update(libs[tree])
            _bit_check(kern, f"{name} ({tree})", run(), want)
            dev, host = queued_ms(run)
            times[tree].append({"ms": cuda_ms(run), "device_ms": dev,
                                "host_ms": host})
        _build._libs.update(libs["this"])
        bound = nbytes / H100_BYTES * 1e3
        row = {"kernel": kern, "shape": name, "recipes": note,
               "bytes": nbytes, "bound_ms": bound, **times}
        if calls is not None:
            row["calls"] = calls
        out.append(row)
        dev = {t: [r["device_ms"] * 1e3 for r in v] for t, v in times.items()}
        share = bound * 1e3 / min(dev["this"])
        print(f"quant_ab: {kern} {name:24s} dev us other "
              f"{dev['other'][0]:.1f} / {dev['other'][1]:.1f}, this "
              f"{dev['this'][0]:.1f} / {dev['this'][1]:.1f}; bound "
              f"{bound * 1e3:.2f} us, this {share:.3f} of it")
    scales = [r for r in out if "calls" in r]
    for tree in ("other", "this"):
        per_turn = [_generation_ms(
            [{"calls": r["calls"], "t": r[tree][i]["device_ms"]}
             for r in scales], "t") for i in range(2)]
        print(f"quant_ab: Q3 per scale, 16 blocks x a scale set's four "
              f"calls, {tree}: {per_turn[0]:.3f} / {per_turn[1]:.3f} ms of "
              f"device time a d16 batch-8 int4_rtn generation (bound "
              f"{_generation_ms(scales, 'bound_ms'):.3f} ms)")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card, "other": root, "rows": out}, f,
                      indent=1)
    print(json.dumps({"quant_ab": len(out), "card": card}))
    return 0


def _recipes() -> dict:
    """Every recipe by name: ``bench_recipes`` and ``paper_recipes``."""
    from fpqvar_tpu_torch.config import bench_recipes, paper_recipes

    return {**bench_recipes(), **paper_recipes()}


def _small_recipes():
    """The small-reference recipes by name: (recipe, shared_aln).  The
    ``bench_recipes`` entries, W6A6 on the packed backend, the paper's six
    and a shared-AdaLN model under ``bf16`` and ``fp4_kv6``."""
    from fpqvar_tpu_torch.config import fpqvar_w6a6

    names = ("int8", "bf16", "packed", "w4a16p", "fake", "int8ch", "int8chs",
             "int8chsnr", "w4a16", "int8kv", "int8att", "fp4", "fp4_kv6",
             "fp6", "fp6_kv6", "int4_rtn", "fp4_pertensor")
    recipes = {m: (_recipes()[m], False) for m in names}
    recipes["w6a6-packed"] = (fpqvar_w6a6().replace(backend="packed"), False)
    recipes["shared_aln-bf16"] = (_recipes()["bf16"], True)
    recipes["shared_aln-fp4_kv6"] = (_recipes()["fp4_kv6"], True)
    return recipes


def phase_small_reference():
    """Width-256 generations (every grouped linear has more than one scale
    group; a shared-AdaLN model besides) on the card against the same
    generations on the CPU, at top_k=1 and float32 compute: the sampled
    tokens of every scale must be the same, and the images within 1e-4.

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

    cfgs = {shared: dataclasses.replace(var_tiny(), embed_dim=256,
                                        num_heads=4, shared_aln=shared)
            for shared in (False, True)}
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((2, 256)))
                 .astype(np.float32) for _ in range(2))
    params = {shared: init_var_params(c, seed=4, device="cpu",
                                      adaln_gamma_std=0.02)
              for shared, c in cfgs.items()}
    vae = init_vqvae_params(cfgs[False].vae, seed=5, device="cpu")
    labels = [3, 5, 7]
    sample = V.sample_with_top_k_top_p
    seen = []

    def recorded(logits, *args, **kw):
        idx = sample(logits, *args, **kw)
        seen.append((idx.cpu(), logits.float().cpu()))
        return idx

    V.sample_with_top_k_top_p = recorded
    try:
        for mode, (q, shared) in _small_recipes().items():
            cfg = cfgs[shared]
            out, steps = {}, {}
            for dev in ("cpu", "cuda"):
                qp = quantize_var_params(_to(params[shared], dev), cfg, q,
                                         galt=galt)
                g = VARGenerator(cfg, q, GenerateConfig(top_k=1, top_p=0.0),
                                 cache_dtype=torch.float32,
                                 compute_dtype=torch.float32, device=dev,
                                 fuse_steps=False)
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
            "K7": ("probe_gemm", "bf16_launches"),
            "Q1": ("quant_kernels", "grid_launches"),
            "Q2": ("quant_kernels", "codes_launches"),
            "Q3": ("quant_kernels", "int_launches"),
            "A1": ("packed_attention", "attn_launches")}
#: the recipes profiled after the main path (phase 6)
PROFILED = ("int8", "bf16", "packed", "int8ch", "int8chs", "int8kv",
            "fp4_kv6", "fp6_kv6", "int4_rtn")


def _counter_modules():
    from fpqvar_tpu_torch.ops import (int8_matmul, packed_attention,
                                      probe_gemm, quant_kernels,
                                      quant_matmul)

    return {"int8_matmul": int8_matmul, "quant_matmul": quant_matmul,
            "probe_gemm": probe_gemm, "quant_kernels": quant_kernels,
            "packed_attention": packed_attention}


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
    packed KV cache adds no GEMM), K6 and K7 under none; the quantizers Q1
    (``packed`` and the paper's ``fp4_kv6`` and ``fp6_kv6``, their KV
    caches too), Q2 (``int8``, the dual-grid fc2 of the per-channel
    recipes, the packed KV encodes) and Q3 (``int4_rtn``) exactly as
    ``per_gen`` says.  Returns the launch totals, the profiled recipes'
    (gen, params, generator) and the VQVAE params."""
    from fpqvar_tpu_torch.config import GenerateConfig, var_d16
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
    # GEMMs (dual grid), each activation quantized by Q2 first; packed
    # fake-quantizes its four activations with Q1 (fc2's on the dual grid)
    # and runs K2; int8ch runs K4 on qkv, proj and fc1 and fc2's dual grid
    # (Q2's codes) as two K3 GEMMs; int8chs and int8chsnr run K4 on all
    # four; w4a16 runs no kernel (wonly_dot); int8kv and int8att are int8ch
    # with the packed KV cache, whose k and v Q2 encodes, and int8kv's
    # attention over the value codes runs A1 once a block; the paper's
    # fake recipes run Q1 on their four activations (fp4_kv6, fp6_kv6) and
    # their dense cache's k and v, or Q3 on the four (int4_rtn)
    none = {k: 0 for k in COUNTERS}
    per_gen = {"int8": {**none, "K1": blocks * 2, "K5": blocks * 3,
                        "Q2": blocks * 4},
               "bf16": none,
               "packed": {**none, "K2": blocks * 4, "Q1": blocks * 4},
               "w4a16p": {**none, "K2": blocks * 4},
               "int8ch": {**none, "K3": blocks * 2, "K4": blocks * 3,
                          "Q2": blocks},
               "int8chs": {**none, "K4": blocks * 4},
               "int8chsnr": {**none, "K4": blocks * 4},
               "w4a16": none,
               "int8kv": {**none, "K3": blocks * 2, "K4": blocks * 3,
                          "Q2": blocks * 3, "A1": blocks},
               "int8att": {**none, "K3": blocks * 2, "K4": blocks * 3,
                           "Q2": blocks * 3},
               "fp4_kv6": {**none, "Q1": blocks * 6},
               "fp6_kv6": {**none, "Q1": blocks * 6},
               "int4_rtn": {**none, "Q3": blocks * 4}}
    totals = dict(none)
    results, setups = {}, {}
    for mode in per_gen:
        q = _recipes()[mode]
        t0 = time.perf_counter()
        qp = quantize_var_params(params, cfg, q, galt=galt)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        gen = VARGenerator(cfg, q, GenerateConfig(), fuse_steps=False)
        rng_gen = torch.Generator(device="cuda")
        rng_gen.manual_seed(3)
        times, host_cpu, images = [], [], []
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
            images.append(imgs)
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
            # the eager images and times, for the fused phase (10)
            setups[mode] = (gen, qp, rng_gen, {
                "images": images, "ms": [t * 1e3 for t in times],
                "host_cpu_ms": [t * 1e3 for t in host_cpu]})
    print("main path: steady time against bf16: " + ", ".join(
        f"{m} {results[m] / results['bf16']:.3f}" for m in results)
        + f" on {card}; launches over the main path: "
        + ", ".join(f"{k} {n}" for k, n in totals.items()))
    labels = torch.arange(batch, device="cuda")
    for mode in PROFILED:
        gen, qp, rng_gen, _ = setups[mode]
        phase_profile(mode, lambda: gen.generate(qp, vae, labels, rng_gen),
                      card, per_gen[mode])
    return totals, setups, vae, per_gen


def phase_profile(mode: str, run, card: str, launches: dict,
                  required: bool = False, batch: int = 8,
                  what: str = "generation"):
    """Where one generation's (or ``what``'s) time goes: torch.profiler
    over one batch-8 generation (after the main path's counts were read),
    summing the device
    time of every CUDA kernel; each port kernel must show as many launches
    as the generation makes (``launches``, by K1..K7), so that its time is
    found under its name.  Returns ``{"wall_ms", "busy_ms", "kernels",
    "idle", "port_ms"}`` (``port_ms``: device ms by port kernel), or None
    where the profiler recorded no kernel time (a failure if
    ``required``: the kernel counts are a gate there)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: the busy time, the kernel counts and the idle
    # share need no host-op trace, whose events (several a kernel) would
    # slow both the traced host and the trace's processing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_events(prof)

    def dev_ms(e):
        return _self_device_us(e) / 1e3

    busy = sum(dev_ms(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    if busy <= 0.0:
        if required:
            fail(f"profile: {mode}: the profiler recorded no kernel time, "
                 "so the kernel counts cannot be checked")
        print(f"profile: {mode}: device time not measured (the profiler "
              f"recorded no kernel time); wall {wall_ms:.1f} ms")
        return None
    ours, port_ms = [], {}
    for label, keys in PORT_KERNELS.items():
        hits = [e for e in kernels if any(k in e.key for k in keys)]
        n = sum(e.count for e in hits)
        want = launches[label.split()[0]]
        if n != want:
            fail(f"profile: {mode}: {n} kernels named like {label} "
                 f"({', '.join(keys)}), {want} launches expected")
        ms = sum(dev_ms(e) for e in hits)
        port_ms[label] = ms
        ours.append(f"{label} {ms:.2f} ms in {n} launches "
                    f"({ms / busy:.3f} of busy)")
    top = sorted(kernels, key=dev_ms, reverse=True)[:6]
    print(f"profile: {mode} batch-{batch} {what} under the profiler: wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms in {n_kernels} "
          f"kernel launches, idle share {1.0 - busy / wall_ms:.3f}; "
          f"{'; '.join(ours)}; on {card}")
    for e in top:
        print(f"profile: {mode}   {dev_ms(e):8.2f} ms {e.count:6d}x "
              f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "kernels": n_kernels,
            "idle": 1.0 - busy / wall_ms, "port_ms": port_ms}


def _fused_run(gen, qp, vae, label_sets, seed: int):
    """Generations of ``gen`` from one generator seeded ``seed``, one per
    label set, each timed on the host clock (ending in a synchronize) and
    by the host thread's CPU time inside ``generate``: (images, ms,
    host CPU ms)."""
    rng_gen = torch.Generator(device="cuda")
    rng_gen.manual_seed(seed)
    images, ms, host_cpu = [], [], []
    for labels in label_sets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c0 = time.thread_time()
        images.append(gen.generate(qp, vae, labels, rng_gen))
        host_cpu.append((time.thread_time() - c0) * 1e3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return images, ms, host_cpu


def phase_fused(setups, vae, per_gen: dict, card: str,
                q3_scales_ms: float):
    """The engine's fused mode (CUDA graphs) at VAR-d16 batch 8 under the
    profiled recipes, beside phase 5's eager generations of the same
    trees: two generations from a generator seeded as phase 5's (3), on
    phase 5's labels, must give phase 5's images (``torch.equal``, read
    after both ran: the second replay must not overwrite the first call's
    result), and one more replay under torch.profiler must launch each
    port kernel as often as one eager generation does (``per_gen``; the
    host counters see only the warm-up and the capture).  Prints eager and
    fused ms per batch and img/s, the host CPU ms inside ``generate``, the
    warm-up and capture times, the graphs' pool bytes and the replay's
    idle share; under ``int4_rtn``, Q3's time in the replay beside
    ``q3_scales_ms``, phase 3's per-scale times summed for a
    generation."""
    from fpqvar_tpu_torch.models import VARGenerator

    batch = 8
    label_sets = [torch.arange(i * batch, (i + 1) * batch, device="cuda")
                  for i in range(2)]
    summary = []
    for mode in PROFILED:
        eager_gen, qp, _, eager = setups[mode]
        gen = VARGenerator(eager_gen.cfg, eager_gen.qcfg, eager_gen.gen,
                           qrt=eager_gen.qrt)
        captures = count_captures(gen)
        torch.cuda.empty_cache()
        images, ms, host_cpu = _fused_run(gen, qp, vae, label_sets, seed=3)
        stats = gen.capture_stats(batch)
        for i, (got, want) in enumerate(zip(images, eager["images"])):
            if not torch.equal(got, want):
                diff = float((got - want).abs().max())
                fail(f"fused {mode}: generation {i} differs from the eager "
                     f"loop's (max diff {diff})")
        if len(captures) != 1:
            fail(f"fused {mode}: {len(captures)} captures for one batch "
                 "size")
        prof = phase_profile(
            f"fused {mode}", lambda: gen.generate(qp, vae, label_sets[0]),
            card, per_gen[mode], required=True)
        e_ms, f_ms = eager["ms"][-1], ms[-1]
        summary.append(f"{mode} {e_ms / f_ms:.3f}")
        if per_gen[mode]["Q3"]:
            q3 = prof["port_ms"]["Q3"]
            print(f"fused: {mode}: Q3 {q3:.3f} ms in the replay "
                  f"({per_gen[mode]['Q3']} launches), phase 3's per-scale "
                  f"times summed for a generation {q3_scales_ms:.3f} ms "
                  f"({q3_scales_ms / q3:.3f}x); on {card}")
        print(f"fused: {mode}: images torch.equal to the eager loop's for "
              f"both generations; eager ms/batch-of-{batch} "
              f"{', '.join(f'{t:.1f}' for t in eager['ms'])} (host CPU "
              f"{', '.join(f'{t:.1f}' for t in eager['host_cpu_ms'])}), "
              f"steady {batch / e_ms * 1e3:.2f} img/s; fused "
              f"{', '.join(f'{t:.1f}' for t in ms)} (first includes warm-up "
              f"{stats['warmup_s']:.2f} s and capture "
              f"{stats['capture_s']:.2f} s; host CPU "
              f"{', '.join(f'{t:.1f}' for t in host_cpu)}), steady "
              f"{batch / f_ms * 1e3:.2f} img/s; graph pool "
              f"{stats['pool_bytes']} bytes "
              f"({stats['pool_bytes'] / 1e9:.3f} GB); replay under the "
              f"profiler: wall {prof['wall_ms']:.1f} ms, busy "
              f"{prof['busy_ms']:.1f} ms in {prof['kernels']} kernels, idle "
              f"share {prof['idle']:.3f}; on {card}")
        del gen, images
        torch.cuda.empty_cache()
    print("fused: steady eager ms / fused ms: " + ", ".join(summary)
          + f" on {card}")


def _images_ok(label: str, img, shape) -> None:
    if tuple(img.shape) != shape:
        fail(f"{label}: image of shape {tuple(img.shape)}, expected {shape}")
    if not bool(torch.isfinite(img).all()):
        fail(f"{label}: non-finite image values")
    lo, hi = float(img.min()), float(img.max())
    if lo < 0.0 or hi > 1.0:
        fail(f"{label}: image values outside [0, 1]: {lo}, {hi}")


def _serve(gen, qp, vae, max_batch: int, n_burst: int, repeat_at: int):
    """A ``GenerationServer`` over ``gen``: one request alone, then a burst
    of ``n_burst`` with that request again at ``repeat_at``, with the
    launch counts set to 0 just before and read just after.  Returns the
    lone image, the burst's images and latencies (s), its wall time, the
    stats before and after the burst and the launch counts."""
    from fpqvar_tpu_torch.serving import GenerationServer

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
    return lone, imgs, lat, wall, st0, st, counts


def phase_serving(setups, vae, card: str):
    """The d16 ``int8`` and ``bf16`` generators of the main path behind a
    ``GenerationServer`` with max_batch 8, with the launch counts set to 0
    just before each recipe and read just after.  Beside it, direct batch-8
    generations on the main thread, timed in the same phase: with one
    generator and with one per row (the server's call).  Then the same
    server over a fused generator of the same recipe and tree (CUDA
    graphs, captured by the server's first batch): the repeat equal to its
    lone twin and every image equal to the eager server's, the depth-2
    pipeline used, and one direct replay under CUDA's sync debug mode set
    to raise."""
    from fpqvar_tpu_torch.config import bench_recipes
    from fpqvar_tpu_torch.models import VARGenerator
    from fpqvar_tpu_torch.serving import row_seed
    from fpqvar_tpu_torch.tools import serving_bench

    max_batch, n_burst, repeat_at = 8, 20, 11
    for mode in ("int8", "bf16"):
        gen, qp = setups[mode][:2]
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

        def no_sync(g):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                g.generate(qp, vae, labels, row_gens())
            finally:
                torch.cuda.set_sync_debug_mode("default")

        no_sync(gen)

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

        lone, imgs, lat, wall, st0, st, counts = _serve(
            gen, qp, vae, max_batch, n_burst, repeat_at)
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
            want.update(K1=blocks * 2 * batches, K5=blocks * 3 * batches,
                        Q2=blocks * 4 * batches)
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

        fused = VARGenerator(gen.cfg, gen.qcfg, gen.gen, qrt=gen.qrt)
        captures = count_captures(fused)
        f_lone, f_imgs, f_lat, f_wall, f_st0, f_st, _ = _serve(
            fused, qp, vae, max_batch, n_burst, repeat_at)
        for i, img in enumerate([f_lone] + f_imgs):
            _images_ok(f"serving fused {mode} request {i}", img,
                       (3, 256, 256))
        if not torch.equal(f_imgs[repeat_at], f_lone):
            fail(f"serving fused {mode}: the repeated request differs from "
                 "its lone twin")
        if not torch.equal(f_lone, lone):
            diff = float((f_lone - lone).abs().max())
            fail(f"serving fused {mode}: the lone request differs from the "
                 f"eager server's (max diff {diff})")
        # a row's image depends only on its request, so every burst image
        # equals the eager server's
        bad = [i for i, (a, b) in enumerate(zip(f_imgs, imgs))
               if not torch.equal(a, b)]
        if bad:
            fail(f"serving fused {mode}: burst requests {bad} differ from "
                 "the eager server's")
        f_pipelined = f_st["pipelined"] - f_st0["pipelined"]
        if f_pipelined < 1:
            fail(f"serving fused {mode}: the burst was never pipelined "
                 f"({f_st})")
        if len(captures) != 1:
            fail(f"serving fused {mode}: {len(captures)} captures")
        no_sync(fused)
        stats = fused.capture_stats(max_batch)
        f_lat_ms = np.asarray(f_lat) * 1e3
        f_rate = n_burst / f_wall
        print(f"serving: fused {mode}: saturated {f_rate:.3f} img/s "
              f"(eager {rate:.3f}), burst wall {f_wall * 1e3:.1f} ms, "
              f"latency p50 {np.percentile(f_lat_ms, 50):.1f} ms p99 "
              f"{np.percentile(f_lat_ms, 99):.1f} ms (eager p50 "
              f"{np.percentile(lat_ms, 50):.1f} p99 "
              f"{np.percentile(lat_ms, 99):.1f}), "
              f"{f_st['batches'] - f_st0['batches']} burst batches, "
              f"pipelined {f_pipelined}; every image equal to the eager "
              f"server's, repeat equal to its lone twin; captured once by "
              f"the server's first batch (warm-up {stats['warmup_s']:.2f} s, "
              f"capture {stats['capture_s']:.2f} s, pool "
              f"{stats['pool_bytes']} bytes); a replay queued without a "
              f"host sync; on {card}")
        del fused
        torch.cuda.empty_cache()
    res = serving_bench.run_recipe(gen.cfg, bench_recipes()["int8"], vae,
                                   salt=12345, n=16, unloaded=2, poisson=0,
                                   max_batch=max_batch)
    brief = {k: ({kk: vv for kk, vv in v.items() if kk != "samples_ms"}
                 if isinstance(v, dict) else v) for k, v in res.items()}
    print(f"serving: tools/serving_bench.run_recipe int8 d16 (n 16, "
          f"unloaded 2, max_batch {max_batch}; synth_device_params, fused "
          f"generator) on {card}: {json.dumps(brief)}")


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


def phase_d36(card: str):
    """VAR-d36-512 at its full width and depth (width 2304, 36 heads,
    depth 36, L = 2240, shared AdaLN) with the 512 px VQVAE, random seeded
    float32 weights: ``bf16`` and the paper's ``fp4_kv6`` (``run.sh``'s
    512 px flags) for two generations of 2 labels each, with every launch
    count set to 0 just before and read just after (no GEMM of the port
    runs under either; ``fp4_kv6`` runs Q1 six times a block forward:
    its four activations and the cache's k and v).  ``fp4_kv6``'s
    ``quantize_var_params`` is timed
    with its float64 host rotation apart, and beside it the device
    transform (``transform_blocks_traced``, float32 on the card) of the
    same blocks, with the weights where the two differ counted (a finding,
    not a gate: the float32 sums run in another order).  Each recipe
    prints ms per generation, img/s, the KV cache's bytes and the peak of
    device memory (above what was resident, and in all), then one more
    eager generation under torch.profiler counts its kernel launches, and
    a fused generator of the same tree makes the two generations again
    from the same seed and labels: its images must equal the eager ones
    (``torch.equal``)."""
    from fpqvar_tpu_torch.config import GenerateConfig, var_d36_512
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.quantize import quantize_var_params, recipe

    cfg = var_d36_512()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_var_params(cfg, seed=0, device="cuda")
    vae = init_vqvae_params(cfg.vae, seed=1, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"d36-512: VAR-d36-512 (width {cfg.width}, {cfg.heads} heads, depth "
          f"{cfg.depth}, L={cfg.L}, patch_nums {cfg.patch_nums}, shared "
          f"AdaLN) + VQVAE at {cfg.patch_nums[-1] * cfg.vae.downsample} px: "
          f"{n_params} float32 parameters, random init in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))
    batch, n_gen = 2, 2
    side = cfg.patch_nums[-1] * cfg.vae.downsample
    label_sets = [torch.arange(i * batch, (i + 1) * batch, device="cuda")
                  for i in range(n_gen)]
    none = {k: 0 for k in COUNTERS}
    blocks = cfg.depth * cfg.num_scales
    per_gen = {"bf16": none, "fp4_kv6": {**none, "Q1": 6 * blocks}}
    for mode in ("bf16", "fp4_kv6"):
        q = _recipes()[mode]
        t_quant = t_rot = 0.0
        qp = params
        if q.enabled:
            rotate, rot = recipe.rotate_blocks, []

            def timed_rotate(*args, **kw):
                t = time.perf_counter()
                out = rotate(*args, **kw)
                torch.cuda.synchronize()
                rot.append(time.perf_counter() - t)
                return out

            recipe.rotate_blocks = timed_rotate
            try:
                t0 = time.perf_counter()
                qp = quantize_var_params(params, cfg, q, galt=galt)
                torch.cuda.synchronize()
                t_quant = time.perf_counter() - t0
            finally:
                recipe.rotate_blocks = rotate
            t_rot = sum(rot)
            t0 = time.perf_counter()
            dev_blocks = recipe.transform_blocks_traced(params["blocks"], cfg,
                                                        q, galt)
            torch.cuda.synchronize()
            t_dev = time.perf_counter() - t0
            keys = ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w")
            differ = {k: int((dev_blocks[k] != qp["blocks"][k]).sum())
                      for k in keys}
            # a last-bit change of a group's absmax moves its scale and so
            # every weight of the group by an ulp; another fp4 grid value
            # moves a weight by a third of its size or more (or to zero)
            grid_moves = sum(
                int(((dev_blocks[k] - qp["blocks"][k]).abs()
                     > 1e-3 * qp["blocks"][k].abs()).sum()) for k in keys)
            total = sum(qp["blocks"][k].numel() for k in keys)
            del dev_blocks
            torch.cuda.empty_cache()
            print(f"d36-512: {mode}: quantize_var_params {t_quant:.2f} s "
                  f"(float64 host rotation {t_rot:.2f} s) against the device "
                  f"transform transform_blocks_traced {t_dev * 1e3:.1f} ms "
                  f"in the same phase; block weights that differ between "
                  f"the two: {sum(differ.values())} of {total} "
                  f"({sum(differ.values()) / total:.3e}; "
                  + ", ".join(f"{k} {n}" for k, n in differ.items())
                  + f"), of which {grid_moves} by more than a relative 1e-3 "
                  f"(another grid value); on {card}")
        gen = VARGenerator(cfg, q, GenerateConfig(), fuse_steps=False)
        rng_gen = torch.Generator(device="cuda")
        rng_gen.manual_seed(3)
        kv_bytes = sum(t.nbytes for t in gen.init_cache(batch).values())
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, host_cpu, eager = [], [], []
        for i, labels in enumerate(label_sets):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c0 = time.thread_time()
            imgs = gen.generate(qp, vae, labels, rng_gen)
            host_cpu.append(time.thread_time() - c0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            _images_ok(f"d36-512 {mode} generation {i}", imgs,
                       (batch, 3, side, side))
            eager.append(imgs)
        counts = read_counts()
        want = {k: n * n_gen for k, n in per_gen[mode].items()}
        if counts != want:
            fail(f"d36-512 {mode}: launches {counts}, expected {want}")
        peak = torch.cuda.max_memory_allocated()
        quant = ("" if not q.enabled else
                 f"quantize_var_params {t_quant:.2f} s, of which the float64 "
                 f"host rotation {t_rot:.2f} s; ")
        print(f"d36-512: {mode}: {quant}ms per generation of {batch} = "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times)} (first includes "
              f"warm-up), host CPU ms in generate "
              f"{', '.join(f'{t * 1e3:.1f}' for t in host_cpu)}; steady "
              f"{batch / times[-1]:.3f} img/s; KV cache {kv_bytes} bytes "
              f"({kv_bytes / 1e9:.3f} GB); peak allocated {peak} bytes "
              f"({peak / 1e9:.3f} GB), {peak - resident} above the "
              f"{resident / 1e9:.3f} GB resident; images [{batch}, 3, {side}, "
              f"{side}] finite in [0, 1]; launches per generation "
              + (", ".join(f"{k} {n // n_gen}" for k, n in counts.items()
                           if n) or "none")
              + f" (exact); on {card}")
        phase_profile(f"d36-512 eager {mode}",
                      lambda: gen.generate(qp, vae, label_sets[0], rng_gen),
                      card, per_gen[mode], batch=batch)
        fused = VARGenerator(cfg, q, GenerateConfig(), qrt=gen.qrt)
        torch.cuda.empty_cache()
        images, ms, f_host = _fused_run(fused, qp, vae, label_sets, seed=3)
        stats = fused.capture_stats(batch)
        for i, (got, want) in enumerate(zip(images, eager)):
            if not torch.equal(got, want):
                diff = float((got - want).abs().max())
                fail(f"d36-512 fused {mode}: generation {i} differs from the "
                     f"eager loop's (max diff {diff})")
        print(f"d36-512: fused {mode}: images torch.equal to the eager "
              f"loop's for both generations; ms per generation of {batch} = "
              f"{', '.join(f'{t:.1f}' for t in ms)} (first includes warm-up "
              f"{stats['warmup_s']:.2f} s and capture "
              f"{stats['capture_s']:.2f} s; host CPU "
              f"{', '.join(f'{t:.1f}' for t in f_host)}), steady "
              f"{batch / ms[-1] * 1e3:.3f} img/s (eager "
              f"{batch / times[-1]:.3f}); graph pool {stats['pool_bytes']} "
              f"bytes ({stats['pool_bytes'] / 1e9:.3f} GB), peak allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; on {card}")
        del qp, gen, fused, images, eager
        torch.cuda.empty_cache()


def phase_transform(card: str):
    """The device transform at width 256 (``var_tiny`` widened; block
    rotation, GALT) under ``int8``, ``packed`` and ``fake``:
    ``transform_blocks_traced`` on the card against the same transform on
    the CPU.  The rotated weights must agree within the bound of two
    float32 sums in different orders (``tests/test_torch_transform.py``:
    ``2 * 128 * 2^-24 * sum|w * q|``, here with TF32 left on, which the
    transform must override), and the quantize stage on the card, given the
    CPU's rotated weights, must equal the CPU's bit for bit; the codes (or
    fake weights) of the whole transforms that differ are counted, where
    the float32 rotation summed in another order.  Then a fused generation
    from ``synth_device_params`` of each recipe: images finite in
    [0, 1]."""
    from fpqvar_tpu_torch.config import GenerateConfig, var_tiny
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.ops import hadamard as H
    from fpqvar_tpu_torch.quantize import recipe

    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    blocks = init_var_params(cfg, seed=6, device="cpu",
                             adaln_gamma_std=0.02)["blocks"]
    on_card = _to(blocks, "cuda")
    rng = np.random.default_rng(7)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))
    qmat = np.abs(H.block_hadamard_block(128, 42))
    vae = init_vqvae_params(cfg.vae, seed=8, device="cuda")
    keys = ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w")

    def parts(leaf):
        return ([leaf] if isinstance(leaf, torch.Tensor)
                else [leaf.codes, leaf.scales])

    for mode in ("int8", "packed", "fake"):
        q = _recipes()[mode]
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            rot_card = recipe._rotate_f32(on_card, cfg, q, galt)
            whole_card = recipe.transform_blocks_traced(on_card, cfg, q, galt)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        rot_cpu = recipe._rotate_f32(blocks, cfg, q, galt)
        worst = 0.0
        for key, g in zip(("mat_qkv_w", "fc1_w"), galt):
            w = np.abs(blocks[key].double().numpy() / g[:, None, :])
            d, o, i = w.shape
            bound = 2 * 128 * 2.0 ** -24 * (
                w.reshape(d, o, i // 128, 128) @ qmat).reshape(d, o, i)
            diff = (rot_card[key].cpu().double() - rot_cpu[key].double()
                    ).abs().numpy()
            if not (diff <= bound).all():
                fail(f"transform {mode}: rotated {key} outside the float32 "
                     f"bound (worst diff/bound {float((diff / bound).max())})")
            worst = max(worst, float((diff / bound).max()))
        staged = _to(rot_cpu, "cuda")
        q_card = recipe._quantize_traced(staged, q, torch.float32)
        q_cpu = recipe._quantize_traced(rot_cpu, q, torch.float32)
        whole_cpu = recipe.transform_blocks_traced(blocks, cfg, q, galt)
        for key in keys:
            for a, b in zip(parts(q_card[key]), parts(q_cpu[key])):
                if not torch.equal(a.cpu(), b):
                    fail(f"transform {mode}: the card's quantize stage "
                         f"differs from the CPU's at {key}")
        n_diff = sum(int((a.cpu() != b).sum())
                     for key in keys
                     for a, b in zip(parts(whole_card[key])[:1],
                                     parts(whole_cpu[key])[:1]))
        n_all = sum(parts(whole_cpu[key])[0].numel() for key in keys)
        n_rot = sum(int((rot_card[k].cpu() != rot_cpu[k]).sum())
                    for k in ("mat_qkv_w", "fc1_w"))
        params = recipe.synth_device_params(cfg, q, seed=9, galt=galt)
        gen = VARGenerator(cfg, q, GenerateConfig())
        captures = count_captures(gen)
        labels = torch.tensor([3, 5, 7], device="cuda")
        imgs = gen.generate(params, vae, labels)
        _images_ok(f"transform {mode} synth_device_params generation", imgs,
                   (3, 3, 6, 6))
        print(f"transform: {mode} width 256: card vs CPU rotated weights "
              f"within the float32 bound (worst diff/bound {worst:.3f}; "
              f"{n_rot} of {rot_cpu['mat_qkv_w'].numel() + rot_cpu['fc1_w'].numel()} "
              f"rotated values differ); quantize stage equal given the same "
              f"rotated weights; whole transform: {n_diff} of {n_all} codes "
              f"differ; a fused generation from synth_device_params finite "
              f"in [0, 1] ({len(captures)} capture); on {card}")


def phase_teacher_kernels() -> dict:
    """K1-K5 at the shapes the d16 teacher-forcing forward gives them (M =
    5440, ``TF_SHAPES``), against their plain versions with phase 3's
    tolerances and timed as phase 3 times them: K1 at fc2 (``int8``'s
    dual grid, float32 out), K2 at all four linears (bfloat16 x, fp_e2
    nibbles, ``packed``), K3 at fc2 (``int8ch``'s dual grid, float32 out),
    K4 at qkv, proj and fc1 (bfloat16 x and out) and K5 at qkv, proj and
    fc1 as ``[8, 680, K]`` (bfloat16 out, also equal to K1 followed by a
    cast).  Returns each kernel's rows."""
    from fpqvar_tpu_torch.ops import int8_matmul as K
    from fpqvar_tpu_torch.ops import packing as P
    from fpqvar_tpu_torch.ops import quant_matmul as QM

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = {name: (m, k, n) for name, m, k, n in TF_SHAPES}
    rows = {kern: [] for kern in ("K1", "K2", "K3", "K4", "K5")}

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def matmul(m, k, n, dtype=bf16):
        a, b = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype)
        return lambda: torch.matmul(a, b)

    m, k, n = shapes["fc2"]
    g = k // 128
    ops = _k1_operands(m, k, n, gen) + (128,)
    rows["K1"].append(check_and_time(
        "K1 teacher", {"shape": "fc2", "M": m, "K": k, "N": n, "group": 128},
        lambda: K.int8_group_gemm(*ops), lambda: K.int8_group_gemm_ref(*ops),
        lambda: K.int8_group_gemm_tolerance(*ops), matmul(m, k, n),
        m * k + m * g * 4 + n * k + g * n * 4 + m * n * 4, H100_INT8_OPS,
        f"{K.K1_REL_TOL:g}*sum_g|sa*sw*part|", "bf16 torch.matmul"))
    for name, (m, k, n) in shapes.items():
        x, w = randn(m, k, dtype=bf16), randn(n, k) * 0.02
        pw = P.pack(w, "fp_e2", 128)
        ops = (x, pw.codes, pw.scales, "fp_e2", 128, pw.nibble_packed)
        rows["K2"].append(check_and_time(
            "K2 teacher", {"shape": name, "M": m, "K": k, "N": n,
                           "fmt": "fp_e2", "x": "bfloat16", "group": 128},
            lambda: QM.packed_matmul(*ops), lambda: QM.packed_matmul_ref(*ops),
            lambda: QM.packed_matmul_tolerance(*ops), matmul(m, k, n),
            x.numel() * 2 + pw.codes.numel() + pw.scales.numel() * 4
            + m * n * 4, H100_BF16_FLOPS,
            f"{QM.K2_REL_TOL:g}*sum_g|s|*sum_k|x*grid|", "bf16 torch.matmul"))
    m, k, n = shapes["fc2"]
    x, w = randn(m, k), randn(n, k) * 0.02
    ac, asc = P.quant_int_codes(x, "fp_e2", k)
    pw = P.pack_int_codes(w, "fp_e2", k)
    ops = (ac, asc, pw.codes, pw.scales, f32)
    rows["K3"].append(check_and_time(
        "K3 teacher", {"shape": "fc2", "M": m, "K": k, "N": n,
                       "out": "float32"},
        lambda: K.int8ch_gemm(*ops), lambda: K.int8ch_gemm_ref(*ops), None,
        matmul(m, k, n), m * k + m * 4 + n * k + n * 4 + m * n * 4,
        H100_INT8_OPS, "", "bf16 torch.matmul", int_mm=_int_mm(m, k, n, gen)))
    for name in ("qkv", "proj", "fc1"):
        m, k, n = shapes[name]
        x, w = (randn(m, k) * 3.0).to(bf16), randn(n, k) * 0.02
        pw = P.pack_int_codes(w, "fp_e2", k)
        ops = (x, pw.codes, pw.scales, "fp_e2", bf16)
        rows["K4"].append(check_and_time(
            "K4 teacher", {"shape": name, "M": m, "K": k, "N": n,
                           "fmt": "fp_e2", "x": "bfloat16"},
            lambda: K.fused_ch_gemm(*ops), lambda: K.fused_ch_gemm_ref(*ops),
            None, matmul(m, k, n),
            m * k * 2 + pw.codes.numel() + pw.scales.numel() * 4 + m * n * 2,
            H100_INT8_OPS, "", "bf16 torch.matmul",
            int_mm=_int_mm(m, k, n, gen)))
    for name in ("qkv", "proj", "fc1"):
        m, k, n = shapes[name]
        b, t, g = 8, m // 8, k // 128
        ac, asc, wc, ws = _k1_operands(m, k, n, gen)
        ac, asc = ac.reshape(b, t, k), asc.reshape(b, t, g)
        ops = (ac, asc, wc, ws, 128, bf16)
        k1_cast = (lambda: K.int8_group_gemm(ac.reshape(m, k),
                                             asc.reshape(m, g), wc, ws,
                                             128).to(bf16))
        if not torch.equal(K.int8_group_gemm_nd(*ops).reshape(m, n),
                           k1_cast()):
            fail(f"K5 teacher {name}: differs from K1 followed by a cast")
        rows["K5"].append(check_and_time(
            "K5 teacher", {"shape": name, "B": b, "T": t, "M": m, "K": k,
                           "N": n, "out": "bfloat16"},
            lambda: K.int8_group_gemm_nd(*ops),
            lambda: K.int8_group_gemm_nd_ref(*ops),
            lambda: K.int8_group_gemm_nd_tolerance(*ops), matmul(m, k, n),
            m * k + m * g * 4 + n * k + g * n * 4 + m * n * 2, H100_INT8_OPS,
            f"{K.K1_REL_TOL:g}*sum_g|sa*sw*part| (+1 bf16 gap)",
            "bf16 torch.matmul", extras=(("k1_cast", k1_cast),)))
    return rows


def _galt(cfg, seed: int = 2):
    rng = np.random.default_rng(seed)
    return tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))


def _teacher_forward(cfg, card: str) -> dict:
    """(a) One teacher-forcing forward of VAR-d16 at batch 8 under each
    recipe of ``TF_LAUNCHES``, on ``synth_device_params`` trees (bf16
    weights; quantized blocks from the device transform) and a bf16
    teacher-forcing input: with the launch counts set to 0 just before
    the forward and read just after, each kernel launched exactly as
    ``TF_LAUNCHES`` says; logits ``[8, 680, 4096]`` float32, finite; ms
    per forward.  Returns the launch totals."""
    from fpqvar_tpu_torch.models import var as V
    from fpqvar_tpu_torch.quantize import recipe
    from fpqvar_tpu_torch.quantize.runtime import build_runtime

    batch = 8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device="cuda")
    x = torch.randn((batch, cfg.L - cfg.first_l, cfg.vae.z_channels),
                    generator=gen, device="cuda").to(torch.bfloat16)
    totals = {k: 0 for k in COUNTERS}
    for mode, want in TF_LAUNCHES.items():
        q = _recipes()[mode]
        params = recipe.synth_device_params(cfg, q, seed=0, galt=_galt(cfg))
        qrt = build_runtime(q, cfg.depth, cfg.width, "cuda")

        def forward():
            return V.var_forward(params, cfg, qrt, labels, x)

        with torch.inference_mode():
            forward()                       # builds, maps, lazy constants
            torch.cuda.synchronize()
            reset_counts()
            logits = forward()
            torch.cuda.synchronize()
            counts = read_counts()
            expect = {k: want.get(k, 0) for k in COUNTERS}
            if counts != expect:
                fail(f"teacher forward {mode}: launches {counts}, expected "
                     f"{expect}")
            if (tuple(logits.shape) != (batch, cfg.L, cfg.vae.vocab_size)
                    or logits.dtype != torch.float32
                    or not bool(torch.isfinite(logits).all())):
                fail(f"teacher forward {mode}: logits {tuple(logits.shape)} "
                     f"{logits.dtype}, finite {bool(torch.isfinite(logits).all())}")
            ms = cuda_ms(forward, reps=5)
        for k, n in counts.items():
            totals[k] += n
        print(f"teacher forcing: (a) d16 var_forward {mode}, batch {batch} "
              f"(M = {batch * cfg.L}): {ms:.2f} ms a forward "
              f"({batch * cfg.L / ms * 1e3:.0f} tokens/s), launches "
              + (", ".join(f"{k} {n}" for k, n in counts.items() if n)
                 or "no port kernel")
              + f"; logits [{batch}, {cfg.L}, {cfg.vae.vocab_size}] finite; "
              f"on {card}")
        del params, logits
        torch.cuda.empty_cache()
    return totals


def _stepwise_vs_masked(cfg, card: str) -> None:
    """(a) The KV-cached scale loop against one masked forward of
    ``run_blocks``, VAR-d16 float32 weights (``adaln_gamma_std=0.02``),
    batch 8, token maps and condition of std 0.1, float32 with TF32 off.
    The two differ only in the order of float32 sums: the linears' (other
    M, other cuBLAS tiles) and the attention's over another number of
    columns (the masked path's ``-inf`` columns add exact zeros).  Under
    the probabilistic rounding model a K-term float32 dot product is off
    by about ``sqrt(K) u`` of its terms; with two paths, each block's
    residual update ``r`` is off by at most ``2 sqrt(4C) u |r|`` (fc2's
    K = 4C the longest sum) plus the residual add's own rounding ``u |x|``
    in each path; near-identity blocks add these over the depth: bound =
    ``2 depth (2 sqrt(4C) u max|r| + u max|x|)`` with ``max|r|`` the
    largest change the blocks made to any element."""
    from fpqvar_tpu_torch.models import var as V
    from fpqvar_tpu_torch.models.var import init_var_params

    batch = 8
    params = init_var_params(cfg, seed=0, device="cuda",
                             adaln_gamma_std=0.02)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    xs = [torch.randn((batch, pn * pn, cfg.width), generator=gen,
                      device="cuda") * 0.1 for pn in cfg.patch_nums]
    cond = torch.randn((batch, cfg.width), generator=gen, device="cuda") * 0.1
    with torch.inference_mode():
        mod = V.compute_modulations(params, cfg, cond)
        cache = V.init_kv_cache(cfg, batch, torch.float32, "cuda")
        outs, cur = [], 0
        for x in xs:
            outs.append(V.run_blocks(params, cfg, None, x, mod, cache, cur))
            cur += x.shape[1]
        stepwise = torch.cat(outs, dim=1)
        x_in = torch.cat(xs, dim=1)
        masked = V.run_blocks(params, cfg, None, x_in, mod,
                              attn_bias=V.attn_bias_for_masking(
                                  cfg, x_in.device))
    diff = float((stepwise - masked).abs().max())
    r = float((masked - x_in).abs().max())
    x_max = float(masked.abs().max())
    u = 2.0 ** -24
    bound = 2 * cfg.depth * (2 * math.sqrt(4 * cfg.width) * u * r
                             + u * x_max)
    if not diff <= bound:
        fail(f"teacher forcing: stepwise vs masked run_blocks max diff "
             f"{diff} exceeds the bound {bound}")
    print(f"teacher forcing: (a) d16 stepwise (KV cache) vs masked "
          f"run_blocks, batch {batch}, float32: max diff {diff:.3e} within "
          f"the derived bound {bound:.3e} (max|r| {r:.4f}, max|x| "
          f"{x_max:.4f}); on {card}")
    del params, cache
    torch.cuda.empty_cache()


def _teacher_small_reference(card: str) -> None:
    """(b) Width 256 (phase 4's model): ``var_forward`` logits and the
    capture taps of a masked ``run_blocks`` under ``bf16``, ``int8``,
    ``packed`` and ``int8ch`` on the card against the CPU, float32
    compute.  The taps (the linears' inputs, before an int8 linear's
    quantizer) and ``bf16``'s logits within phase 4's 1e-4 (float32 sums
    in another order).  The quantized forward is not continuous: an
    activation that lies within a float32 ulp of a grid midpoint takes
    another code on the other device, and one such step moves these
    logits (of order 1) by up to ~2e-4.  So the quantized recipes' logits
    are held within 1e-3, a few such steps, and beside them the phase
    prints how far the CPU's own logits move when the input moves by one
    ulp (``x * (1 + 2^-23)``), the size of one step."""
    from fpqvar_tpu_torch.config import var_tiny
    from fpqvar_tpu_torch.models import var as V
    from fpqvar_tpu_torch.models.var import init_var_params
    from fpqvar_tpu_torch.quantize import quantize_var_params
    from fpqvar_tpu_torch.quantize.runtime import build_runtime

    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    params = init_var_params(cfg, seed=4, device="cpu", adaln_gamma_std=0.02)
    galt = _galt(cfg, seed=5)
    rng = np.random.default_rng(12)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, 3))
    x = torch.from_numpy(rng.standard_normal(
        (3, cfg.L - cfg.first_l, cfg.vae.z_channels)).astype(np.float32))
    tokens = torch.from_numpy(
        (rng.standard_normal((3, cfg.L, cfg.width)) * 0.1).astype(np.float32))
    cond = torch.from_numpy(
        (rng.standard_normal((3, cfg.width)) * 0.1).astype(np.float32))
    for mode in ("bf16", "int8", "packed", "int8ch"):
        q = _recipes()[mode]
        out = {}
        for dev in ("cpu", "cuda"):
            qp = (quantize_var_params(_to(params, dev), cfg, q, galt=galt)
                  if q.enabled else _to(params, dev))
            qrt = build_runtime(q, cfg.depth, cfg.width, dev)
            with torch.inference_mode():
                logits = V.var_forward(qp, cfg, qrt, labels.to(dev),
                                       x.to(dev))
                mod = V.compute_modulations(qp, cfg, cond.to(dev), qrt)
                _, taps = V.run_blocks(
                    qp, cfg, qrt, tokens.to(dev), mod,
                    attn_bias=V.attn_bias_for_masking(cfg, torch.device(dev)),
                    capture=True)
                if dev == "cpu":
                    step = float((V.var_forward(
                        qp, cfg, qrt, labels, x * (1 + 2.0 ** -23))
                        - logits).abs().max())
            out[dev] = (logits.cpu(), {k: v.cpu() for k, v in taps.items()})
        lerr = float((out["cpu"][0] - out["cuda"][0]).abs().max())
        terr = {k: float((out["cpu"][1][k] - out["cuda"][1][k]).abs().max())
                for k in out["cpu"][1]}
        ltol = 1e-3 if q.enabled else 1e-4
        if not (lerr <= ltol and all(e <= 1e-4 for e in terr.values())):
            fail(f"teacher forcing: width-256 {mode} card vs CPU: logits max "
                 f"err {lerr} (tol {ltol}), taps {terr} (tol 1e-4)")
        print(f"teacher forcing: (b) width-256 {mode} var_forward card vs "
              f"CPU: logits max err {lerr:.3e} (tol {ltol:g}; the CPU's "
              f"logits move {step:.3e} when x moves by one ulp), capture "
              f"taps " + ", ".join(f"{k} {e:.3e}" for k, e in terr.items())
              + f" (tol 1e-4); on {card}")


def _teacher_encoder(cfg, card: str):
    """(c) The d16 VQVAE encoder and tokenizer at 256 px, batch 8, random
    seeded weights and images in [-1, 1]: ``img_to_idxBl`` tokens ``[8,
    pn^2]`` per scale and ``idxBl_to_var_input`` ``[8, 679, 32]``, ms per
    batch; then at batch 2 the card's tokens against the CPU's under the
    near-tie rule of ``vqvae.token_agreement`` (no token outside its
    derived bound, under 2% differing).  TF32 is off for the
    convolutions and the distance GEMM.  Returns the batch's (labels,
    teacher-forcing input, target tokens) for training."""
    from fpqvar_tpu_torch.models import vqvae as vq

    batch = 8
    vae = vq.init_vqvae_params(cfg.vae, seed=1, device="cuda")
    side = cfg.patch_nums[-1] * cfg.vae.downsample
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    img = torch.rand((batch, 3, side, side), generator=gen,
                     device="cuda") * 2.0 - 1.0
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device="cuda")

    def tokenize():
        idx = vq.img_to_idxBl(vae, cfg.vae, img)
        return idx, vq.idxBl_to_var_input(vae["quantize"], cfg.vae, idx)

    with torch.inference_mode():
        tokenize()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx, x = tokenize()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        want = [(batch, pn * pn) for pn in cfg.patch_nums]
        if [tuple(t.shape) for t in idx] != want or any(
                int(t.min()) < 0 or int(t.max()) >= cfg.vae.vocab_size
                for t in idx):
            fail(f"teacher forcing: tokens {[tuple(t.shape) for t in idx]}, "
                 f"expected {want} in [0, {cfg.vae.vocab_size})")
        xshape = (batch, cfg.L - cfg.first_l, cfg.vae.z_channels)
        if tuple(x.shape) != xshape or not bool(torch.isfinite(x).all()):
            fail(f"teacher forcing: idxBl_to_var_input {tuple(x.shape)}, "
                 f"expected {xshape} finite")
        vae_cpu = _to(vae, "cpu")
        f_card = vq.encode(vae, cfg.vae, img[:2])
        idx_card = vq.f_to_idxBl(vae["quantize"], cfg.vae, f_card)
        f_cpu = vq.encode(vae_cpu, cfg.vae, img[:2].cpu())
        idx_cpu = vq.f_to_idxBl(vae_cpu["quantize"], cfg.vae, f_cpu)
    ferr = float((f_card.cpu() - f_cpu).abs().max())
    agree = vq.token_agreement(vae_cpu["quantize"], cfg.vae, f_card.cpu(),
                               [t.cpu() for t in idx_card], f_cpu, idx_cpu)
    if agree["beyond"] or agree["differ"] > 0.02 * agree["compared"]:
        fail(f"teacher forcing: card vs CPU tokens outside the near-tie "
             f"rule: {agree}")
    print(f"teacher forcing: (c) d16 VQVAE img_to_idxBl + "
          f"idxBl_to_var_input, batch {batch} at {side} px: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms a batch; tokens "
          f"{want[0]}..{want[-1]}, input {list(xshape)}; card vs CPU at "
          f"batch 2: f max err {ferr:.3e}, tokens {agree['compared']} "
          f"compared, {agree['differ']} differ (all near-ties), "
          f"{agree['left_out']} left out after a difference; on {card}")
    return labels, x.clone(), torch.cat(idx, dim=1).clone()


def _train_cli(out: str):
    cmd = [sys.executable, "-m", "fpqvar_tpu_torch.tools.train", "--depth",
           "16", "--steps", "4", "--save-every", "2", "--out", out]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parent)
    if res.returncode != 0:
        fail(f"teacher forcing: {' '.join(cmd[1:])} exited "
             f"{res.returncode}: {res.stderr[-2000:]}")
    return res.stdout, time.perf_counter() - t0


def _teacher_training(cfg, data, card: str) -> None:
    """(d) VAR-d16 training on the encoder's batch 8 (labels, teacher-
    forcing input, target tokens), mixed precision (bf16 forward off
    float32 master params), AdamW at lr 3e-4, TF32 off: 8 steps on the
    fixed batch, each step's label dropout from a generator seeded by the
    step; the loss must fall and stay finite; step ms (median after the
    first) and tokens/s.  Then the peak of device memory of one forward
    and backward with and without ``remat`` (the ``remat`` peak must be
    lower) and their gradients, ``torch.equal`` under
    ``torch.use_deterministic_algorithms(True)``; a checkpoint of step 8,
    one more step, and a fresh state (other seed) restored by
    ``auto_resume`` taking the same step: params and loss ``torch.equal``
    (deterministic algorithms on); one more step under torch.profiler
    (device busy, idle share, the kernels that take the most time).
    Last, ``tools/train.py --depth 16
    --steps 4 --save-every 2`` twice into one directory: the second run
    resumes at step 4 and adds nothing, ``metrics.jsonl`` keeps its
    line."""
    from fpqvar_tpu_torch.models.var import init_var_params
    from fpqvar_tpu_torch.train import (auto_resume, make_manager,
                                        make_train_state, save_train_state,
                                        train_step)
    from fpqvar_tpu_torch.train.trainer import (loss_fn, make_optimizer,
                                                tree_leaves)

    labels, x, targets = data
    batch = {"label": labels, "x": x, "targets": targets}
    tokens = targets.numel()
    opt = make_optimizer(peak_lr=3e-4)
    state = make_train_state(init_var_params(cfg, seed=0, device="cuda"), opt)

    def dropout(step):
        g = torch.Generator(device="cuda")
        g.manual_seed(100 + step)
        return g

    losses, times = [], []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, cfg, opt, batch, generator=dropout(i),
                              mixed_precision=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    losses = [float(v) for v in losses]
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        fail(f"teacher forcing: d16 training losses {losses}")
    step_ms = float(np.median(times[1:]))

    def grads(remat: bool):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss_fn(state.params, cfg, None, labels, x, targets,
                mixed_precision=True, remat=remat).backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out = []
        for p in tree_leaves(state.params):
            out.append(p.grad)
            p.grad = None
        return out, peak

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        g_plain, peak_plain = grads(False)
        g_remat, peak_remat = grads(True)
        same = all((a is None and b is None) or (
            a is not None and b is not None and torch.equal(a, b))
            for a, b in zip(g_plain, g_remat))
        if not same:
            worst = max(float((a - b).abs().max()) for a, b in
                        zip(g_plain, g_remat) if a is not None)
            fail(f"teacher forcing: remat gradients differ from the plain "
                 f"ones (max diff {worst})")
        if not peak_remat < peak_plain:
            fail(f"teacher forcing: remat peak {peak_remat} bytes not below "
                 f"the plain peak {peak_plain}")
        del g_plain, g_remat
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            t0 = time.perf_counter()
            save_train_state(make_manager(ckpt), state)
            t_save = time.perf_counter() - t0
            state, m_ref = train_step(state, cfg, opt, batch,
                                      generator=dropout(8),
                                      mixed_precision=True)
            ref = [p.detach().clone() for p in tree_leaves(state.params)]
            del state
            torch.cuda.empty_cache()
            fresh = make_train_state(
                init_var_params(cfg, seed=7, device="cuda"), opt)
            t0 = time.perf_counter()
            info, resumed, start = auto_resume(make_manager(ckpt), fresh)
            t_load = time.perf_counter() - t0
            if start != 8 or resumed.step != 8:
                fail(f"teacher forcing: auto_resume gave step {start}: {info}")
            resumed, m_res = train_step(resumed, cfg, opt, batch,
                                        generator=dropout(8),
                                        mixed_precision=True)
            if not (torch.equal(m_res["loss"], m_ref["loss"]) and all(
                    torch.equal(a, b) for a, b in
                    zip(tree_leaves(resumed.params), ref))):
                fail("teacher forcing: the resumed step differs from the "
                     "uninterrupted one")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
    phase_profile("d16 mixed-precision", lambda: train_step(
        resumed, cfg, opt, batch, generator=dropout(9),
        mixed_precision=True), card, {k: 0 for k in COUNTERS},
        what="train_step")
    print(f"teacher forcing: (d) d16 train_step, batch 8 ({tokens} tokens), "
          f"mixed precision, TF32 off: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; step ms "
          f"{', '.join(f'{t:.1f}' for t in times)} (median after the first "
          f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tokens/s); peak "
          f"above the train state for one forward and backward: plain "
          f"{peak_plain} bytes ({peak_plain / 1e9:.3f} GB), remat "
          f"{peak_remat} ({peak_remat / 1e9:.3f} GB); remat gradients "
          f"torch.equal to the plain ones; checkpoint of step 8 saved in "
          f"{t_save:.2f} s, auto_resume in {t_load:.2f} s, the resumed step "
          f"torch.equal to the uninterrupted one (deterministic algorithms "
          f"on); on {card}")
    del resumed, fresh, ref
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        first, t1 = _train_cli(out)
        metrics = Path(out, "metrics.jsonl").read_text().splitlines()
        steps = [json.loads(ln)["step"] for ln in metrics]
        if "no ckpt found" not in first or "step 4/4" not in first or (
                steps != [4]):
            fail(f"teacher forcing: tools/train.py first run: {first[-800:]}"
                 f" metrics steps {steps}")
        second, t2 = _train_cli(out)
        again = Path(out, "metrics.jsonl").read_text().splitlines()
        if ("resume from step 4" not in second or "step 4/4" in second
                or again != metrics):
            fail(f"teacher forcing: tools/train.py second run: "
                 f"{second[-800:]}")
        ckpts = sorted(os.listdir(Path(out, "ckpt")))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(f"teacher forcing: (d) python -m fpqvar_tpu_torch.tools.train "
          f"--depth 16 --steps 4 --save-every 2: first run {t1:.1f} s "
          f"(checkpoints {ckpts}, metrics.jsonl {metrics[0]}), second run "
          f"{t2:.1f} s resumed at step 4 and added nothing; on {card}")


def phase_teacher(card: str):
    """Phase 12, the teacher-forcing and training path at VAR-d16 (width
    1024, 16 heads, depth 16, L = 680, the d16 VQVAE; random seeded
    weights, no cut): K1-K5 at the forward's M = 5440, (a) the forward
    under four recipes with their exact launches and stepwise vs masked,
    (b) card vs CPU at width 256, (c) the encoder and tokenizer, (d)
    training on the encoder's tokens, checkpoint, resume and the CLI.
    Returns the forward's launch totals and the kernel rows."""
    from fpqvar_tpu_torch.config import var_d16

    cfg = var_d16()
    rows = phase_teacher_kernels()
    launches = _teacher_forward(cfg, card)
    _stepwise_vs_masked(cfg, card)
    _teacher_small_reference(card)
    data = _teacher_encoder(cfg, card)
    _teacher_training(cfg, data, card)
    return launches, rows


# ---------------------------------------------------------------------------
# Phase 13: the offline pipeline
# ---------------------------------------------------------------------------

#: port tree key -> upstream key suffix of each block's leaves (VAR-d16 has
#: per-block ``ada_lin``)
VAR_BLOCK_KEYS = {"mat_qkv_w": "attn.mat_qkv.weight", "q_bias": "attn.q_bias",
                  "v_bias": "attn.v_bias",
                  "scale_mul": "attn.scale_mul_1H11",
                  "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
                  "fc1_w": "ffn.fc1.weight", "fc1_b": "ffn.fc1.bias",
                  "fc2_w": "ffn.fc2.weight", "fc2_b": "ffn.fc2.bias"}


def _var_upstream(p, cfg) -> dict:
    """A port VAR tree (per-block ``ada_lin``) under the upstream torch
    keys, as CPU tensors."""
    sd = {"word_embed.weight": p["word_embed"]["w"],
          "word_embed.bias": p["word_embed"]["b"],
          "class_emb.weight": p["class_emb"], "pos_start": p["pos_start"],
          "pos_1LC": p["pos_1LC"], "lvl_embed.weight": p["lvl_embed"],
          "head_nm.ada_lin.1.weight": p["head_nm"]["w"],
          "head_nm.ada_lin.1.bias": p["head_nm"]["b"],
          "head.weight": p["head"]["w"], "head.bias": p["head"]["b"]}
    blocks = p["blocks"]
    for i in range(cfg.depth):
        for key, name in VAR_BLOCK_KEYS.items():
            sd[f"blocks.{i}.{name}"] = blocks[key][i]
        sd[f"blocks.{i}.ada_lin.1.weight"] = blocks["ada_lin"]["w"][i]
        sd[f"blocks.{i}.ada_lin.1.bias"] = blocks["ada_lin"]["b"][i]
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def _flat_dots(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat_dots(v, f"{prefix}{k}."))
    return out


def _vqvae_upstream(vae) -> dict:
    """A port VQVAE tree under the upstream torch keys (phi as the
    partially shared ``quant_resi.qresi_ls``), as CPU tensors."""
    sd = {}
    for k, v in _flat_dots(vae).items():
        k = re.sub(r"\.w$", ".weight", re.sub(r"\.b$", ".bias", k))
        k = re.sub(r"(downsample|upsample)\.", r"\1.conv.", k)
        k = k.replace("quantize.phi.", "quantize.quant_resi.qresi_ls.")
        if k == "quantize.embedding":
            k += ".weight"
        sd[k] = v.detach().cpu().clone()
    return sd


def _same_leaves(a, b, where="") -> int:
    """Fail unless two port trees hold the same structure, leaf types,
    dtypes and bits; returns the number of bfloat16 tensors."""
    from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor

    if type(a) is not type(b):
        fail(f"offline: {where}: {type(a).__name__} against "
             f"{type(b).__name__}")
    if isinstance(a, dict):
        if a.keys() != b.keys():
            fail(f"offline: {where}: keys {sorted(a)} against {sorted(b)}")
        return sum(_same_leaves(a[k], b[k], f"{where}/{k}") for k in a)
    if isinstance(a, list):
        if len(a) != len(b):
            fail(f"offline: {where}: {len(a)} items against {len(b)}")
        return sum(_same_leaves(x, y, f"{where}/{i}")
                   for i, (x, y) in enumerate(zip(a, b)))
    if isinstance(a, (IntPack, PackedTensor)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                _same_leaves(x, y, f"{where}.{f.name}")
            elif x != y:
                fail(f"offline: {where}.{f.name}: {x} against {y}")
        return 0
    if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b):
        fail(f"offline: {where}: {a.dtype} {a.device} against {b.dtype} "
             f"{b.device}, or other values")
    return int(a.dtype == torch.bfloat16)


def _eager_images(cfg, q, params, vae, labels, seed: int):
    from fpqvar_tpu_torch.config import GenerateConfig
    from fpqvar_tpu_torch.models import VARGenerator

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    imgs = VARGenerator(cfg, q, GenerateConfig(), device="cuda",
                        fuse_steps=False).generate(params, vae, labels, gen)
    torch.cuda.synchronize()
    return imgs


def _offline_checkpoint_in(cfg, tmp: str, card: str):
    """(a) Seeded d16 VAR and VQVAE trees under the upstream keys,
    ``torch.save``d, read back with ``load_torch_state_dict`` and the two
    converters: the key set must be ``expected_var_keys``, the converted
    trees equal to the source trees leaf for leaf, and a ``bf16`` batch-8
    generation from them ``torch.equal`` to one from the source trees
    (same generator seed).  Returns the converted (VAR, VQVAE) trees."""
    from fpqvar_tpu_torch.models import init_var_params, init_vqvae_params
    from fpqvar_tpu_torch.utils import checkpoint as C

    src_var = init_var_params(cfg, seed=0, device="cuda",
                              adaln_gamma_std=0.02)
    src_vae = init_vqvae_params(cfg.vae, seed=1, device="cuda")
    var_sd, vae_sd = _var_upstream(src_var, cfg), _vqvae_upstream(src_vae)
    if set(var_sd) != set(C.expected_var_keys(cfg)):
        fail("offline: the upstream VAR keys differ from expected_var_keys")
    paths = {"var": os.path.join(tmp, "var_d16.pth"),
             "vae": os.path.join(tmp, "vae_d16.pth")}
    t0 = time.perf_counter()
    torch.save(var_sd, paths["var"])
    torch.save({"state_dict": vae_sd}, paths["vae"])
    t_save = time.perf_counter() - t0
    del var_sd, vae_sd
    t0 = time.perf_counter()
    var_p = C.convert_var_state_dict(C.load_torch_state_dict(paths["var"]),
                                     cfg, "cuda")
    vae_p = C.convert_vqvae_state_dict(
        C.load_torch_state_dict(paths["vae"]), cfg.vae, "cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    _same_leaves(var_p, src_var, "converted VAR")
    _same_leaves(vae_p, src_vae, "converted VQVAE")
    q = _recipes()["bf16"]
    labels = torch.arange(8, device="cuda") * 37
    ours = _eager_images(cfg, q, var_p, vae_p, labels, seed=7)
    theirs = _eager_images(cfg, q, src_var, src_vae, labels, seed=7)
    if not torch.equal(ours, theirs):
        fail("offline: the converted trees generate other images")
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    print(f"offline: (a) checkpoint in, depth {cfg.depth}: torch.save of the upstream VAR "
          f"({sizes['var']} bytes) and VQVAE ({sizes['vae']} bytes) state "
          f"dicts {t_save:.2f} s; load_torch_state_dict + convert to cuda "
          f"{t_load:.2f} s; {len(C.expected_var_keys(cfg))} keys = "
          f"expected_var_keys; trees equal leaf for leaf; bf16 batch-8 "
          f"images torch.equal to the source trees'; on {card}")
    del src_var, src_vae
    return var_p, vae_p


def _offline_calibration(cfg, var_p, vae_p, tmp: str, card: str):
    """(b) ``capture_generation`` for 1 label (2 CFG rows) through the 10
    scales, written with ``CalibrationStore.append_run`` (16 blocks x 10
    steps x 4 kinds = 640 npz files), and ``capture_condition`` for 100
    labels.  Returns the store and the condition."""
    from fpqvar_tpu_torch.quantize.calibration import (
        LAYER_KINDS, CalibrationStore, capture_condition, capture_generation)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    capture_generation(var_p, vae_p, cfg, [0], gen)    # warm-up
    t0 = time.perf_counter()
    taps = capture_generation(var_p, vae_p, cfg, [1], gen)
    t_cap = time.perf_counter() - t0
    raw = sum(a.nbytes for step in taps for a in step.values())
    for si, (step, pn) in enumerate(zip(taps, cfg.patch_nums)):
        for kind, a in step.items():
            wide = 4 if kind == "fc2" else 1
            want = (cfg.depth, 2, pn * pn, wide * cfg.width)
            if a.shape != want or a.dtype != np.float32 or not np.isfinite(
                    a).all():
                fail(f"offline: capture {kind} step {si}: {a.shape} "
                     f"{a.dtype}, expected {want} float32 finite")
    store = CalibrationStore(os.path.join(tmp, "calib"))
    t0 = time.perf_counter()
    store.append_run(taps)
    t_write = time.perf_counter() - t0
    files = sorted(os.listdir(store.root))
    disk = sum(os.path.getsize(os.path.join(store.root, f)) for f in files)
    want = len(LAYER_KINDS) * cfg.depth * cfg.num_scales
    if len(files) != want or store.steps("fc1", cfg.depth - 1) != \
            cfg.num_scales:
        fail(f"offline: the store holds {len(files)} files, expected {want}")
    t0 = time.perf_counter()
    cond = capture_condition(var_p, cfg, np.arange(100))
    t_cond = time.perf_counter() - t0
    if cond.shape != (100, cfg.width) or not np.isfinite(cond).all():
        fail(f"offline: capture_condition {cond.shape}")
    print(f"offline: (b) capture_generation, 1 label (2 CFG rows), "
          f"{cfg.num_scales} scales: {t_cap:.2f} s (taps {raw} bytes raw "
          f"float32); CalibrationStore.append_run: {t_write:.2f} s for "
          f"{len(files)} npz files, {disk} bytes compressed; "
          f"capture_condition of 100 labels {t_cond * 1e3:.1f} ms; on {card}")
    return store, cond


def _check_results(label: str, results, depth: int) -> None:
    from fpqvar_tpu_torch.quantize import search as S

    keys = {"block_idx", "weight_format", "activation_format", "loss"}
    if len(results) != depth:
        fail(f"offline: {label}: {len(results)} entries, expected {depth}")
    for blk, r in enumerate(results):
        if (set(r) != keys or r["block_idx"] != blk
                or r["weight_format"] not in S.FP4_SPACE
                or r["activation_format"] not in S.FP4_SPACE
                or not isinstance(r["loss"], float)
                or not (math.isfinite(r["loss"]) and r["loss"] >= 0)):
            fail(f"offline: {label}: entry {r}")


def _offline_search(cfg, var_p, store, cond, tmp: str, card: str):
    """(c) ``search_formats`` for fc1 over the 16 blocks (``max_samples``
    1000, as the JAX CLI) and ``search_ada_formats`` on the 100
    conditions: JAX's JSON schema, a finite loss >= 0, the JSON round
    trip.  Returns the fc1 results."""
    from fpqvar_tpu_torch.quantize import search as S

    t0 = time.perf_counter()
    fc1 = S.search_formats(store, var_p["blocks"]["fc1_w"], "fc1",
                           max_samples=1000, device="cuda")
    t_fc1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    ada = S.search_ada_formats(cond, var_p["blocks"]["ada_lin"]["w"],
                               device="cuda")
    t_ada = time.perf_counter() - t0
    _check_results("search_formats fc1", fc1, cfg.depth)
    _check_results("search_ada_formats", ada, cfg.depth)
    path = os.path.join(tmp, "optimal_quantization_formats_fc1.json")
    S.save_formats_json(path, fc1)
    if S.load_formats_json(path) != fc1:
        fail("offline: the formats JSON does not round-trip")

    def hist(results):
        pairs = [f"{r['weight_format']}/{r['activation_format']}"
                 for r in results]
        return ", ".join(f"{p} x{pairs.count(p)}" for p in sorted(set(pairs)))

    rows = 2 * cfg.L
    print(f"offline: (c) search_formats fc1, {cfg.depth} blocks x 9 pairs on "
          f"{min(rows, 1000)} of {rows} rows: {t_fc1:.2f} s ({hist(fc1)}); "
          f"search_ada_formats, {cfg.depth} blocks on 100 conditions: "
          f"{t_ada:.2f} s ({hist(ada)}); losses finite >= 0; on {card}")
    return fc1


def _offline_galt(cfg, var_p, store, card: str):
    """(d) ``train_galt`` for mat_qkv and fc1, 16 blocks,
    ``OFFLINE_GALT_EPOCHS`` epochs (the JAX CLI's 50 cut to fit the
    script's time limit: every epoch runs the same host-bound steps),
    ``max_samples_per_step`` 256: every block's best loss at most its loss
    at s = 1 (the mean over its steps, read by wrapping
    ``train_galt_block``).  Returns (s_qkv, s_fc1)."""
    from fpqvar_tpu_torch.ops.hadamard import block_hadamard_block
    from fpqvar_tpu_torch.quantize import galt as G
    from fpqvar_tpu_torch.ops.precision import ieee_f32

    block_fn = G.train_galt_block
    q_block = torch.as_tensor(block_hadamard_block(128, 42),
                              dtype=torch.float32, device="cuda")
    seen = []

    def recorded(acts, weight, **kw):
        s, best = block_fn(acts, weight, **kw)
        w = weight.to(torch.float32)
        ones = torch.ones(w.shape[-1], device="cuda")
        with torch.no_grad(), ieee_f32():
            base = 0.0
            for a in acts:
                base += float(G.quant_error(
                    torch.from_numpy(a).cuda(), w, ones, q_block,
                    G.make_quant_ste(4)))
        seen.append((best, base / len(acts), [len(a) for a in acts]))
        return s, best

    out = []
    G.train_galt_block = recorded
    try:
        for kind in ("mat_qkv", "fc1"):
            seen.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = G.train_galt(store, var_p["blocks"][f"{kind}_w"], kind,
                             epochs=OFFLINE_GALT_EPOCHS,
                             max_samples_per_step=256,
                             device="cuda")
            secs = time.perf_counter() - t0
            steps = cfg.depth * OFFLINE_GALT_EPOCHS * cfg.num_scales
            if s.shape != (cfg.depth, cfg.width) or not np.isfinite(s).all():
                fail(f"offline: train_galt {kind}: s {s.shape}")
            worse = [i for i, (best, base, _) in enumerate(seen)
                     if not best <= base]
            if len(seen) != cfg.depth or worse:
                fail(f"offline: train_galt {kind}: blocks {worse} end above "
                     f"their loss at s = 1: {seen}")
            gain = [best / base for best, base, _ in seen]
            print(f"offline: (d) train_galt {kind}, {cfg.depth} blocks x "
                  f"{OFFLINE_GALT_EPOCHS} "
                  f"epochs x {cfg.num_scales} steps (rows a step "
                  f"{seen[0][2]}): {secs:.2f} s, {secs / steps * 1e3:.3f} ms "
                  f"a step; best loss / loss at s = 1 per block "
                  f"{min(gain):.4f}..{max(gain):.4f}; s in "
                  f"[{s.min():.4f}, {s.max():.4f}]; on {card}")
            out.append(s)
    finally:
        G.train_galt_block = block_fn
    return tuple(out)


def _offline_generate(cfg, var_p, vae_p, galt, fc1_results, tmp: str,
                      card: str) -> dict:
    """(e) The tree cast to bf16, ``quantize_var_params`` under ``int8``
    with the GALT vectors of (d), ``save_params`` / ``load_params``: the
    reloaded tree equal leaf for leaf (bf16 leaves bf16), and its batch-8
    ``int8`` generation, with the counts set to 0 just before it and read
    just after, launching exactly K1 320, K5 480 and Q2 640 and giving
    images ``torch.equal`` to the in-memory tree's (same generator seed),
    finite in [0, 1].  Then one ``fake`` generation with the mixed
    activation formats of (c): finite images, exactly Q1 640 and no GEMM.
    Returns the reloaded generation's launch counts."""
    from fpqvar_tpu_torch.quantize import quantize_var_params
    from fpqvar_tpu_torch.quantize import search as S
    from fpqvar_tpu_torch.quantize.recipe import to_bf16
    from fpqvar_tpu_torch.utils import checkpoint as C

    q = _recipes()["int8"]
    bf16 = to_bf16(var_p)
    t0 = time.perf_counter()
    qp = quantize_var_params(bf16, cfg, q, galt=galt)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    path = os.path.join(tmp, "var_d16_int8.npz")
    t0 = time.perf_counter()
    C.save_params(path, qp)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = C.load_params(path, "cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    n_bf16 = _same_leaves(back, qp, "reloaded int8 tree")
    if n_bf16 == 0:
        fail("offline: the int8 tree holds no bf16 leaf")
    labels = torch.arange(8, device="cuda") * 101
    _eager_images(cfg, q, back, vae_p, labels, seed=9)     # warm-up
    reset_counts()
    imgs = _eager_images(cfg, q, back, vae_p, labels, seed=9)
    counts = read_counts()
    blocks = cfg.depth * cfg.num_scales
    want = {k: 0 for k in COUNTERS}
    want.update(K1=blocks * 2, K5=blocks * 3, Q2=blocks * 4)
    if counts != want:
        fail(f"offline: reloaded int8 generation launches {counts}, "
             f"expected {want}")
    ref = _eager_images(cfg, q, qp, vae_p, labels, seed=9)
    if tuple(imgs.shape) != (8, 3, 256, 256) or not torch.equal(imgs, ref):
        fail("offline: the reloaded tree generates other images than the "
             "in-memory tree")
    if not bool(torch.isfinite(imgs).all()) or not (
            float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0):
        fail("offline: reloaded int8 images not finite in [0, 1]")
    mixed = S.formats_to_mixed_config(fc1_results)
    qf = _recipes()["fake"].replace(mixed_act_formats=mixed)
    fp = quantize_var_params(bf16, cfg, qf, galt=galt)
    reset_counts()
    fimgs = _eager_images(cfg, qf, fp, vae_p, labels, seed=9)
    fcounts = read_counts()
    fwant = {**{k: 0 for k in COUNTERS}, "Q1": blocks * 4}
    if fcounts != fwant or not bool(torch.isfinite(fimgs).all()):
        fail(f"offline: mixed-format fake generation: launches {fcounts}, "
             f"expected {fwant}, "
             f"finite {bool(torch.isfinite(fimgs).all())}")
    print(f"offline: (e) bf16 cast + quantize_var_params int8 with the GALT "
          f"vectors {t_quant:.2f} s; save_params {os.path.getsize(path)} "
          f"bytes in {t_save:.2f} s, load_params to cuda {t_load:.2f} s "
          f"(tree equal leaf for leaf, {n_bf16} bf16 leaves bf16); reloaded "
          f"int8 batch-8 generation: launches "
          + ", ".join(f"{k} {n}" for k, n in counts.items() if n)
          + f", images torch.equal to the in-memory tree's, finite in "
          f"[0, 1]; fake with mixed activation formats {mixed}: images "
          f"finite, Q1 {fcounts['Q1']} launches (exact), no GEMM; on "
          f"{card}")
    return counts


def _offline_small_reference(card: str) -> None:
    """(f) Width 256 (phase 4's model), card against CPU:
    ``capture_generation`` at top_k=1 (the same tokens at every scale,
    taps within 1e-4); ``_pair_loss`` of the nine fp4 pairs on block 0's
    fc1 taps within a relative 1e-4, and the same chosen pair unless the
    CPU's two best lie closer than that; two epochs of ``train_galt_block``
    on that block, ``s`` and the best loss within the larger of 1e-4 and
    twice the CPU's own response to a one-ulp change of the activations
    (up or down), printed beside."""
    from fpqvar_tpu_torch.config import GenerateConfig, var_tiny
    from fpqvar_tpu_torch.models import init_var_params, init_vqvae_params
    from fpqvar_tpu_torch.quantize import calibration as CAL
    from fpqvar_tpu_torch.quantize import galt as G
    from fpqvar_tpu_torch.quantize import search as S

    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    params = init_var_params(cfg, seed=4, device="cpu", adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=5, device="cpu")
    sample = CAL.sample_with_top_k_top_p
    out = {}
    for dev in ("cpu", "cuda"):
        tokens = []

        def recorded(logits, *args, **kw):
            idx = sample(logits, *args, **kw)
            tokens.append(idx.cpu())
            return idx

        CAL.sample_with_top_k_top_p = recorded
        try:
            taps = CAL.capture_generation(
                _to(params, dev), _to(vae, dev), cfg, [3, 5, 7],
                torch.Generator(device=dev).manual_seed(1),
                GenerateConfig(top_k=1, top_p=0.0))
        finally:
            CAL.sample_with_top_k_top_p = sample
        out[dev] = (taps, tokens)
    (taps, tok), (ctaps, ctok) = out["cpu"], out["cuda"]
    if len(tok) != cfg.num_scales or not all(
            torch.equal(a, b) for a, b in zip(tok, ctok)):
        fail("offline: width-256 capture: card and CPU sampled other tokens")
    terr = max(float(np.abs(a[k] - b[k]).max())
               for a, b in zip(taps, ctaps) for k in a)
    if not terr <= 1e-4:
        fail(f"offline: width-256 capture taps differ by {terr} (tol 1e-4)")

    acts = [t["fc1"][0].reshape(-1, cfg.width) for t in taps]
    w = params["blocks"]["fc1_w"][0]
    x = np.concatenate(acts)
    losses = {}
    for wn, wf in S.FP4_SPACE.items():
        for an, af in S.FP4_SPACE.items():
            cpu = S._pair_loss(torch.from_numpy(x), w, wf, af, 128)
            card_l = S._pair_loss(torch.from_numpy(x).cuda(), w.cuda(), wf,
                                  af, 128)
            losses[(wn, an)] = (cpu, card_l)
    lerr = max(abs(c - g) / c for c, g in losses.values())
    if not lerr <= 1e-4:
        fail(f"offline: width-256 _pair_loss card vs CPU rel err {lerr}")
    order = sorted(losses, key=lambda k: losses[k][0])
    best_cpu = order[0]
    best_card = min(losses, key=lambda k: losses[k][1])
    near = (losses[order[1]][0] - losses[order[0]][0]) <= \
        1e-4 * losses[order[0]][0]
    if best_card != best_cpu and not near:
        fail(f"offline: width-256 search: card picks {best_card}, CPU "
             f"{best_cpu}")

    up, down = np.float32(1 + 2.0 ** -23), np.float32(1 - 2.0 ** -24)
    s_cpu, l_cpu = G.train_galt_block(acts, w, epochs=2, device="cpu")
    s_card, l_card = G.train_galt_block(acts, w, epochs=2, device="cuda")
    ulp = [G.train_galt_block([a * f for a in acts], w, epochs=2,
                              device="cpu") for f in (up, down)]
    s_ulp = max(float(np.abs(s - s_cpu).max()) for s, _ in ulp)
    l_ulp = max(abs(l - l_cpu) / l_cpu for _, l in ulp)
    s_err = float(np.abs(s_card - s_cpu).max())
    l_err = abs(l_card - l_cpu) / l_cpu
    s_tol, l_tol = max(1e-4, 2 * s_ulp), max(1e-4, 2 * l_ulp)
    if not (s_err <= s_tol and l_err <= l_tol):
        fail(f"offline: width-256 train_galt_block card vs CPU: s max err "
             f"{s_err} (tol {s_tol}), best loss rel err {l_err} (tol "
             f"{l_tol})")
    print(f"offline: (f) width-256 card vs CPU: capture tokens identical at "
          f"all {cfg.num_scales} scales, taps max err {terr:.3e} (tol 1e-4); "
          f"_pair_loss of 9 fp4 pairs rel err {lerr:.3e} (tol 1e-4), chosen "
          f"{best_card} (CPU {best_cpu}); train_galt_block 2 epochs: s max "
          f"err {s_err:.3e} (tol {s_tol:.3e}; the CPU's s moves "
          f"{s_ulp:.3e} when the activations move by one ulp), best loss "
          f"rel err {l_err:.3e} (tol {l_tol:.3e}; one ulp {l_ulp:.3e}); "
          f"on {card}")


def phase_offline(card: str) -> dict:
    """Phase 13, the offline pipeline at VAR-d16 full width and depth
    (width 1024, 16 heads, depth 16, L = 680; random seeded weights) in a
    temporary directory removed at its end: (a) checkpoint in, (b)
    calibration capture and store, (c) format search, (d) GALT training,
    (e) transform, persist, reload and generate, (f) card against CPU at
    width 256.  Returns the reloaded generation's launch counts."""
    from fpqvar_tpu_torch.config import var_d16

    cfg = var_d16()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    stages = {}

    def stage(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        stages[name] = time.perf_counter() - t0
        return res

    try:
        var_p, vae_p = stage("(a)", _offline_checkpoint_in, cfg, tmp, card)
        store, cond = stage("(b)", _offline_calibration, cfg, var_p, vae_p,
                            tmp, card)
        fc1 = stage("(c)", _offline_search, cfg, var_p, store, cond, tmp,
                    card)
        galt = stage("(d)", _offline_galt, cfg, var_p, store, card)
        counts = stage("(e)", _offline_generate, cfg, var_p, vae_p, galt,
                       fc1, tmp, card)
        del var_p, vae_p
        torch.cuda.empty_cache()
        stage("(f)", _offline_small_reference, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("offline: stage seconds " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()) + f" on {card}")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: evaluation
# ---------------------------------------------------------------------------

#: the evaluate CLI's W4A4 flags (its docstring's recipe) on the int8
#: backend at VAR-d16
EVAL_FLAGS = ["--depth", "16", "--quant", "--w_bit", "4", "--a_bit", "4",
              "--weight_quant", "per_group", "--act_quant", "per_group",
              "--activation_fp_quant", "--weight_fp_quant", "--act_fp_type",
              "fp_e2", "--weight_fp_type", "fp_e2", "--fc2_fp_type",
              "fp_e1m2_neg_e2m1_pos", "--rotate", "--block_rotate",
              "--transform"]
#: the top-level keys of the JAX ladder's JSON (scripts/quality_ladder.py)
LADDER_KEYS = ["config", "outlier_hot_cold_ratio_after_training", "note",
               "fid_noise_floor_same_set_split",
               "fid_generation_floor_bf16_cross",
               "fid_noise_control_uniform_images", "results", "wall_s"]
#: card against CPU Inception features (tests/test_torch_cuda.py): ~94
#: layers of up to 2048 * 9 float32 products each, sqrt(K) u ~ 8e-6 a
#: layer compounding to ~1e-4 of the largest feature; probs within 1e-5
INCEPTION_REL, PROBS_ATOL = 1e-4, 1e-5
#: bounds on the batch-50 evaluate class's peak allocation and graph pool:
#: 1.5x the 11.98 / 21.13 GB of the plain-route decode (PERF.md, PR 14);
#: cuDNN's workspace in the decode took them to 39.63 / 50.35 GB
EVAL_B50_PEAK_GB, EVAL_B50_POOL_GB = 18, 32
U32 = 2.0 ** -24


def _cli(module: str, args, what: str) -> str:
    cmd = [sys.executable, "-m", f"fpqvar_tpu_torch.tools.{module}", *args]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         cwd=Path(__file__).resolve().parent)
    if res.returncode != 0:
        fail(f"evaluation: {what}: {module} exited {res.returncode}: "
             f"{res.stderr[-3000:]}")
    return res.stdout


def _png_bytes(folder: str) -> dict:
    return {n: Path(folder, n).read_bytes() for n in sorted(os.listdir(folder))
            if n.endswith(".png")}


def _eval_trees(tmp: str, backend: str):
    """The evaluate CLI's configs and trees for EVAL_FLAGS on ``backend``
    (its own functions), with GALT vectors of ones in ``tmp/best_s`` in
    the reference's ``.pt`` format."""
    from fpqvar_tpu_torch.tools import evaluate

    best = os.path.join(tmp, "best_s")
    if not os.path.isdir(best):
        os.makedirs(best)
        for kind in ("mat_qkv", "fc1"):
            torch.save([torch.ones(1024) for _ in range(16)],
                       os.path.join(best, f"{kind}_best_s_fp4.pt"))
    flags = EVAL_FLAGS + ["--backend", backend, "--best-s-dir", best,
                         "--out", os.path.join(tmp, "unused")]
    args = evaluate.parse_args(flags)
    cfg, qcfg, gen = evaluate.build_configs(args)
    var_p, vae_p = evaluate.load_trees(args, cfg, qcfg)
    return flags[:-2], cfg, qcfg, gen, var_p, vae_p


def _eval_eager_set(tmp: str, card: str):
    """(a) The eager int8 eval set: classes 0 and 1, 8 images each at
    batch 8, with the counts set to 0 just before and read just after: K1
    640 + K5 960 + Q2 1,280; 16 PNGs and their npz; resume runs nothing, and a
    deleted PNG of class 1 runs exactly one more generation that rewrites
    it byte for byte."""
    from fpqvar_tpu_torch.eval.imaging import create_npz_from_sample_folder
    from fpqvar_tpu_torch.eval.pipeline import generate_eval_set
    from fpqvar_tpu_torch.models import VARGenerator

    flags, cfg, qcfg, gen_cfg, var_p, vae_p = _eval_trees(tmp, "int8")
    out = os.path.join(tmp, "eager")
    gen = VARGenerator(cfg, qcfg, gen_cfg, fuse_steps=False)
    blocks = cfg.depth * cfg.num_scales
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    runs = generate_eval_set(gen, var_p, vae_p, out, num_img_per_class=8,
                             classes=range(2), batch=8)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    want = {k: 0 for k in COUNTERS}
    want.update(K1=2 * 2 * blocks, K5=2 * 3 * blocks, Q2=2 * 4 * blocks)
    if runs != 2 or counts != want:
        fail(f"evaluation: (a) eager int8 eval set: {runs} generations, "
             f"launches {counts}, expected 2 and {want}")
    pngs = _png_bytes(out)
    if sorted(pngs) != sorted(f"class{c}_img{j}.png" for c in range(2)
                              for j in range(8)):
        fail(f"evaluation: (a) PNGs {sorted(pngs)}")
    npz = create_npz_from_sample_folder(out, expected=16)
    with np.load(npz) as d:
        arr = d["arr_0"]
    if arr.shape != (16, 256, 256, 3) or arr.dtype != np.uint8:
        fail(f"evaluation: (a) npz {arr.shape} {arr.dtype}")
    os.remove(npz)
    reset_counts()
    again = generate_eval_set(gen, var_p, vae_p, out, 8, range(2), batch=8)
    if again != 0 or any(read_counts().values()):
        fail(f"evaluation: (a) resume of a complete set ran {again} "
             f"generations, launches {read_counts()}")
    victim = os.path.join(out, "class1_img5.png")
    os.remove(victim)
    reset_counts()
    again = generate_eval_set(gen, var_p, vae_p, out, 8, range(2), batch=8)
    torch.cuda.synchronize()
    redo = read_counts()
    if (again != 1 or redo != {**want, "K1": 2 * blocks, "K5": 3 * blocks,
                               "Q2": 4 * blocks}
            or Path(victim).read_bytes() != pngs["class1_img5.png"]):
        fail(f"evaluation: (a) resume after deleting a PNG ran {again} "
             f"generations, launches {redo}; rewritten PNG equal "
             f"{Path(victim).read_bytes() == pngs['class1_img5.png']}")
    print(f"evaluation: (a) eager int8 eval set, VAR-d16, classes 0-1 x 8 "
          f"images at batch 8: {secs:.2f} s ({secs * 1e3 / 16:.1f} ms an "
          f"image, PNG writing included); launches K1 {counts['K1']} + K5 "
          f"{counts['K5']} + Q2 {counts['Q2']} (exact); 16 PNGs, npz "
          f"[16, 256, 256, 3] uint8; "
          f"resume ran nothing, and after a PNG of class 1 was deleted "
          f"exactly one generation (K1 {redo['K1']} + K5 {redo['K5']}) "
          f"rewrote it byte for byte; on {card}")
    del gen, var_p
    torch.cuda.empty_cache()
    return counts, flags, out, arr


def _eval_cli_and_packed(tmp: str, flags, eager_out: str, card: str):
    """(b) The evaluate CLI, fused, in a subprocess on (a)'s trees: its
    PNGs byte-equal to (a)'s; one class at the protocol's default (50
    images at batch 50) with ms an image, peak memory and the graph pool's
    bytes, each within its bound; then an eager packed generator for one
    class of 8 with the counts set to 0 just before and read just after:
    K2 640 and Q1 640."""
    from fpqvar_tpu_torch.eval.pipeline import generate_eval_set
    from fpqvar_tpu_torch.models import VARGenerator

    torch.cuda.empty_cache()
    fused_out = os.path.join(tmp, "fused")
    t0 = time.perf_counter()
    out = _cli("evaluate", flags + ["--backend", "int8", "--out", fused_out,
                                    "--classes", "0:2",
                                    "--num-img-per-class", "8",
                                    "--batch", "8"], "fused eval set")
    secs = time.perf_counter() - t0
    if _png_bytes(fused_out) != _png_bytes(eager_out):
        fail("evaluation: (b) the fused CLI's PNGs differ from the eager "
             "eval set's")
    line8 = json.loads(out.split("evaluate: ", 1)[1].splitlines()[0])
    print(f"evaluation: (b) evaluate CLI (fused, subprocess, {secs:.1f} s "
          f"with the process start and the d16 quantize): 16 PNGs "
          f"byte-equal to (a)'s; {json.dumps(line8)}; on {card}")
    big = os.path.join(tmp, "batch50")
    t0 = time.perf_counter()
    out = _cli("evaluate", flags + ["--backend", "int8", "--out", big,
                                    "--classes", "0:1"], "batch-50 class")
    secs = time.perf_counter() - t0
    line = json.loads(out.split("evaluate: ", 1)[1].splitlines()[0])
    if len(_png_bytes(big)) != 50:
        fail(f"evaluation: (b) batch-50 class wrote {len(_png_bytes(big))} "
             "PNGs")
    steady = (line["seconds"] - line["warmup_s"] - line["capture_s"]) / 50
    if (line["peak_bytes"] > EVAL_B50_PEAK_GB * 1e9
            or line["pool_bytes"] > EVAL_B50_POOL_GB * 1e9):
        fail(f"evaluation: (b) batch-50 class: peak allocated "
             f"{line['peak_bytes']} bytes, graph pool {line['pool_bytes']} "
             f"bytes, above the bounds of {EVAL_B50_PEAK_GB} / "
             f"{EVAL_B50_POOL_GB} GB (cuDNN workspace back in the decode?)")
    print(f"evaluation: (b) evaluate CLI at the protocol's default (one "
          f"class, 50 images, batch 50, fused int8): {secs:.1f} s in all; "
          f"{line['seconds']:.2f} s generating ({line['ms_per_image']:.1f} ms "
          f"an image with the warm-up and capture; {steady * 1e3:.1f} ms an "
          f"image without them), warm-up {line['warmup_s']:.2f} s, capture "
          f"{line['capture_s']:.2f} s, peak allocated {line['peak_bytes']} "
          f"bytes ({line['peak_bytes'] / 1e9:.2f} GB), graph pool "
          f"{line['pool_bytes']} bytes ({line['pool_bytes'] / 1e9:.2f} GB; "
          f"bounds {EVAL_B50_PEAK_GB} / {EVAL_B50_POOL_GB} GB) of the "
          f"card's {torch.cuda.get_device_properties(0).total_memory} "
          f"bytes; on {card}")
    pflags, cfg, qcfg, gen_cfg, var_p, vae_p = _eval_trees(tmp, "packed")
    gen = VARGenerator(cfg, qcfg, gen_cfg, fuse_steps=False)
    torch.cuda.synchronize()
    reset_counts()
    runs = generate_eval_set(gen, var_p, vae_p, os.path.join(tmp, "packed"),
                             8, range(1), batch=8)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 0 for k in COUNTERS}
    want["K2"] = want["Q1"] = 4 * cfg.depth * cfg.num_scales
    if runs != 1 or counts != want:
        fail(f"evaluation: (b) eager packed eval set: {runs} generations, "
             f"launches {counts}, expected 1 and {want}")
    print(f"evaluation: (b) eager packed eval set, one class of 8: launches "
          f"K2 {counts['K2']} + Q1 {counts['Q1']} (exact); on {card}")
    del gen, var_p, vae_p
    torch.cuda.empty_cache()
    return counts, line


def _eval_inception(tmp: str, eager_out: str, arr, card: str):
    """(c) Inception on the card against the CPU (4 of (a)'s images, 256 ->
    299, and 2 random 512 px images), features a second at batch 64 (256
    distinct images: (a)'s shifted by 0..15 columns), the
    score CLI's saved features ``torch.equal`` to the in-process ones (a
    fresh process keeps TF32 off), and ``evaluate_all`` of 256 features
    against themselves (precision = recall = 1) and against uniform
    noise (a larger FID)."""
    from fpqvar_tpu_torch.eval import inception as I
    from fpqvar_tpu_torch.eval.metrics import evaluate_all

    card_p = I.init_inception_params(0, "cuda")
    cpu_p = I.init_inception_params(0, "cpu")
    imgs = torch.from_numpy(arr[:4].transpose(0, 3, 1, 2).copy())
    rng = np.random.default_rng(14)
    big = torch.from_numpy(rng.uniform(size=(2, 3, 512, 512))
                           .astype(np.float32))
    worst = {}
    for hw, x in ((256, imgs.float() / 255.0), (512, big)):
        cpu = I.inception_features(cpu_p, x)
        got = I.inception_features(card_p, x.cuda())
        for name, c, g in zip(("pool3", "spatial", "probs"), cpu, got):
            err = float((g.cpu() - c).abs().max())
            tol = (PROBS_ATOL if name == "probs"
                   else INCEPTION_REL * float(c.abs().max()))
            if not err <= tol:
                fail(f"evaluation: (c) Inception {name} at {hw} px: card "
                     f"vs CPU {err} > {tol}")
            worst[f"{name}@{hw}"] = (err, tol)
    del cpu_p
    # 256 distinct images: (a)'s 16, each shifted by 0..15 columns
    nhwc = np.concatenate([np.roll(arr, r, axis=2) for r in range(16)])
    nchw = nhwc.transpose(0, 3, 1, 2)
    I.extract_features_batched(card_p, nchw[:64])          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = I.extract_features_batched(card_p, nchw, batch=64)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"evaluation: (c) Inception card vs CPU (max err / bound): "
          + ", ".join(f"{k} {e:.3g} / {t:.3g}" for k, (e, t) in worst.items())
          + f"; features of 256 images (256 -> 299 px) at batch 64 in "
          f"{secs:.3f} s = {256 / secs:.1f} images/s, so 50k features take "
          f"{50000 / (256 / secs):.0f} s; on {card}")
    ref_npz = os.path.join(tmp, "ref.npz")
    np.savez(ref_npz, arr_0=arr[::-1].copy())
    saved = os.path.join(tmp, "sample_features.npz")
    t0 = time.perf_counter()
    _cli("score", [ref_npz, eager_out, "--inception", "random",
                   "--save-features", saved, "--json-out",
                   os.path.join(tmp, "score.json")], "score")
    secs = time.perf_counter() - t0
    want = I.extract_features_batched(card_p, arr.transpose(0, 3, 1, 2))
    with np.load(saved) as d:
        for k, w in zip(("features", "spatial", "probs"), want):
            if not torch.equal(torch.from_numpy(d[k]), torch.from_numpy(w)):
                fail(f"evaluation: (c) the score CLI's {k} differ from the "
                     "in-process features")
    with open(os.path.join(tmp, "score.json")) as f:
        scores = json.load(f)
    print(f"evaluation: (c) score CLI (subprocess, --inception random, "
          f"{secs:.1f} s): saved features, spatial and probs torch.equal to "
          f"the in-process ones; {json.dumps(scores)}; on {card}")
    t0 = time.perf_counter()
    same = evaluate_all(feats[0], feats[0], sample_probs=feats[2])
    t_same = time.perf_counter() - t0
    if same["precision"] != 1.0 or same["recall"] != 1.0:
        fail(f"evaluation: (c) features against themselves: {same}")
    noise = rng.uniform(size=(256, 3, 256, 256)).astype(np.float32)
    nf = I.extract_features_batched(card_p, noise, batch=64)
    far = evaluate_all(feats[0], nf[0])
    if not far["fid"] > same["fid"]:
        fail(f"evaluation: (c) FID against noise {far['fid']} not above the "
             f"self FID {same['fid']}")
    print(f"evaluation: (c) evaluate_all of 256 features against themselves "
          f"({t_same:.1f} s): {json.dumps(same)}; against 256 uniform-noise "
          f"images: {json.dumps(far)}; on {card}")


def _eval_manifold(card: str):
    """(d) The manifold estimator on 10,000 x 2,048 random float32 features
    on the card (seconds printed); on a 500-row subset, precision and
    recall against a float64 numpy evaluation within the pairs that lie
    within a float32 bound of a radius."""
    from fpqvar_tpu_torch.eval.metrics import ManifoldEstimator

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    ref = torch.randn((10000, 2048), generator=gen, device="cuda")
    sam = torch.randn((10000, 2048), generator=gen, device="cuda") * 1.05
    est = ManifoldEstimator()
    est.manifold_radii(ref[:1000])                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_ref, r_sam = est.manifold_radii(ref), est.manifold_radii(sam)
    prec, rec = est.evaluate_pr(ref, r_ref, sam, r_sam)
    secs = time.perf_counter() - t0
    a, b = ref[:500].double().cpu().numpy(), sam[:500].double().cpu().numpy()
    sr, ss = est.manifold_radii(ref[:500]), est.manifold_radii(sam[:500])
    p32, r32 = est.evaluate_pr(ref[:500], sr, sam[:500], ss)

    def d2(x, y):       # float64: exact enough to decide the float32 ties
        return ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
                - 2.0 * x @ y.T)

    dab = d2(a, b)
    rad_a = np.partition(d2(a, a), 3, axis=1)[:, 3]
    rad_b = np.partition(d2(b, b), 3, axis=1)[:, 3]
    p64 = float((dab <= rad_a[:, None]).any(0).mean())
    r64 = float((dab <= rad_b[None, :]).any(1).mean())
    na, nb = np.linalg.norm(a, axis=1), np.linalg.norm(b, axis=1)
    # the float32 error of |a|^2 + |b|^2 - 2ab over D = 2048 terms, D u
    # (|a| + |b|)^2, for the pair and for the radius's own pair
    top = max(na.max(), nb.max())
    bound = 2048 * U32 * ((na[:, None] + nb[None, :]) ** 2 + 4 * top ** 2)
    tie_p = int((np.abs(dab - rad_a[:, None]) <= bound).any(0).sum())
    tie_r = int((np.abs(dab - rad_b[None, :]) <= bound).any(1).sum())
    if abs(p32 - p64) * 500 > tie_p or abs(r32 - r64) * 500 > tie_r:
        fail(f"evaluation: (d) 500-row precision / recall {p32} / {r32} "
             f"against float64 {p64} / {r64}, near-ties {tie_p} / {tie_r}")
    print(f"evaluation: (d) ManifoldEstimator on 10,000 x 2,048 float32 "
          f"features: radii of both sets and precision / recall in "
          f"{secs:.2f} s (precision {prec:.4f}, recall {rec:.4f}); 500-row "
          f"subset {p32:.4f} / {r32:.4f} against float64 {p64:.4f} / "
          f"{r64:.4f} (near-tie pairs {tie_p} / {tie_r}); on {card}")


def _eval_ladder(tmp: str, card: str):
    """(e) The quality ladder, short: 50 steps, 128 eval images, one GALT
    epoch, three stages: finite FIDs and ISs, JAX's JSON keys."""
    from fpqvar_tpu_torch.tools import quality_ladder

    path = os.path.join(tmp, "ladder.json")
    out = quality_ladder.main(["--steps", "50", "--eval-n", "128",
                               "--galt-epochs", "1", "--stages",
                               "bf16,fp4_full,int4_rtn", "--out", path])
    with open(path) as f:
        doc = json.load(f)
    vals = [v for r in out["results"].values() for v in r.values()]
    if (list(doc) != LADDER_KEYS or list(out["results"]) != [
            "bf16", "fp4_full", "int4_rtn"]
            or not all(math.isfinite(v) for v in vals)):
        fail(f"evaluation: (e) ladder JSON {list(doc)}: {out['results']}")
    print(f"evaluation: (e) quality ladder (50 steps, 128 eval images, 1 "
          f"GALT epoch): {json.dumps(out['results'])}, floors "
          f"{out['fid_noise_floor_same_set_split']} (same-set split), noise "
          f"control {out['fid_noise_control_uniform_images']}; wall "
          f"{out['wall_s']} s; on {card}")


def phase_eval(card: str) -> dict:
    """Phase 14, evaluation at VAR-d16 full width and depth (random seeded
    weights) in a temporary directory removed at its end: (a) the eager
    int8 eval set, (b) the evaluate CLI fused and at batch 50, and an
    eager packed class, (c) Inception and the score CLI, (d) the manifold
    estimator, (e) a short quality ladder.  Returns each kernel's
    launches in (a) (K1, K5) and (b) (K2)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    stages = {}

    def stage(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        stages[name] = time.perf_counter() - t0
        return res

    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"evaluation: {torch.cuda.memory_reserved()} bytes reserved by "
          f"this process before the phase; on {card}")
    try:
        counts, flags, eager_out, arr = stage("(a)", _eval_eager_set, tmp,
                                              card)
        pcounts, _ = stage("(b)", _eval_cli_and_packed, tmp, flags,
                           eager_out, card)
        stage("(c)", _eval_inception, tmp, eager_out, arr, card)
        stage("(d)", _eval_manifold, card)
        stage("(e)", _eval_ladder, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("evaluation: stage seconds " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()) + f" on {card}")
    return {k: counts[k] + pcounts[k] for k in COUNTERS}



#: the recipes of phase 15, each generated under tp 2 and under dp 2
DIST_RECIPES = ("bf16", "int8", "packed", "int8ch", "int8kv")
#: phase 15's batch (one label a dp rank) and its training batch
DIST_BATCH, DIST_TRAIN_BATCH = 2, 8
#: per-rank kernel launches per block forward under a mesh, by recipe and
#: mesh, as JAX routes a mesh (int8_matmul.py:669-676, 706-719): the
#: activation quantized first, then ``int8`` through K1 on all five GEMMs
#: (qkv, proj, fc1, fc2's two halves), ``packed`` K2 on the four linears,
#: the per-channel recipes K3 on the column splits (qkv, fc1) at tp 2,
#: their row splits the plain int32 product, and K3 on all five at dp 2;
#: each activation is quantized once on a rank, by Q1 (``packed``) or Q2
#: (the int8 recipes; ``int8kv`` also encodes k and v into its cache and
#: runs A1 over this rank's heads or rows)
DIST_PER_BLOCK = {("int8", "tp2"): {"K1": 5, "Q2": 4},
                  ("int8", "dp2"): {"K1": 5, "Q2": 4},
                  ("packed", "tp2"): {"K2": 4, "Q1": 4},
                  ("packed", "dp2"): {"K2": 4, "Q1": 4},
                  ("int8ch", "tp2"): {"K3": 2, "Q2": 4},
                  ("int8ch", "dp2"): {"K3": 5, "Q2": 4},
                  ("int8kv", "tp2"): {"K3": 2, "Q2": 6, "A1": 1},
                  ("int8kv", "dp2"): {"K3": 5, "Q2": 6, "A1": 1},
                  ("bf16", "tp2"): {}, ("bf16", "dp2"): {}}
#: phase 15's tp 2 limit on the logits of every scale, relative to the
#: one-device run's largest logit, by recipe: tp 2 changes only the order
#: of float32 sums (the row splits' partials, attention over a rank's
#: heads).  On an H100 the largest change read 2.92e-5 of the largest
#: logit under ``bf16`` (6.58e-5 of 2.256), 1.43e-5 under ``packed`` and
#: 4.4-4.8e-6 under the int8 recipes (PERF.md, section 6); each limit is
#: 4 times its reading, rounded up to a power of two
TP2_LOGIT_REL = {"bf16": 2.0 ** -13, "packed": 2.0 ** -14,
                 "int8": 2.0 ** -15, "int8ch": 2.0 ** -15,
                 "int8kv": 2.0 ** -15}


def _tree_bytes(tree) -> int:
    from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor

    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, (IntPack, PackedTensor)):
            total += leaf.codes.nbytes + leaf.scales.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.nbytes
    return total


def _dist_generate(gen, params, vae, labels, record):
    """One eager generation with per-row generators (seeds 10, 11, ...):
    (images, ms, the sampler's tokens and logits per scale)."""
    record.clear()
    gens = [torch.Generator(device="cuda").manual_seed(10 + i)
            for i in range(len(labels))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kw = {"gather": True} if gen.mesh is not None else {}
    imgs = gen.generate(params, vae, labels, gens, **kw)
    torch.cuda.synchronize()
    return imgs, (time.perf_counter() - t0) * 1e3, list(record)


def _dist_one_device(cfg, q, params, vae, labels, record):
    """Rank 0's one-device reference: the batch, and each label alone with
    its own generator (the rows a dp rank generates)."""
    from fpqvar_tpu_torch.config import GenerateConfig
    from fpqvar_tpu_torch.models import VARGenerator

    gen = VARGenerator(cfg, q, GenerateConfig(), device="cuda",
                       fuse_steps=False)
    imgs, ms, rec = _dist_generate(gen, params, vae, labels, record)
    rows = []
    for i in range(len(labels)):
        record.clear()
        g = [torch.Generator(device="cuda").manual_seed(10 + i)]
        rows.append(gen.generate(params, vae, labels[i:i + 1], g))
    kv = sum(t.nbytes for t in gen.init_cache(len(labels)).values())
    return {"images": imgs, "ms": ms, "rec": rec, "rows": torch.cat(rows),
            "kv": kv}


def _dist_gates(mode, mesh_name, imgs, rec, one) -> str:
    """Rank 0's gates of one mesh generation against the one-device run
    (phase 15's docstring); returns what they read."""
    toks = [t for t, _ in rec]           # rank 0's rows come first
    agree = sum(int((a == b[:a.shape[0]]).sum())
                for a, (b, _) in zip(toks, one["rec"]))
    total = sum(t.numel() for t in toks)
    if agree != total:
        fail(f"distributed {mode} {mesh_name}: {total - agree} of {total} "
             f"tokens differ from the one-device run")
    err = float((imgs - one["images"]).abs().max())
    if mesh_name == "dp2":
        own = float((one["rows"] - one["images"]).abs().max())
        if own == 0.0:
            if not torch.equal(imgs, one["images"]):
                fail(f"distributed {mode} dp2: images differ from the "
                     f"one-device run (max {err}), which is row-invariant")
        elif err > own:
            fail(f"distributed {mode} dp2: images differ by {err}, more than "
                 f"the one-device run's own change between batch sizes, "
                 f"{own}")
        return (f"images vs one device max |d| {err} (one device's own "
                f"change between 4 and 2 rows {own}); tokens "
                f"{agree}/{total} equal")
    # tp 2: every rank holds the whole batch, so its images depend on the
    # (equal) tokens alone; the logits of every scale within the limit
    if not torch.equal(imgs, one["images"]):
        fail(f"distributed {mode} tp2: images differ from the one-device "
             f"run (max {err}) although the tokens are equal")
    top = max(float(b.abs().max()) for _, b in one["rec"])
    per = [float((a - b).abs().max()) for (_, a), (_, b)
           in zip(rec, one["rec"])]
    bound = TP2_LOGIT_REL[mode] * top
    if max(per) > bound:
        fail(f"distributed {mode} tp2: logits differ by {max(per)} at scale "
             f"{per.index(max(per))}, bound {bound}")
    return (f"logits max |d| by scale {per} (largest {max(per) / top:.3g} "
            f"of max|logit| {top}; bound {TP2_LOGIT_REL[mode]:.3g} of it = "
            f"{bound:.3g}); tokens {agree}/{total} equal; images torch.equal")


def _dist_train(cfg, meshes, rank, card):
    """One float32 ``train_step`` of d16 (batch 8, ``remat``) on each mesh
    against rank 0's one-device step and that step's own response to its
    batch rows permuted (the noise floor of summing in another order)."""
    from fpqvar_tpu_torch.models import init_var_params
    from fpqvar_tpu_torch.parallel import gather_params, shard_params
    from fpqvar_tpu_torch.train.trainer import (make_optimizer,
                                                make_train_state,
                                                train_step, tree_leaves)

    rng = np.random.default_rng(15)
    b = DIST_TRAIN_BATCH
    batch = {"label": torch.from_numpy(rng.integers(0, cfg.num_classes, b)),
             "x": torch.from_numpy(rng.standard_normal(
                 (b, cfg.L - cfg.first_l, cfg.vae.z_channels))
                 .astype(np.float32)),
             "targets": torch.from_numpy(rng.integers(
                 0, cfg.vae.vocab_size, (b, cfg.L)))}
    batch = {k: v.to("cuda") for k, v in batch.items()}
    opt = make_optimizer(peak_lr=1e-4)
    p0 = init_var_params(cfg, seed=4, device="cuda", adaln_gamma_std=0.02)

    def step(params, bt, mesh=None):
        state = make_train_state(params, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, cfg, opt, bt, remat=True, mesh=mesh)
        loss = float(m["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        out = state.params if mesh is None else gather_params(state.params,
                                                              mesh)
        return loss, [t.detach() for t in tree_leaves(out)], ms

    ref = None
    if rank == 0:
        loss1, upd1, ms1 = step(p0, batch)
        perm = torch.arange(b - 1, -1, -1, device="cuda")
        lossp, updp, _ = step(p0, {k: v[perm] for k, v in batch.items()})
        start = [t.detach() for t in tree_leaves(p0)]
        noise = [float((a - c).norm()) for a, c in zip(updp, upd1)]
        size = [float((a - s0).norm()) for a, s0 in zip(upd1, start)]
        ref = (loss1, upd1, noise, size, abs(lossp - loss1))
        del updp
        torch.cuda.empty_cache()
        print(f"distributed: d16 float32 train_step batch {b} one device "
              f"{ms1:.1f} ms, loss {loss1}; rows reversed: loss {lossp}; "
              f"on {card}")
    for name, mesh in meshes.items():
        rows = slice(mesh.dp_rank * b // mesh.dp,
                     (mesh.dp_rank + 1) * b // mesh.dp)
        loss, upd, ms = step(shard_params(p0, mesh),
                             {k: v[rows] for k, v in batch.items()}, mesh)
        if rank == 0:
            loss1, upd1, noise, size, lnoise = ref
            worst = max((float((a - c).norm())
                         / max(3 * n + 1e-3 * sz, 1e-30), i)
                        for i, (a, c, n, sz) in enumerate(
                            zip(upd, upd1, noise, size)))
            if abs(loss - loss1) > 3 * lnoise + 1e-6 * loss1:
                fail(f"distributed train {name}: loss {loss} against "
                     f"{loss1} (rows reversed moved it {lnoise})")
            if worst[0] > 1.0:
                fail(f"distributed train {name}: leaf {worst[1]}'s update "
                     f"is {worst[0]:.3g} bounds from the one-device step's")
            print(f"distributed: train_step {name} {ms:.1f} ms a rank, loss "
                  f"{loss} (one device {loss1}, bound 3 * {lnoise} + 1e-6 * "
                  f"loss); every leaf within 3 x the rows-reversed distance "
                  f"+ 1e-3 of its update (worst {worst[0]:.3f}); on {card}")
        del upd
        torch.cuda.empty_cache()


def _dist_rank(out_path: str) -> int:
    """Phase 15's rank (started by ``phase_distributed``): the generations
    and train steps of the docstring's phase 15 on this rank."""
    import torch.distributed as dist

    from fpqvar_tpu_torch.config import GenerateConfig, MeshConfig, var_d16
    from fpqvar_tpu_torch.models import VARGenerator, init_vqvae_params
    from fpqvar_tpu_torch.models import var as V
    from fpqvar_tpu_torch.parallel import collectives as C
    from fpqvar_tpu_torch.parallel import make_mesh, shard_params
    from fpqvar_tpu_torch.quantize.recipe import synth_device_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    torch.cuda.set_device(0)
    card = os.environ["CHIP_SMOKE_CARD"]
    cfg = var_d16()
    rng = np.random.default_rng(2)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))
    vae = init_vqvae_params(cfg.vae, seed=1, device="cuda")
    meshes = {"tp2": make_mesh(MeshConfig(1, 2), "cuda"),
              "dp2": make_mesh(MeshConfig(2, 1), "cuda")}
    labels = torch.tensor([3, 5], device="cuda")
    record = []
    sample = V.sample_with_top_k_top_p

    def recording(logits, *a, **kw):
        idx = sample(logits, *a, **kw)
        record.append((idx, logits))
        return idx

    V.sample_with_top_k_top_p = recording
    blocks = cfg.depth * cfg.num_scales
    launches = {k: 0 for k in COUNTERS}
    for mode in DIST_RECIPES:
        q = _recipes()[mode]
        params = synth_device_params(cfg, q, seed=0, galt=galt,
                                     device="cuda")
        full_bytes = _tree_bytes(params)
        one = (_dist_one_device(cfg, q, params, vae, labels, record)
               if rank == 0 else None)
        for name, mesh in meshes.items():
            local = shard_params(params, mesh)
            gen = VARGenerator(cfg, q, GenerateConfig(), device="cuda",
                               fuse_steps=False, mesh=mesh)
            dist.barrier()
            reset_counts()
            C.reset_stats()
            imgs, ms, rec = _dist_generate(gen, local, vae, labels, record)
            counts = read_counts()
            stats = {k: list(v) for k, v in C.stats.items()}
            want = {k: 0 for k in COUNTERS}
            want.update({k: n * blocks for k, n in
                         DIST_PER_BLOCK[(mode, name)].items()})
            if counts != want:
                fail(f"distributed {mode} {name} rank {rank}: launches "
                     f"{counts}, expected {want}")
            for k, n in counts.items():
                launches[k] += n
            _images_ok(f"distributed {mode} {name}", imgs,
                       (DIST_BATCH, 3, 256, 256))
            kv = sum(t.nbytes for t in gen.init_cache(DIST_BATCH).values())
            whole = sum(t.nbytes for t in V.init_kv_cache(
                cfg, 2 * DIST_BATCH, gen.cache_dtype, "cuda",
                gen.qrt.kv_codec).values())
            if 2 * kv != whole:
                fail(f"distributed {mode} {name}: rank cache {kv} bytes of "
                     f"{whole}, not half")
            coll = ", ".join(f"{k} {v[0]} calls {v[1]} bytes {v[2]:.3f} s"
                             for k, v in stats.items() if v[0])
            share = sum(v[2] for v in stats.values()) * 1e3 / ms
            line = (f"distributed: {mode} {name} rank {rank}: {ms:.1f} ms a "
                    f"batch-{DIST_BATCH} generation; launches "
                    f"{ {k: n for k, n in counts.items() if n} }; KV cache "
                    f"{kv} bytes of {whole}; weights {_tree_bytes(local)} "
                    f"bytes of {full_bytes}; collectives {coll} ({share:.3f} "
                    f"of the wall time; gloo through the host, no yardstick "
                    f"for NVLink)")
            if rank == 0:
                line += ("; " + _dist_gates(mode, name, imgs, rec, one)
                         + f"; one device {one['ms']:.1f} ms")
            print(line + f"; on {card}", flush=True)
            del local, gen, imgs, rec
        del params, one
        torch.cuda.empty_cache()
    V.sample_with_top_k_top_p = sample
    _dist_train(cfg, meshes, rank, card)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(launches, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


#: a d16 tp = 2 rank's shards at the batch-8 last scale (M = 4096): name,
#: M, K, N of the rank's GEMM (columns N / 2, or the K-slice K / 2)
TP2_SHAPES = (("qkv-col", 4096, 1024, 1536), ("fc1-col", 4096, 1024, 2048),
              ("proj-row", 4096, 512, 1024), ("fc2-row", 4096, 2048, 1024))


def phase_mesh_kernels() -> dict:
    """K1, K2 and K3 at a d16 tp = 2 rank's shard shapes against their
    plain versions (K3, per channel, only on the column shards: the row
    split is the plain int32 product), timed as in phase 3."""
    from fpqvar_tpu_torch.ops import int8_matmul as K
    from fpqvar_tpu_torch.ops import packing as P
    from fpqvar_tpu_torch.ops import quant_matmul as QM

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    rows = {"K1": [], "K2": [], "K3": []}
    for name, m, k, n in TP2_SHAPES:
        ops = _k1_operands(m, k, n, gen) + (128,)
        x = torch.randn((m, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        b_lib = torch.randn((k, n), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        g = k // 128
        rows["K1"].append(check_and_time(
            "K1 tp2", {"shape": name, "M": m, "K": k, "N": n, "group": 128},
            lambda: K.int8_group_gemm(*ops),
            lambda: K.int8_group_gemm_ref(*ops),
            lambda: K.int8_group_gemm_tolerance(*ops),
            lambda: torch.matmul(x, b_lib),
            m * k + m * g * 4 + n * k + g * n * 4 + m * n * 4, H100_INT8_OPS,
            f"{K.K1_REL_TOL:g}*sum_g|sa*sw*part|", "bf16 torch.matmul"))
        pw = P.pack(torch.randn((n, k), generator=gen, device="cuda") * 0.02,
                    "fp_e2", 128)
        pops = (x, pw.codes, pw.scales, "fp_e2", 128, pw.nibble_packed)
        rows["K2"].append(check_and_time(
            "K2 tp2", {"shape": name, "M": m, "K": k, "N": n,
                       "fmt": "fp_e2", "x": "bfloat16"},
            lambda: QM.packed_matmul(*pops),
            lambda: QM.packed_matmul_ref(*pops),
            lambda: QM.packed_matmul_tolerance(*pops),
            lambda: torch.matmul(x, b_lib),
            (x.numel() * 2 + pw.codes.numel() + pw.scales.numel() * 4
             + m * n * 4), H100_BF16_FLOPS,
            f"{QM.K2_REL_TOL:g}*sum_g|s|*sum_k|x*grid|", "bf16 torch.matmul"))
        if name.endswith("col"):
            ac, asc = P.quant_int_codes(x.float(), "fp_e2", k)
            cw = P.pack_int_codes(torch.randn((n, k), generator=gen,
                                              device="cuda") * 0.02,
                                  "fp_e2", k)
            cops = (ac, asc, cw.codes, cw.scales)
            rows["K3"].append(check_and_time(
                "K3 tp2", {"shape": name, "M": m, "K": k, "N": n,
                           "out": "float32"},
                lambda: K.int8ch_gemm(*cops), lambda: K.int8ch_gemm_ref(*cops),
                None, lambda: torch.matmul(x, b_lib),
                m * k + m * 4 + n * k + n * 4 + m * n * 4, H100_INT8_OPS,
                "", "bf16 torch.matmul", int_mm=_int_mm(m, k, n, gen)))
    return rows


def phase_distributed(card: str) -> dict:
    """Phase 15: two ranks on ``cuda:0`` over gloo (NCCL does not put two
    ranks on one device), each a process of this script (``--dist-rank``,
    torchrun's environment).  Returns rank 0's launches of the mesh
    generations."""
    import gc
    import socket

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    out = os.path.join(tmp, "launches.json")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", CHIP_SMOKE_CARD=card)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-rank", out],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        print("\n".join(line for line in text.splitlines()
                        if line.startswith(("distributed", "chip_smoke"))))
        if p.returncode != 0:
            print(text[-4000:])
            fail(f"distributed: rank {r} exited {p.returncode}")
    with open(out) as f:
        launches = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the user-facing CLIs and the native host library
# ---------------------------------------------------------------------------

#: latency_breakdown at VAR-d16, full width and depth (phase 16 (b))
LATENCY_FLAGS = ["--preset", "d16", "--modes", "bf16,int8", "--batch", "8",
                 "--rounds", "3"]
#: the serve CLI at VAR-d16: W4A4 without GALT on the int8 backend (K1 at
#: fc2, K5 elsewhere), one batch of 8 demo requests (phase 16 (c))
SERVE_FLAGS = ["--depth", "16", "--recipe", "w4a4", "--no-transform",
               "--backend", "int8", "--demo", "8", "--max-batch", "8"]
#: K1, K5 and Q2 launches of one eager d16 int8 generation (160 block
#: forwards: fc2 as two K1 GEMMs, qkv, proj and fc1 through K5; Q2
#: quantizes the activation of all four)
D16_INT8_LAUNCHES = {"K1": 320, "K5": 480, "Q2": 640}
#: Q2 launches of ``quantize_var_params`` on the card under ``int8``: one
#: ``pack_int_codes`` of each depth-stacked block weight (qkv, proj, fc1,
#: fc2), which the serve CLI runs inside its counted window
INT8_QUANTIZE_LAUNCHES = {"Q2": 4}
#: PNGs of the write-rate comparison: count and side
PNG_RATE_SET = (64, 256)


def _host_toolchain() -> tuple:
    """``(g++ found, zlib.h found by it)`` on this machine."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False, False
    proc = subprocess.run([gxx, "-fsyntax-only", "-x", "c++", "-"],
                          input="#include <zlib.h>\n", capture_output=True,
                          text=True)
    return True, proc.returncode == 0


def _grid_probe(grid) -> np.ndarray:
    """±0, ±1e30, the grid, its midpoints and their float32 neighbours,
    and seeded Gaussians at the grid's scale (tests/test_torch_native.py's
    inputs)."""
    g = np.asarray(grid, np.float32)
    mids = (g[1:] + g[:-1]) / 2
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.float32([0.0, -0.0, 1e30, -1e30]), g, mids,
        np.nextafter(mids, np.float32(np.inf)),
        np.nextafter(mids, np.float32(-np.inf)),
        rng.standard_normal(2000).astype(np.float32) * np.abs(g).max(),
    ]).astype(np.float32)


def _png_idat(data: bytes) -> bytes:
    """The inflated IDAT stream of a PNG file's bytes."""
    import struct
    import zlib

    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            out.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return zlib.decompress(b"".join(out))


def _cli_native(tmp: str, card: str) -> None:
    """(a) The native host library: built (or, where this machine has no
    g++ or zlib.h, its numpy fallback, said so), every function equal to
    the port's torch counterparts on the card (snap and encode on every
    grid, the nibble pack of a d16 fc1 weight, uint8 conversion of a d16
    batch), the PNG writer's files equal to ``eval/png.py``'s (bytes where
    the two zlibs are one version, else inflated streams and pixels), and
    both writers' rates."""
    import zlib

    from fpqvar_tpu_torch.eval import imaging as Im
    from fpqvar_tpu_torch.eval import png
    from fpqvar_tpu_torch.ops import grids as G
    from fpqvar_tpu_torch.ops import packing as P
    from fpqvar_tpu_torch.ops import quantizers as Q
    from fpqvar_tpu_torch.utils import native

    gxx, zlib_h = _host_toolchain()
    ok = native.available()
    print(f"cli: (a) native library: g++ {'found' if gxx else 'missing'}, "
          f"zlib.h {'found' if zlib_h else 'missing'}; available {ok}, ABI "
          f"{native.abi_version()}, first load in this process "
          f"{native.build_seconds()} s (the g++ build); zlib: Python "
          f"{zlib.ZLIB_RUNTIME_VERSION}, the library's "
          f"{native.zlib_version()}")
    if not ok:
        if gxx and zlib_h:
            fail("cli: (a) the native library did not build where g++ and "
                 f"zlib.h exist:\n{native.build_error()}")
        print("cli: (a) this machine lacks g++ or zlib.h: the checks below "
              "hold the numpy fallback")
    grids = {**G.GRIDS, "E1M2_NEG": G.E1M2_NEG, "E2M1_POS": G.E2M1_POS,
             "E2M1_NEG": G.E2M1_NEG, "INT_NEG": G.INT_NEG,
             "E2M3_POS": G.E2M3_POS}
    for name, g in grids.items():
        x = _grid_probe(g)
        xc = torch.from_numpy(x).cuda()
        if not (np.array_equal(native.snap_to_grid(x, g),
                               Q.snap_to_grid(xc, g).cpu().numpy())
                and np.array_equal(native.encode_to_grid(x, g),
                                   P.encode_to_grid(xc, g).cpu().numpy())):
            fail(f"cli: (a) snap / encode on {name} differ from the port's "
                 "torch quantizers")
    gen = torch.Generator(device="cuda").manual_seed(16)
    w = torch.randn((4096, 1024), generator=gen, device="cuda") * 0.02
    pt = P.pack(w, "fp_e2")
    if not np.array_equal(native.pack_rows(P.unpack_codes(pt).cpu().numpy()),
                          pt.codes.cpu().numpy()):
        fail("cli: (a) pack_rows differs from ops/packing.py's layout")
    k = torch.arange(256, device="cuda", dtype=torch.float32) / 255.0
    vals = torch.cat([k, torch.nextafter(k, torch.full_like(k, 2.0)),
                      torch.nextafter(k, torch.full_like(k, -1.0)),
                      torch.tensor([-0.5, 1.5], device="cuda")])
    imgs = vals[torch.randint(0, vals.numel(), (8, 3, 256, 256),
                              generator=gen, device="cuda")]
    if not np.array_equal(native.images_to_uint8(imgs.cpu().numpy()),
                          Im.to_uint8_device(imgs).cpu().numpy()):
        fail("cli: (a) images_to_uint8 differs from to_uint8_device")
    n, side = PNG_RATE_SET
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    rng = np.random.default_rng(16)
    smooth = np.stack([np.stack([np.sin(6.3 * (xx * (1 + i % 5)) + c)
                                 * np.cos(4.1 * yy + i) for c in range(3)],
                                -1) for i in range(n)])
    batch = np.clip((smooth + 1) * 127.5 + rng.normal(0, 4, smooth.shape),
                    0, 255).astype(np.uint8)
    rates = {}
    for who in ("native", "png.py"):
        d = os.path.join(tmp, f"png_{who}")
        os.makedirs(d)
        paths = [os.path.join(d, f"{i}.png") for i in range(n)]
        t0 = time.perf_counter()
        if who == "png.py":
            png.write_png_batch(batch, paths)
        elif not native.write_png_batch(batch, paths):
            break
        rates[who] = n / (time.perf_counter() - t0)
    if ok:
        same = native.zlib_version() == zlib.ZLIB_RUNTIME_VERSION
        for i in range(n):
            with open(os.path.join(tmp, "png_native", f"{i}.png"), "rb") as f:
                ours = f.read()
            with open(os.path.join(tmp, "png_png.py", f"{i}.png"), "rb") as f:
                want = f.read()
            if (ours != want if same else _png_idat(ours) != _png_idat(want)):
                fail(f"cli: (a) PNG {i} differs from eval/png.py's "
                     f"({'bytes' if same else 'inflated IDAT'})")
            if not np.array_equal(png.decode_png(ours), batch[i]):
                fail(f"cli: (a) PNG {i} does not decode to its pixels")
        print(f"cli: (a) PNGs {'byte-equal' if same else 'IDAT-equal'} to "
              f"eval/png.py's, pixels exact")
    print(f"cli: (a) every function equal to the port's torch counterparts "
          f"on the card ({len(grids)} grids, a [4096, 1024] fc1 pack, an "
          f"[8, 3, 256, 256] batch); PNG write rate, {n} images of {side} "
          f"px: " + ", ".join(f"{k} {v:.1f} images/s"
                              for k, v in rates.items()) + f"; on {card}")


def _cli_latency(card: str) -> dict:
    """(b) ``tools/latency_breakdown.main`` at VAR-d16 (full width and
    depth), ``bf16`` and ``int8`` at batch 8, 3 rounds: every stage key,
    finite stepwise images, each eager ``int8`` pass exactly K1 320 + K5
    480 + Q2 640 and each ``bf16`` pass none.  Returns the port kernels'
    launches
    over all stepwise passes."""
    from fpqvar_tpu_torch.config import var_d16
    from fpqvar_tpu_torch.tools import latency_breakdown as LB

    out = LB.main(LATENCY_FLAGS)
    keys = (["prepare"] + [f"scale{si}_pn{pn}" for si, pn in
                           enumerate(var_d16().patch_nums)]
            + ["vqvae_decode"])
    totals = dict.fromkeys(COUNTERS, 0)
    for mode in ("bf16", "int8"):
        if list(out["per_stage_ms"][mode]) != keys:
            fail(f"cli: (b) {mode} stages {list(out['per_stage_ms'][mode])}")
        if not out["stepwise_images_finite"][mode]:
            fail(f"cli: (b) {mode}: non-finite stepwise images")
        want = D16_INT8_LAUNCHES if mode == "int8" else {}
        for i, got in enumerate(out["launches_per_pass"][mode]):
            if got != {k: want.get(k, 0) for k in got}:
                fail(f"cli: (b) {mode} pass {i} launched {got}, expected "
                     f"{want or 'none'}")
            for k, v in got.items():
                totals[k] += v
    rows = out["per_stage_ms"]
    print("cli: (b) per-stage ms, bf16 / int8 (ratio): " + "; ".join(
        f"{k} {rows['bf16'][k]:.3f} / {rows['int8'][k]:.3f} "
        f"({out['stage_ratio_vs_bf16']['int8'].get(k, float('nan')):.3f})"
        for k in keys) + f"; stepwise sum {out['stepwise_sum_ms']}, fused "
        f"{out['fused_call_ms']}; every int8 pass K1 320 + K5 480 + Q2 640; "
        f"on {card}")
    return totals


def _cli_serve(tmp: str, card: str) -> dict:
    """(c) ``tools/serve.main`` at VAR-d16, W4A4 on the int8 backend, 8
    demo requests at ``max_batch`` 8, under torch.profiler: JAX's 8 PNG
    names; the host counters see K1 640 + K5 960 + Q2 1,280 (the fused
    generator's eager warm-up and its capture) and the profiler K1 320 +
    K5 480 + Q2 640 for the warm-up and for each served batch's replay
    (phase 10's count), both besides the quantize stage's Q2 4
    (``INT8_QUANTIZE_LAUNCHES``); the PNGs' pixels equal ``to_uint8`` of
    the same requests through an eager ``GenerationServer`` over the CLI's
    trees (exactly K1 320 + K5 480 + Q2 640 a batch).  Returns the profiler's
    launches of K1, K5 and Q2."""
    from torch.profiler import ProfilerActivity, profile

    from fpqvar_tpu_torch.config import GenerateConfig
    from fpqvar_tpu_torch.eval import imaging as Im
    from fpqvar_tpu_torch.eval import png
    from fpqvar_tpu_torch.models import VARGenerator
    from fpqvar_tpu_torch.serving import GenerationServer
    from fpqvar_tpu_torch.tools import serve
    from fpqvar_tpu_torch.tools._common import model_config

    out_dir = os.path.join(tmp, "served")
    flags = SERVE_FLAGS + ["--out", out_dir]
    reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        st = serve.main(flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host = read_counts()
    events = _device_events(prof)
    device = {k: sum(e.count for e in events
                     if any(p in e.key for p in PORT_KERNELS[k]))
              for k in D16_INT8_LAUNCHES}
    want_host = {k: 2 * D16_INT8_LAUNCHES.get(k, 0)
                 + INT8_QUANTIZE_LAUNCHES.get(k, 0) for k in COUNTERS}
    if host != want_host:
        fail(f"cli: (c) serve's host counters {host}, expected {want_host} "
             "(the quantize stage, one warm-up and one capture)")
    for k, per in D16_INT8_LAUNCHES.items():
        want = per * (1 + st["batches"]) + INT8_QUANTIZE_LAUNCHES.get(k, 0)
        if device[k] != want:
            fail(f"cli: (c) the profiler saw {k} {device[k]} times, expected "
                 f"{want}: {per} for the warm-up and each of "
                 f"{st['batches']} replays, and the quantize stage's")
    names = [f"class{i}_img{i}.png" for i in range(8)]
    if sorted(os.listdir(out_dir)) != sorted(names):
        fail(f"cli: (c) serve wrote {sorted(os.listdir(out_dir))}")
    args = serve.parse_args(flags)
    qcfg = serve.recipe(args)
    cfg = model_config(args)
    var_p, vae_p = serve.load_trees(args, cfg, qcfg)
    reset_counts()
    srv = GenerationServer(VARGenerator(cfg, qcfg, GenerateConfig(),
                                        fuse_steps=False),
                           var_p, vae_p, max_batch=8)
    try:
        imgs = [f.result() for f in [srv.submit(i, i) for i in range(8)]]
        eager_batches = srv.stats()["batches"]
    finally:
        srv.stop()
    eager = read_counts()
    for k, per in D16_INT8_LAUNCHES.items():
        if eager[k] != per * eager_batches:
            fail(f"cli: (c) the eager server launched {k} {eager[k]} times "
                 f"in {eager_batches} batches")
    for i, (name, img) in enumerate(zip(names, imgs)):
        got = png.read_png(os.path.join(out_dir, name))
        if not np.array_equal(got, Im.to_uint8(img[None])[0]):
            fail(f"cli: (c) {name} differs from the eager server's image")
    print(f"cli: (c) serve {' '.join(SERVE_FLAGS)}: {st['batches']} "
          f"batch(es), {wall:.2f} s under the profiler (build, quantize, "
          f"warm-up and capture included); host counters {host}; profiler "
          f"K1 {device['K1']}, K5 {device['K5']}, Q2 {device['Q2']} (the "
          f"warm-up and {st['batches']} replay(s): K1 320 + K5 480 + Q2 640 "
          f"each, and Q2 4 for the quantize stage); 8 PNGs equal "
          f"to the eager server's images; on {card}")
    return device


def phase_cli(card: str) -> tuple:
    """Phase 16: (a) the native host library, (b) the latency breakdown
    and (c) the serve CLI, in a temporary directory removed at its end.
    Returns the launches of (b)'s stepwise passes and (c)'s serving."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        _cli_native(tmp, card)
        latency = _cli_latency(card)
        torch.cuda.empty_cache()
        served = _cli_serve(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return latency, served


#: phase 17: the capacity study at VAR-d16, two modes at batches 8 and
#: 16, two rounds: four probe children
CAPACITY_FLAGS = ["--preset", "d16", "--modes", "bf16,int8kv", "--start",
                  "8", "--cap", "16", "--rounds", "2"]
#: one eager d16 generation's launches per mode (160 block forwards:
#: int8kv's qkv, proj and fc1 through K4, fc2's two dual-grid halves
#: through K3 on Q2's codes, and Q2 encoding each block's new K and V)
CAPACITY_LAUNCHES = {"bf16": {}, "int8kv": {"K4": 480, "K3": 320,
                                            "Q2": 480}}


def phase_capacity(card: str) -> dict:
    """Phase 17: ``tools/capacity_study.main`` (``CAPACITY_FLAGS``), each
    probe a fresh process.  Returns the port kernels' launches summed over
    the children's eager warm-ups (each child's counters start at 0)."""
    import contextlib
    import gc
    import io

    from fpqvar_tpu_torch.tools import capacity_study as CS

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = CS.main(CAPACITY_FLAGS)
    wall = time.perf_counter() - t0
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    modes = list(CAPACITY_LAUNCHES)
    if [l.get("mode") for l in lines[:2]] != modes or len(lines) != 3 \
            or set(lines[2]) != {"metric", "value", "unit", "vs_baseline"}:
        fail(f"capacity: the study printed {lines}")
    totals = dict.fromkeys(COUNTERS, 0)
    for mode, line in zip(modes, lines):
        if line["curve"].keys() != {"8", "16"}:
            fail(f"capacity: {mode} curve {line}")
        for b in (8, 16):
            rec = out["probes"][mode][str(b)]
            # the tool's counters: K1-K5 and Q1-Q3 (K6 and K7 run only in
            # the rate probe)
            want = {k: CAPACITY_LAUNCHES[mode].get(k, 0)
                    for k in rec["warmup_launches"]}
            for when in ("warmup", "capture"):
                if rec[when + "_launches"] != want:
                    fail(f"capacity: {mode} batch {b} {when} launched "
                         f"{rec[when + '_launches']}, expected {want}")
            if not rec["images_finite"] or rec["image_shape"] != [
                    b, 3, 256, 256]:
                fail(f"capacity: {mode} batch {b} images "
                     f"{rec['image_shape']}, finite {rec['images_finite']}")
            for k, v in rec["warmup_launches"].items():
                totals[k] += v
            seen = {k: v for k, v in rec["warmup_launches"].items() if v}
            print(f"capacity: d16 {mode} batch {b}: {rec['ips']:.3f} img/s "
                  f"(median of {rec['rounds']} replays "
                  f"{rec['median_s'] * 1e3:.1f} ms); peak allocated "
                  f"{rec['max_memory_allocated']} bytes, reserved "
                  f"{rec['max_memory_reserved']}; weights "
                  f"{rec['weight_bytes']}, KV cache {rec['cache_bytes']}; "
                  f"graph pool {rec['pool_bytes']}; warm-up "
                  f"{rec['warmup_s']:.2f} s, capture {rec['capture_s']:.2f} "
                  f"s; warm-up launches {seen or 'none'}; on {card}")
    for l in lines:
        print("capacity: " + json.dumps(l))
    print(f"capacity: four probe children in {wall:.1f} s")
    return totals


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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


def _quant_row(name, source, replaces, launches, rows, timed):
    """One quantizer kernel of the JSON table: timed at the d16 shape
    ``timed``, bit-equal (``max_abs_err`` 0) at every shape."""
    head = next(r for r in rows if r["shape"] == timed)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "host_ms": head["host_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "timed_shape": timed, "shapes": rows}


def _attn_row(name, source, replaces, launches, a_rows, timed):
    """A1 in the JSON table: timed at the case ``timed``, the widest gap
    over every case, the d36-512 generation's sum."""
    rows = a_rows["rows"]
    head = next(r for r in rows if r["shape"] == timed)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "host_ms": head["host_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "timed_shape": timed,
            "d36_generation_ms_per_img": a_rows["gen_ms"], "shapes": rows}


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-rank":
        return _dist_rank(sys.argv[2])
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--quant-ab":
        return quant_ab(*sys.argv[2:])
    t_start = time.perf_counter()

    def done(phase: str):
        print(f"chip_smoke: {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s")

    card = phase_device()
    phase_build()
    done("build")
    k1_rows = phase_kernels()
    k2_rows = phase_k2()
    k3_rows = phase_k3()
    k4_rows = phase_k4()
    k5_rows = phase_k5()
    k6_rows = phase_k6()
    k7_rows = phase_k7()
    q_rows = phase_quant()
    a_rows = phase_attention()
    done("kernels")
    phase_small_reference()
    done("small reference")
    launches, setups, vae, per_gen = phase_main_path(card)
    done("main path and profile")
    phase_fused(setups, vae, per_gen, card, q_rows["Q3 scales"]["gen_ms"])
    done("fused")
    phase_serving(setups, vae, card)
    done("serving")
    del setups
    probe_launches = phase_probe(card)
    done("probe")
    phase_d36(card)
    done("d36-512")
    phase_transform(card)
    done("transform")
    tf_launches, tf_rows = phase_teacher(card)
    done("teacher forcing and training")
    offline_launches = phase_offline(card)
    done("offline pipeline")
    eval_launches = phase_eval(card)
    done("evaluation")
    mesh_rows = phase_mesh_kernels()
    dist_launches = phase_distributed(card)
    done("distributed")
    latency_launches, serve_launches = phase_cli(card)
    done("cli (phase 16)")
    capacity_launches = phase_capacity(card)
    done("capacity study (phase 17)")
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
        # the quantizers replace no TPU kernel: each replaces the XLA
        # fusion of a jitted JAX function (file:line of its definition)
        _quant_row("fake_quant_grid", src + "fake_quant_grid.cu",
                   "fpqvar_tpu/ops/quantizers.py:105", launches["Q1"],
                   q_rows["Q1"], "qkv-fp_e2-g128"),
        _quant_row("grid_codes", src + "grid_codes.cu",
                   "fpqvar_tpu/ops/packing.py:207", launches["Q2"],
                   q_rows["Q2"], "qkv-fp_e2-g128"),
        _quant_row("fake_quant_int", src + "fake_quant_int.cu",
                   "fpqvar_tpu/ops/quantizers.py:209", launches["Q3"],
                   q_rows["Q3"], "qkv-sym-token"),
        # A1 replaces no TPU kernel: the XLA einsum chain of JAX's
        # value-code attention (file:line of its first einsum)
        _attn_row("packed_attention", src + "packed_attention.cu",
                  "fpqvar_tpu/models/var.py:306", launches["A1"], a_rows,
                  "d36-s9-pn32"),
    ]}
    # the teacher-forcing forward's launches of K1-K5 (phase 12) and their
    # times at its M = 5440, beside the generation path's
    for row, kern, timed in zip(kernels["kernels"],
                                ("K1", "K2", "K3", "K4", "K5"),
                                ("fc2", "fc1", "fc2", "fc1", "fc1")):
        tf = _kernel_row(row["name"], row["source"], row["replaces"],
                         tf_launches[kern], tf_rows[kern], timed=timed)
        row["teacher_forcing"] = {k: v for k, v in tf.items()
                                  if k not in ("name", "route", "source",
                                               "replaces")}
    # the offline pipeline's reloaded int8 generation (phase 13)
    for row, kern in zip(kernels["kernels"], COUNTERS):
        row["offline_launches"] = offline_launches[kern]
    # the evaluation phase's eager eval sets (phase 14: K1 and K5 in (a),
    # K2 in (b))
    for row, kern in zip(kernels["kernels"], COUNTERS):
        row["eval_launches"] = eval_launches[kern]
        # rank 0's launches of phase 15's mesh generations (K1, K2, K3)
        # and the kernel at a tp = 2 rank's shard shapes
        row["mesh_launches"] = dist_launches[kern]
        if kern in mesh_rows:
            row["mesh_shards"] = mesh_rows[kern]
        # phase 16: the latency breakdown's stepwise passes (host
        # counters) and the serve CLI's run (the profiler: the warm-up and
        # each served batch's replay)
        row["latency_launches"] = latency_launches[kern]
        row["serve_launches"] = serve_launches.get(kern, 0)
        # phase 17: the capacity study's children, their eager warm-ups
        row["capacity_launches"] = capacity_launches[kern]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
