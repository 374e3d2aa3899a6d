"""The system under test: the PyTorch port ``fpqvar_tpu_torch``, built from
a configuration file and the benchmark's seeded weights.

Everything the benchmark takes from the program goes through here: its
configuration types, its device transform of the weights, the generator
(``VARGenerator``, fused on CUDA graphs) and the server
(``GenerationServer``), the capture statistics, and a few rows of its
state, which :class:`StateTap` copies out where the program produces it.  The
program is imported inside the functions, so that the rest of the
benchmark, its tests and its reference load without it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from benchmark import weights


def build_configs(spec: dict):
    """(VARConfig, QuantConfig, GenerateConfig) of a configuration file."""
    from fpqvar_tpu_torch.config import (GenerateConfig, QuantConfig,
                                         VARConfig, VQVAEConfig)

    v = dict(spec["vae"])
    v["ch_mult"] = tuple(v["ch_mult"])
    v["patch_nums"] = tuple(v["patch_nums"])
    m = dict(spec["model"])
    m["patch_nums"] = tuple(m["patch_nums"])
    return (VARConfig(vae=VQVAEConfig(**v), **m), QuantConfig(**spec["recipe"]),
            GenerateConfig(**spec["sampling"]))


class StateTap:
    """Copies out, inside the program's own generation step (and so inside
    its CUDA graphs), for a few fixed rows of a batch: each block's input
    and the head's input (``X`` ``[depth + 1, 2R, L, C]`` bfloat16, the
    rows and their unconditional twins), the head's AdaLN scale and shift
    (``S`` ``[2R, 2C]``, the output of its ``head_nm`` linear, the same at
    every scale) and every row's sampled tokens (``tokens`` ``[B, L]``).
    The program's block, head, linear and sampler are wrapped where its
    scale step calls them; a block's index is its place in the order the
    step calls them, a scale's place its token count, the head's AdaLN
    linear the one on ``head_w``.  ``snapshot()`` copies the buffers after
    a generation."""

    def __init__(self, depth: int, patch_nums, device):
        self.offsets, at = {}, 0
        for pn in patch_nums:
            self.offsets[pn * pn] = at
            at += pn * pn
        self.L, self.depth, self.device = at, depth, device
        self.count = 0
        self.b = None
        self._orig = None

    def arm(self, batch: int, rows, width: int):
        """Buffers for ``rows`` of batches of ``batch``; before the
        generator's first call, whose capture fixes their addresses."""
        dev = self.device
        self.b = batch
        self.rows = torch.as_tensor(rows, dtype=torch.long, device=dev)
        self.rows2 = torch.cat([self.rows, self.rows + batch])
        r = len(rows)
        self.X = torch.zeros((self.depth + 1, 2 * r, self.L, width),
                             dtype=torch.bfloat16, device=dev)
        self.S = torch.zeros((2 * r, 2 * width), dtype=torch.bfloat16,
                             device=dev)
        self.tokens = torch.full((batch, self.L), -1, dtype=torch.long,
                                 device=dev)

    def install(self, head_w):
        from fpqvar_tpu_torch.models import var as V

        tap = self
        block, head, sample, lin = (V.block_forward, V.head_logits,
                                    V.sample_with_top_k_top_p, V.linear)

        def linear(x, w, *a, **k):
            y = lin(x, w, *a, **k)
            if w is head_w and y.shape[0] == 2 * tap.b:
                tap.S.copy_(y.index_select(0, tap.rows2))
            return y

        def block_forward(x, *a, **k):
            j = tap.count % tap.depth
            tap.count += 1
            tap._put(j, x)
            return block(x, *a, **k)

        def head_logits(params, cfg, x, *a, **k):
            tap._put(tap.depth, x)
            return head(params, cfg, x, *a, **k)

        def sample_with_top_k_top_p(logits, *a, **k):
            idx = sample(logits, *a, **k)
            if idx.shape[0] == tap.b:
                at = tap.offsets[idx.shape[1]]
                tap.tokens[:, at:at + idx.shape[1]].copy_(idx)
            return idx

        self._orig = (block, head, sample, lin)
        V.block_forward, V.head_logits = block_forward, head_logits
        V.sample_with_top_k_top_p, V.linear = sample_with_top_k_top_p, linear

    def _put(self, j, x):
        if x.shape[0] == 2 * self.b:
            at = self.offsets[x.shape[1]]
            self.X[j, :, at:at + x.shape[1]].copy_(
                x.index_select(0, self.rows2))

    def uninstall(self):
        if self._orig is not None:
            from fpqvar_tpu_torch.models import var as V

            (V.block_forward, V.head_logits, V.sample_with_top_k_top_p,
             V.linear) = self._orig
            self._orig = None

    def snapshot(self) -> dict:
        return {"X": self.X.clone(), "S": self.S.clone(),
                "tokens": self.tokens.clone()}

    def free(self):
        self.X = self.S = self.tokens = None


@dataclass
class Program:
    spec: dict
    cfg: object
    qcfg: object
    gen_cfg: object
    params: dict
    vae: dict
    generator: object
    tap: StateTap
    build_s: dict = field(default_factory=dict)

    def close(self):
        """Drop the program's state and its device memory."""
        self.tap.uninstall()
        self.params = self.vae = self.generator = None
        self.tap.free()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def build(spec: dict, seed: int, device) -> Program:
    """The program for ``spec`` on ``device`` with weights from ``seed``:
    the raw tree through the program's device transform (and, for the
    fake backend, its bfloat16 cast), a fused generator, the state tap
    installed (armed by the driver)."""
    from fpqvar_tpu_torch.models import VARGenerator
    from fpqvar_tpu_torch.quantize.recipe import (to_bf16,
                                                  transform_blocks_traced)

    cfg, qcfg, gen_cfg = build_configs(spec)
    t0 = time.perf_counter()
    var, galt, vae = weights.make(spec, seed, device)
    t1 = time.perf_counter()
    params = dict(var)
    params["blocks"] = transform_blocks_traced(var["blocks"], cfg, qcfg, galt)
    del var
    if qcfg.backend == "fake":
        params = to_bf16(params)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    tap = StateTap(cfg.depth, cfg.patch_nums, device)
    tap.install(params["head_nm"]["w"])
    gen = VARGenerator(cfg, qcfg, gen_cfg, device=device)
    return Program(spec, cfg, qcfg, gen_cfg, params, vae, gen, tap,
                   {"weights_s": t1 - t0, "transform_s": t2 - t1})


class GeneratorShim:
    """What the server holds in place of the generator: the generator's
    ``device`` and a ``generate`` that records, per call, its host start
    and end and the rows' generator seeds, and after call ``check_at``
    the state tap's snapshot."""

    def __init__(self, prog: Program, clock, check_at: int):
        self._prog = prog
        self.device = prog.generator.device
        self._clock = clock
        self.check_at = check_at
        self.calls = []
        self.state = None

    def generate(self, params, vae_params, labels, generators):
        t0 = self._clock()
        imgs = self._prog.generator.generate(params, vae_params, labels,
                                             generators)
        if len(self.calls) == self.check_at:
            self.state = self._prog.tap.snapshot()
        self.calls.append({"start": t0, "end": self._clock(),
                           "seeds": [g.initial_seed() for g in generators]})
        return imgs


def server(prog: Program, shim: GeneratorShim, max_batch: int,
           max_wait_ms: float, base_seed: int):
    from fpqvar_tpu_torch.serving import GenerationServer

    return GenerationServer(shim, prog.params, prog.vae, max_batch=max_batch,
                            max_wait_ms=max_wait_ms, base_seed=base_seed)


def kv_cache_bytes(prog: Program, batch: int) -> int:
    """Bytes of the tensors of ``VARGenerator.init_cache(batch)``."""
    cache = prog.generator.init_cache(batch)
    n = sum(t.numel() * t.element_size() for t in cache.values())
    del cache
    return n
