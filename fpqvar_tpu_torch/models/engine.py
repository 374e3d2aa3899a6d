"""Generation engine: class labels -> images.

Two modes, as the JAX package's engine has:

- ``fuse_steps=False``: an eager loop over the scales, which launches every
  kernel of a generation from the host (13k to 267k launches a d16 batch);
- ``fuse_steps=True`` (the default, as in JAX): on a CUDA device, a
  generation runs as two CUDA graphs, one for prepare, the KV cache and
  the ten scales (JAX's one fused program) and one for the VQVAE decode
  (JAX's second program), captured once for each batch size and params
  tree and replayed.  The inputs reach the graphs through static buffers:
  the labels, and the whole generation's Gumbel noise, drawn eagerly from
  the caller's generators before each replay (``sampling.noise_plan``),
  so each generator yields the same values and ends in the same state as
  in the eager loop, and the images are the eager loop's, bit for bit.
  On the CPU the same static-buffer code runs without capture.

Every mode launches the stage marker (``ops/stage_mark.py``) at the start
of each scale and once after the last, so a device trace splits a replay
by scale.  A fused call records the spans ``engine.generate`` and, inside
it, ``engine.draw`` (the labels and the noise into the static buffers),
``engine.launch`` (the graphs' replays, or on the CPU the generation) and
``engine.copy`` (the output's copy), while a profiler runs
(``utils/logging.py`` ``span``).

Under a ``{dp, tp}`` mesh (``mesh=``, ``parallel/mesh.py``; the eager loop
only) each rank holds its shards of the params tree (``shard_params``):
dp splits the labels, each rank doubling its own rows for classifier-free
guidance, and tp splits the linears, the head and attention's heads, the
KV cache holding only the rank's rows and heads.  The sampling noise is
the one-device run's: per-row generators are split with the labels, and
one generator draws the whole batch's noise plan (``sampling.noise_plan``,
the eager loop's draws in its order) of which each rank keeps its rows.
``generate`` returns the rank's images, or with ``gather=True`` the whole
batch's on every rank.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from fpqvar_tpu_torch.config import GenerateConfig, QuantConfig, VARConfig
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.models import vqvae as vq
from fpqvar_tpu_torch.models.sampling import Generators, noise_plan
from fpqvar_tpu_torch.ops.stage_mark import stage_mark
from fpqvar_tpu_torch.parallel import collectives as C
from fpqvar_tpu_torch.quantize.runtime import QuantRuntime, build_runtime
from fpqvar_tpu_torch.utils.logging import span


@dataclass
class _Fused:
    """The static buffers and graphs of one batch size and params tree.
    The trees and their leaves are held so that the memory the graphs read
    stays alive."""

    params: dict
    vae_params: dict
    leaves: list
    labels: torch.Tensor
    noise: list
    f_hat: Optional[torch.Tensor] = None      # the graphs' static outputs
    images: Optional[torch.Tensor] = None
    graphs: tuple = ()                        # (steps, decode) on a card
    stats: dict = field(default_factory=dict)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class VARGenerator:
    """One (model, recipe, sampling) configuration on one device."""

    def __init__(
        self,
        cfg: VARConfig,
        qcfg: QuantConfig,
        gen: GenerateConfig = GenerateConfig(),
        qrt: Optional[QuantRuntime] = None,
        cache_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        device="cuda",
        fuse_steps: bool = True,
        mesh=None,
    ):
        """``qrt``: a runtime already built for ``qcfg`` on ``device``
        (else one is built).  ``fuse_steps``: replay CUDA graphs of a whole
        generation (module docstring); ``False`` runs the eager loop,
        whose launches the kernels' host counters see one by one.
        ``mesh``: a ``parallel.Mesh``; the params passed to ``generate``
        are then this rank's shards.  The fused mode is not ported under
        a mesh (ROADMAP.md section 1): ``fuse_steps=True`` with a mesh
        raises ``NotImplementedError``.  JAX's ``shardings`` argument has
        no counterpart: every split follows from ``mesh``."""
        if mesh is not None and fuse_steps:
            raise NotImplementedError(
                "the fused mode (CUDA graphs) under a mesh is not ported "
                "(ROADMAP.md section 1: fused mode under NCCL); pass "
                "fuse_steps=False")
        self.cfg = cfg
        self.qcfg = qcfg
        self.gen = gen
        self.device = torch.device(device)
        self.qrt = (qrt if qrt is not None
                    else build_runtime(qcfg, cfg.depth, cfg.width, device))
        if mesh is not None:
            if cfg.heads % mesh.tp:
                raise ValueError(f"{cfg.heads} heads do not split over "
                                 f"tp={mesh.tp}")
            self.qrt = dataclasses.replace(self.qrt, mesh=mesh)
        self.mesh = mesh
        self.cache_dtype = cache_dtype
        self.compute_dtype = compute_dtype
        self.statics = V.GenStatics.all_steps(cfg)
        self.fuse_steps = fuse_steps
        #: batch size -> its static buffers and graphs
        self._fused = {}

    def init_cache(self, batch: int) -> dict:
        """The KV cache of a ``batch``-label generation (CFG doubles the
        rows): dense in ``cache_dtype``, or packed under the recipe's KV
        codec.  Under a mesh, this rank's share, as JAX's
        ``kv_cache_shardings``: ``batch / dp`` labels' rows and ``heads /
        tp`` heads (the dense ``[depth, B, L, H*c]`` cache split on dims 1
        and 3, the packed codes ``[depth, B, H, L, c]`` and scales
        ``[depth, B, H, L]`` on dims 1 and 2)."""
        dp, tp = (1, 1) if self.mesh is None else (self.mesh.dp,
                                                   self.mesh.tp)
        return self._cache(batch // dp, self.cfg.heads // tp)

    def _cache(self, b: int, heads: int) -> dict:
        return V.init_kv_cache(self.cfg, 2 * b, self.cache_dtype,
                               self.device, self.qrt.kv_codec, heads)

    @torch.inference_mode()
    def generate(self, params, vae_params, label_B,
                 generator: Optional[Generators] = None,
                 return_fhat: bool = False,
                 gather: bool = False) -> torch.Tensor:
        """Class-conditional generation -> images [B, 3, H, W] in [0, 1]
        (or the f32 ``f_hat`` [B, Cvae, pn, pn] with ``return_fhat``).
        Sampling noise comes from ``generator``: one ``torch.Generator`` for
        the batch, or a sequence of B, one per label row (JAX's ``[B, 2]``
        keys), so that a row's image depends only on its own generator.
        Generators live on the generator's device.

        Given labels already on the device, the call does not wait for the
        device: it only queues work (the first call on a device copies a
        few constants there once, and the first fused call for a batch size
        and params tree warms up and captures its graphs).  A fused call
        returns a copy of the graphs' output, so the next replay does not
        overwrite it.

        Under a mesh ``label_B`` is the whole batch (a multiple of dp) and
        ``generator`` its one generator or its B generators, the same on
        every rank; the call returns this rank's rows, or the whole batch
        with ``gather``."""
        label_B = torch.as_tensor(label_B, dtype=torch.long,
                                  device=self.device)
        b = label_B.shape[0]
        if not (generator is None or isinstance(generator, torch.Generator)
                or len(generator) == b):
            raise ValueError(f"{len(generator)} generators for {b} labels")
        if self.mesh is not None:
            out = self._mesh_steps(params, vae_params, label_B, generator,
                                   return_fhat)
            return C.gather_dp(out, self.mesh) if gather else out
        if not self.fuse_steps:
            f_hat = self._steps(params, vae_params["quantize"], label_B,
                                generator=generator)
            return f_hat if return_fhat else self._decode(vae_params, f_hat)
        with span("engine.generate", batch=b):
            fz = self._entry(b, params, vae_params)
            with span("engine.draw"):
                fz.labels.copy_(label_B)
                self._draw(b, generator, fz.noise)
            with span("engine.launch"):
                if fz.graphs:
                    steps, decode = fz.graphs
                    steps.replay()
                    if not return_fhat:
                        decode.replay()
                    out = fz.f_hat if return_fhat else fz.images
                else:
                    f_hat = self._steps(params, vae_params["quantize"],
                                        fz.labels, noise=fz.noise)
                    out = (f_hat if return_fhat
                           else self._decode(vae_params, f_hat))
            with span("engine.copy"):
                return out.clone()

    def capture_stats(self, batch: int) -> dict:
        """What the capture of ``batch``'s graphs cost: ``warmup_s`` (the
        eager warm-up generation), ``capture_s`` (capture and instantiation
        of both graphs) and ``pool_bytes`` (device memory the graphs'
        private pool reserved); empty before the first fused call on a
        card."""
        fz = self._fused.get(batch)
        return dict(fz.stats) if fz is not None else {}

    # ------------------------------------------------------------------
    def _mesh_steps(self, params, vae_params, label_B, generator,
                    return_fhat: bool):
        """This rank's rows of a mesh generation (``generate``)."""
        m = self.mesh
        b = label_B.shape[0]
        if b % m.dp:
            raise ValueError(f"{b} labels do not split over dp={m.dp}")
        if generator is None:
            raise ValueError("a mesh generation needs its generators: the "
                             "ranks must draw the same noise")
        bl = b // m.dp
        rows = slice(m.dp_rank * bl, (m.dp_rank + 1) * bl)
        noise = None
        if isinstance(generator, torch.Generator):
            noise = [tuple(None if t is None else t[rows] for t in pair)
                     for pair in self._draw(b, generator)]
            generator = None
        else:
            generator = list(generator)[rows]
        f_hat = self._steps(params, vae_params["quantize"], label_B[rows],
                            generator=generator, noise=noise)
        return f_hat if return_fhat else self._decode(vae_params, f_hat)

    def _steps(self, params, vae_q, label_B, generator=None, noise=None):
        """Prepare, the KV cache and every scale -> f_hat [B, Cvae, pn,
        pn] f32; noise from ``generator``, or from a noise plan."""
        cfg = self.cfg
        b = label_B.shape[0]
        cond_BD, mod, lvl_pos, x = V.prepare_generation(params, cfg, label_B,
                                                       self.qrt)
        x = x.to(self.compute_dtype)
        mod = mod.to(self.compute_dtype)
        lvl_pos = lvl_pos.to(self.compute_dtype)
        tp = 1 if self.mesh is None else self.mesh.tp
        cache = self._cache(b, cfg.heads // tp)
        hw = cfg.patch_nums[-1]
        f_hat = torch.zeros((b, cfg.vae.z_channels, hw, hw),
                            dtype=torch.float32, device=self.device)
        for st in self.statics:
            stage_mark(st.si, self.device)
            x, f_hat = V.scale_step(params, vae_q, cfg, self.qrt, self.gen,
                                    st, x, cond_BD, mod, lvl_pos, cache,
                                    f_hat, generator,
                                    None if noise is None else noise[st.si])
            if x is not None:
                x = x.to(self.compute_dtype)
        stage_mark(len(self.statics), self.device)
        return f_hat

    def _decode(self, vae_params, f_hat):
        return (vq.decode(vae_params, self.cfg.vae, f_hat) + 1.0) * 0.5

    def _draw(self, b: int, generator, out=None) -> list:
        return noise_plan([st.l for st in self.statics],
                          self.cfg.vae.vocab_size, b, generator,
                          self.gen.more_smooth, self.device, out)

    def _entry(self, b: int, params, vae_params) -> _Fused:
        """The static buffers (and on a card the graphs) of batch ``b``
        for these trees; another tree replaces the batch's old entry, whose
        graphs are released first."""
        fz = self._fused.get(b)
        if (fz is not None and fz.params is params
                and fz.vae_params is vae_params):
            return fz
        self._fused.pop(b, None)

        def zeros(l):
            return torch.zeros((b, l, self.cfg.vae.vocab_size),
                               device=self.device)

        noise = [(zeros(st.l), zeros(st.l) if self.gen.more_smooth else None)
                 for st in self.statics]
        fz = _Fused(params, vae_params, _leaves(params) + _leaves(vae_params),
                    torch.zeros(b, dtype=torch.long, device=self.device),
                    noise)
        if self.device.type == "cuda":
            self._capture(fz)
        self._fused[b] = fz
        return fz

    def _capture(self, fz: _Fused) -> None:
        """One eager warm-up generation from the static buffers on a side
        stream (kernel builds, ctypes loads, per-device attributes and
        every lazily cached constant happen there, outside the capture),
        then the two graphs on one private pool."""
        dev = self.device
        vae_q = fz.vae_params["quantize"]
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._decode(fz.vae_params,
                         self._steps(fz.params, vae_q, fz.labels,
                                     noise=fz.noise))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        steps, decode = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(steps, capture_error_mode="thread_local"):
            fz.f_hat = self._steps(fz.params, vae_q, fz.labels,
                                   noise=fz.noise)
        with torch.cuda.graph(decode, pool=steps.pool(),
                              capture_error_mode="thread_local"):
            fz.images = self._decode(fz.vae_params, fz.f_hat)
        fz.graphs = (steps, decode)
        fz.stats = {"warmup_s": t1 - t0,
                    "capture_s": time.perf_counter() - t1,
                    "pool_bytes": torch.cuda.memory_reserved(dev) - reserved}
