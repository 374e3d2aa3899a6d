"""Generation engine: class labels -> images, an eager loop over the scales."""
from __future__ import annotations

from typing import Optional

import torch

from fpqvar_tpu_torch.config import GenerateConfig, QuantConfig, VARConfig
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.models import vqvae as vq
from fpqvar_tpu_torch.models.sampling import Generators
from fpqvar_tpu_torch.quantize.runtime import build_runtime


class VARGenerator:
    """One (model, recipe, sampling) configuration on one device."""

    def __init__(
        self,
        cfg: VARConfig,
        qcfg: QuantConfig,
        gen: GenerateConfig = GenerateConfig(),
        cache_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        device="cuda",
    ):
        self.cfg = cfg
        self.qcfg = qcfg
        self.gen = gen
        self.device = torch.device(device)
        self.qrt = build_runtime(qcfg, device)
        self.cache_dtype = cache_dtype
        self.compute_dtype = compute_dtype
        self.statics = V.GenStatics.all_steps(cfg)

    def init_cache(self, batch: int) -> dict:
        """The KV cache of a ``batch``-label generation (CFG doubles the
        rows): dense in ``cache_dtype``, or packed under the recipe's KV
        codec."""
        return V.init_kv_cache(self.cfg, 2 * batch, self.cache_dtype,
                               self.device, self.qrt.kv_codec)

    @torch.inference_mode()
    def generate(self, params, vae_params, label_B,
                 generator: Optional[Generators] = None,
                 return_fhat: bool = False) -> torch.Tensor:
        """Class-conditional generation -> images [B, 3, H, W] in [0, 1]
        (or the f32 ``f_hat`` [B, Cvae, pn, pn] with ``return_fhat``).
        Sampling noise comes from ``generator``: one ``torch.Generator`` for
        the batch, or a sequence of B, one per label row (JAX's ``[B, 2]``
        keys), so that a row's image depends only on its own generator.
        Generators live on the generator's device.

        Given labels already on the device, the call does not wait for the
        device: it only queues work (the first call on a device copies a
        few constants there once)."""
        cfg = self.cfg
        label_B = torch.as_tensor(label_B, dtype=torch.long,
                                  device=self.device)
        b = label_B.shape[0]
        if not (generator is None or isinstance(generator, torch.Generator)
                or len(generator) == b):
            raise ValueError(f"{len(generator)} generators for {b} labels")
        cond_BD, mod, lvl_pos, x = V.prepare_generation(params, cfg, label_B)
        x = x.to(self.compute_dtype)
        mod = mod.to(self.compute_dtype)
        lvl_pos = lvl_pos.to(self.compute_dtype)
        cache = self.init_cache(b)
        hw = cfg.patch_nums[-1]
        f_hat = torch.zeros((b, cfg.vae.z_channels, hw, hw),
                            dtype=torch.float32, device=self.device)
        vae_q = vae_params["quantize"]
        for st in self.statics:
            x, f_hat = V.scale_step(params, vae_q, cfg, self.qrt, self.gen,
                                    st, x, cond_BD, mod, lvl_pos, cache,
                                    f_hat, generator)
            if x is not None:
                x = x.to(self.compute_dtype)
        if return_fhat:
            return f_hat
        return (vq.decode(vae_params, cfg.vae, f_hat) + 1.0) * 0.5
