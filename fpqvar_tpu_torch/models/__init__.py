"""VAR transformer, VQVAE decoder, sampling and the generation engine."""
from typing import Tuple

import numpy as np
import torch

from fpqvar_tpu_torch.config import VARConfig
from fpqvar_tpu_torch.models.engine import VARGenerator  # noqa: F401
from fpqvar_tpu_torch.models.var import init_var_params  # noqa: F401
from fpqvar_tpu_torch.models.vqvae import init_vqvae_params  # noqa: F401


def build_vae_var(seed: int, cfg: VARConfig, device="cuda",
                  dtype=torch.float32) -> Tuple[dict, dict]:
    """Random ``(vae_params, var_params)`` on ``device``, the JAX package's
    ``build_vae_var``: the VQVAE in float32 and the VAR in ``dtype``, each
    from its own seed derived from ``seed`` (numpy's ``SeedSequence``, as
    JAX splits its key in two).  Release weights come from the converters
    of ``utils/checkpoint.py``."""
    s_vae, s_var = (int(w) for w in np.random.SeedSequence(
        seed).generate_state(2, np.uint32))
    vae_params = init_vqvae_params(cfg.vae, seed=s_vae, device=device)
    var_params = init_var_params(cfg, seed=s_var, device=device, dtype=dtype)
    return vae_params, var_params
