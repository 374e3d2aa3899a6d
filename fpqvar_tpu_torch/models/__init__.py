"""VAR transformer, VQVAE decoder, sampling and the generation engine."""
from fpqvar_tpu_torch.models.engine import VARGenerator  # noqa: F401
from fpqvar_tpu_torch.models.var import init_var_params  # noqa: F401
from fpqvar_tpu_torch.models.vqvae import init_vqvae_params  # noqa: F401
