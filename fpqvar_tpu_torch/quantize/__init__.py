"""Quantization recipe: offline transform and online runtime."""
from fpqvar_tpu_torch.quantize.recipe import quantize_var_params  # noqa: F401
from fpqvar_tpu_torch.quantize.runtime import (  # noqa: F401
    QuantRuntime, build_runtime)
