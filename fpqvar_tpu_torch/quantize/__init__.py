"""Quantization recipe: offline transform and online runtime."""
from fpqvar_tpu_torch.quantize.recipe import (  # noqa: F401
    quantize_var_params, synth_device_params, transform_blocks_traced)
from fpqvar_tpu_torch.quantize.runtime import (  # noqa: F401
    QuantRuntime, build_runtime)
