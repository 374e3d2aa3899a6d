"""fpqvar_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of fpqvar_tpu.

Low-bit floating-point quantized inference for VAR next-scale image
generators.  The JAX package ``fpqvar_tpu`` stays the reference; this
package imports nothing of it and no JAX.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.

    from fpqvar_tpu_torch.config import var_d16, bench_recipes
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.quantize import quantize_var_params
"""
