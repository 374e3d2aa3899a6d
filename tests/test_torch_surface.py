"""The port's public surface against the JAX package's.

- ``config.FORMATS`` and ``config.GRANULARITIES`` equal JAX's tuples;
  ``ops.grids.int_grid`` is bit-equal to JAX's at 2 to 8 bits, symmetric
  or not; ``ops.resize.upsample2x_nearest`` is ``torch.equal`` to JAX's in
  float32 and bfloat16 over leading dims; the VQVAE's ``upsample2x``
  goes through it.
- Every public top-level name of every ``fpqvar_tpu/`` module (read with
  ``ast``) is in the port's module of the same path, but the JAX-only
  names of ``JAX_ONLY``; and every script of ``scripts/`` has a twin in
  ``fpqvar_tpu_torch/tools/``, but those of ``SCRIPTS_LEFT_OUT``.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu import config as jax_config
from fpqvar_tpu.ops import grids as jax_grids
from fpqvar_tpu.ops import resize as jax_resize

from fpqvar_tpu_torch import config
from fpqvar_tpu_torch.models import vqvae
from fpqvar_tpu_torch.ops import grids, resize
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

#: public names of the JAX package that the port leaves out, by module,
#: each with why
JAX_ONLY = {
    "eval/inception.py": {"Array": "a jax.Array alias",
                          "conv2d": "a lax convolution helper; the port "
                                    "convolves with PyTorch's"},
    "models/sampling.py": {"Array": "a jax.Array alias",
                           "NEG_INF": "the port masks with -inf itself"},
    "models/var.py": {"Array": "a jax.Array alias",
                      "seg_index": "a scale's index from its token "
                                   "offset, for JAX's segmented KV cache; "
                                   "the port's steps carry it (GenStatics)"},
    "models/vqvae.py": {"Array": "a jax.Array alias"},
    "ops/packing.py": {"Array": "a jax.Array alias"},
    "ops/quantizers.py": {"Array": "a jax.Array alias"},
    "quantize/baselines.py": {"Array": "a jax.Array alias"},
    "parallel/mesh.py": {n: "an XLA sharding spec; the port splits "
                            "tensors by rank" for n in
                         ("act_sharding", "kv_cache_shardings",
                          "param_shardings", "replicated")},
}
#: JAX modules with no port module: the Pallas kernels (ported as
#: ``csrc/`` and the ``ops/`` wrappers) and XLA's compile cache
JAX_ONLY_MODULES = {"ops/pallas/__init__.py", "ops/pallas/int8_matmul.py",
                    "ops/pallas/quant_matmul.py", "utils/jit_cache.py"}
#: scripts with no port twin: XLA- or TPU-relay-specific
SCRIPTS_LEFT_OUT = {"hlo_cost_probe.py", "transfer_probe.py",
                    "bench_bisect.py", "kernel_roofline.py",
                    "block_bisect.py"}


def test_formats_and_granularities_equal_jax():
    assert config.FORMATS == jax_config.FORMATS
    assert config.GRANULARITIES == jax_config.GRANULARITIES


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n_bits", [2, 3, 4, 5, 6, 7, 8])
def test_int_grid_bit_equal_to_jax(n_bits, symmetric):
    got = grids.int_grid(n_bits, symmetric)
    want = jax_grids.int_grid(n_bits, symmetric)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 6), (2, 3, 5, 7), (1, 2, 3, 1, 4)])
def test_upsample2x_nearest_equals_jax(shape, dtype):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    got = resize.upsample2x_nearest(torch.from_numpy(x).to(
        getattr(torch, dtype)))
    want = jax_resize.upsample2x_nearest(jnp.asarray(x, dtype=dtype))
    assert tuple(got.shape) == want.shape
    assert torch.equal(got.float(), torch.from_numpy(
        np.array(want.astype(jnp.float32))))


def test_vqvae_upsample_goes_through_upsample2x_nearest(monkeypatch):
    seen = []

    def spy(x):
        seen.append(tuple(x.shape))
        return resize.upsample2x_nearest(x)

    monkeypatch.setattr(vqvae, "upsample2x_nearest", spy)
    p = {"w": torch.zeros(3, 2, 3, 3), "b": torch.zeros(3)}
    x = torch.ones(1, 2, 4, 5)
    out = vqvae.upsample2x(x, p)
    assert seen == [(1, 2, 4, 5)] and tuple(out.shape) == (1, 3, 8, 10)


def _public_names(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    pkg = ROOT / "fpqvar_tpu"
    return sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py"))


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_has_every_public_name(rel):
    port = ROOT / "fpqvar_tpu_torch" / rel
    if rel in JAX_ONLY_MODULES:
        assert not port.exists(), f"{rel} is ported: drop it from the list"
        return
    assert port.exists(), f"no port module for fpqvar_tpu/{rel}"
    missing = (_public_names(ROOT / "fpqvar_tpu" / rel)
               - _public_names(port))
    assert missing == set(JAX_ONLY.get(rel, {})), (
        f"{rel}: missing {sorted(missing)}")


def test_every_script_has_a_port_twin():
    scripts = {p.name for p in (ROOT / "scripts").glob("*.py")}
    tools = {p.name for p in (ROOT / "fpqvar_tpu_torch" / "tools").glob(
        "*.py")}
    assert scripts - tools == SCRIPTS_LEFT_OUT
