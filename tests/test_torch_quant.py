"""The port's quantization math against the JAX package, bit for bit.

Inputs are made with numpy from a seed and fed to both packages: the grids,
``snap_to_grid``, the integer codes of ``quant_int_codes``,
``quant_int_codes_dual`` and ``pack_int_codes`` (against JAX's functions
under ``jit``, the form in which its recipe and generation run them), the
rotation block and the offline recipe must agree exactly;
``apply_block_hadamard`` (a float matmul whose summation order differs
between the frameworks) within 1e-6.  The
last tests hold the port to importing no JAX.
"""
import ast
import dataclasses
import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import bench_recipes as jax_recipes
from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.ops import grids as JG
from fpqvar_tpu.ops import hadamard as JH
from fpqvar_tpu.ops import packing as JP
from fpqvar_tpu.ops import quantizers as JQ
from fpqvar_tpu.quantize import quantize_var_params as jax_quantize

from fpqvar_tpu_torch.config import bench_recipes, var_tiny
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import hadamard as H
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops.quantizers import snap_to_grid
from fpqvar_tpu_torch.quantize import quantize_var_params
from fpqvar_tpu_torch.utils.bridge import to_torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, group_size=128, **kw))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _act(rng, shape, fmt_grid=None):
    """Gaussian activations with planted exact midpoints and an all-zero
    group (the cases where a flipped code would show)."""
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x[..., :128] = 0.0                               # an all-zero group
    if fmt_grid is not None:
        g = np.asarray(fmt_grid, np.float32)
        mids = (g[1:] + g[:-1]) * np.float32(0.5)
        # group 1 of every row: absmax = gmax (element 0) and exact
        # grid-unit midpoints after the scale division
        x[..., 128] = g.max()
        n = min(len(mids), 127)
        x[..., 129:129 + n] = mids[:n]
    return x


def test_grids_equal():
    for name in JG.GRIDS:
        np.testing.assert_array_equal(G.GRIDS[name], JG.GRIDS[name])
        np.testing.assert_array_equal(G.grid_midpoints(name),
                                      JG.grid_midpoints(name))
    for name, (neg, pos) in JG.DUAL_GRIDS.items():
        np.testing.assert_array_equal(G.DUAL_GRIDS[name][0], neg)
        np.testing.assert_array_equal(G.DUAL_GRIDS[name][1], pos)
    assert P.CODE_MULT == JP.CODE_MULT
    assert P.DUAL_CODE_MULT == JP.DUAL_CODE_MULT


@pytest.mark.parametrize("fmt", ["fp_e1", "fp_e2", "fp_e3", "fp6_e2m3"])
def test_snap_to_grid_bit_equal(fmt):
    rng = np.random.default_rng(0)
    grid = JG.GRIDS[fmt]
    mids = (grid[1:] + grid[:-1]) * np.float32(0.5)
    x = np.concatenate([
        rng.uniform(grid.min() * 1.1, grid.max() * 1.1, 4000),
        mids, np.nextafter(mids, -np.inf), grid,
    ]).astype(np.float32)
    ours = snap_to_grid(torch.from_numpy(x), grid).numpy()
    theirs = np.asarray(JQ.snap_to_grid(jnp.asarray(x), grid))
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


@pytest.mark.parametrize("fmt", ["fp_e1", "fp_e2", "fp_e3", "fp6_e2m3"])
def test_quant_int_codes_bit_equal(fmt):
    rng = np.random.default_rng(1)
    x = _act(rng, (6, 3, 512), JG.GRIDS[fmt])
    codes, scales = P.quant_int_codes(torch.from_numpy(x), fmt, 128)
    jc, js = _jit(JP.quant_int_codes, fmt=fmt)(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(scales), _bits(js))
    assert codes.dtype == torch.int8
    assert (scales[..., 0] == 1.0 / P.CODE_MULT[fmt]).all()   # zero group


@pytest.mark.parametrize("fmt", sorted(JP.DUAL_CODE_MULT))
def test_quant_int_codes_dual_bit_equal(fmt):
    rng = np.random.default_rng(2)
    x = _act(rng, (5, 512))
    x[:, 256:384] = np.abs(x[:, 256:384])         # a group with no negatives
    x[:, 384:] = -np.abs(x[:, 384:])              # a group with no positives
    ours = P.quant_int_codes_dual(torch.from_numpy(x), fmt, 128)
    theirs = _jit(JP.quant_int_codes_dual, fmt=fmt)(jnp.asarray(x))
    for o, t in zip(ours, theirs):
        if o.dtype == torch.int8:
            np.testing.assert_array_equal(o.numpy(), np.asarray(t))
        else:
            np.testing.assert_array_equal(_bits(o), _bits(t))


def test_pack_int_codes_bit_equal():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((2, 384, 256)) * 0.02).astype(np.float32)
    ours = P.pack_int_codes(torch.from_numpy(w), "fp_e2", 128)
    theirs = _jit(JP.pack_int_codes, fmt="fp_e2")(jnp.asarray(w))
    # the port keeps codes [d, N, K]; JAX keeps them transposed [d, K, N]
    np.testing.assert_array_equal(
        ours.codes.numpy(), np.swapaxes(np.asarray(theirs.codes), -1, -2))
    np.testing.assert_array_equal(_bits(ours.scales), _bits(theirs.scales))
    assert ours.shape == theirs.shape == (384, 256)
    assert ours.group_size == theirs.group_size


def test_block_hadamard_exact():
    np.testing.assert_array_equal(H._SEED42_SIGNS_128, JH._SEED42_SIGNS_128)
    np.testing.assert_array_equal(H.block_hadamard_block(128, 42),
                                  JH.block_hadamard_block(128, 42))
    q = H.block_hadamard_block()
    np.testing.assert_allclose(q @ q.T, np.eye(128), atol=1e-12)


def test_apply_block_hadamard_close():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 384)).astype(np.float32)
    q = H.block_hadamard_block().astype(np.float32)
    ours = H.apply_block_hadamard(torch.from_numpy(x), torch.from_numpy(q))
    theirs = JH.apply_block_hadamard(jnp.asarray(x), q)
    # f32 128-term dots in another summation order: |diff| <= 1e-6
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("width", [128, 256])
def test_quantize_var_params_codes_bit_equal(width):
    """fold -> float64 rotation -> pack on bridged float params gives the
    JAX package's IntPack codes and scales exactly."""
    jcfg = dataclasses.replace(jax_var_tiny(), embed_dim=width,
                               num_heads=width // 64)
    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64)
    jparams = jax.jit(functools.partial(
        JV.init_var_params, cfg=jcfg, adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, width)))
                 .astype(np.float32) for _ in range(2))
    jq = jax_quantize(jparams, jcfg, jax_recipes()["int8"], galt=galt)
    tq = quantize_var_params(to_torch(jparams, "cpu"), cfg,
                             bench_recipes()["int8"], galt=galt)
    for key in ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w"):
        ours, theirs = tq["blocks"][key], jq["blocks"][key]
        np.testing.assert_array_equal(
            ours.codes.numpy(), np.swapaxes(np.asarray(theirs.codes), -1, -2))
        np.testing.assert_array_equal(_bits(ours.scales),
                                      _bits(theirs.scales))
    for key in ("mat_qkv_s", "fc1_s"):
        np.testing.assert_array_equal(tq["blocks"][key].numpy(),
                                      np.asarray(jq["blocks"][key]))


def _port_sources():
    pkg = REPO / "fpqvar_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "_build" not in p.relative_to(pkg).parts) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "fpqvar_tpu"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, fpqvar_tpu_torch.models, fpqvar_tpu_torch.quantize, "
            "fpqvar_tpu_torch.ops.int8_matmul, "
            "fpqvar_tpu_torch.ops.quant_matmul, fpqvar_tpu_torch.utils.bridge, "
            "fpqvar_tpu_torch.train, fpqvar_tpu_torch.tools.train, "
            "fpqvar_tpu_torch.utils.logging, fpqvar_tpu_torch.utils.checkpoint, "
            "fpqvar_tpu_torch.quantize.calibration, "
            "fpqvar_tpu_torch.quantize.search, fpqvar_tpu_torch.quantize.galt, "
            "fpqvar_tpu_torch.tools.convert_checkpoint, "
            "fpqvar_tpu_torch.tools.calibrate, "
            "fpqvar_tpu_torch.tools.search_formats, "
            "fpqvar_tpu_torch.tools.train_galt; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fpqvar_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
