"""The port's native host library, ``models.build_vae_var`` and the
quality ladder's VQVAE draw, against the JAX package.

- ``fpqvar_tpu_torch.utils.native`` (``csrc/fpq_native.cpp``, built with
  ``g++`` into the port's build directory): every function bit-equal to
  ``fpqvar_tpu.utils.native``'s, to its own numpy fallback and to the
  port's torch counterparts (``ops/quantizers.snap_to_grid``,
  ``ops/packing.encode_to_grid`` and ``pack``, ``eval/imaging.to_uint8``),
  on every grid of ``ops/grids.py`` with ±0, ±1e30, every midpoint and
  its two float32 neighbours; the PNG writer's files byte-equal to
  ``eval/png.py``'s where Python's zlib is the library's zlib, and
  otherwise their inflated IDAT streams and decoded pixels equal.  The
  library builds here (``g++`` and ``zlib.h``) from its own source, with
  no path under ``native/``, and a failed build is not silent (``build_error`` keeps the
  compiler's message, a warning says so, the fallbacks take over).
- ``build_vae_var``: JAX's tree paths, shapes and dtypes at ``var_tiny``.
- ``tests/data/ladder_vqvae_jax_init.npz``: JAX's initial VQVAE draw of
  ``scripts/quality_ladder.py`` (``init_vqvae_params(PRNGKey(0), ...)``),
  written with JAX's ``save_params``; regenerated here and held equal to
  the committed file, and read by the port's ``load_params`` into the
  port's tree layout.  Regenerate it from the repository's root with
  ``JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
  import test_torch_native as t; t.write_ladder_vqvae()"``.
"""
import os
import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import VQVAEConfig as JVQVAEConfig
from fpqvar_tpu.models import build_vae_var as jax_build_vae_var
from fpqvar_tpu.models.vqvae import init_vqvae_params as jax_init_vqvae
from fpqvar_tpu.utils import checkpoint as JC
from fpqvar_tpu.utils import native as Jnative

from fpqvar_tpu_torch.config import VQVAEConfig, var_tiny
from fpqvar_tpu_torch.eval import imaging as Im
from fpqvar_tpu_torch.eval import png
from fpqvar_tpu_torch.models import build_vae_var
from fpqvar_tpu_torch.models.vqvae import init_vqvae_params
from fpqvar_tpu_torch.ops import _build
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quantizers as Q
from fpqvar_tpu_torch.utils import checkpoint as C
from fpqvar_tpu_torch.utils import native

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
LADDER_VQVAE = ROOT / "tests" / "data" / "ladder_vqvae_jax_init.npz"
#: scripts/quality_ladder.py:140-145's VQVAE
LADDER_PN = (1, 2, 3, 4, 6, 8)

#: every grid of ops/grids.py: the single grids and the dual grids' halves
ALL_GRIDS = {**G.GRIDS, "E1M2_NEG": G.E1M2_NEG, "E2M1_POS": G.E2M1_POS,
             "E2M1_NEG": G.E2M1_NEG, "INT_NEG": G.INT_NEG,
             "E2M3_POS": G.E2M3_POS}


def _probe(grid: np.ndarray) -> np.ndarray:
    """±0, ±1e30, the grid, its midpoints and their float32 neighbours,
    and seeded Gaussians at the grid's scale."""
    g = np.asarray(grid, np.float32)
    mids = (g[1:] + g[:-1]) / 2
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.float32([0.0, -0.0, 1e30, -1e30]), g, mids,
        np.nextafter(mids, np.float32(np.inf)),
        np.nextafter(mids, np.float32(-np.inf)),
        rng.standard_normal(2000).astype(np.float32) * np.abs(g).max(),
    ]).astype(np.float32)


@pytest.fixture
def fallback(monkeypatch):
    """The port's numpy fallbacks, as where the library cannot load."""
    monkeypatch.setattr(native, "_load", lambda: None)


def test_library_builds_here_into_the_build_dir():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.abi_version() == 2
    assert native.zlib_version()
    libs = list(_build.build_dir().glob("libfpq_native-*.so"))
    assert libs, "no library in the port's build directory"


def test_build_writes_nothing_under_native(monkeypatch, tmp_path):
    """A fresh build compiles the port's own source into the build
    directory: g++ runs outside ``native/`` and names no path there (the
    JAX package's tests may run ``make`` in ``native/`` meanwhile, so its
    files' times are not a witness)."""
    calls = []
    real = _build.subprocess.run

    def run(cmd, **kw):
        calls.append((list(cmd), kw))
        return real(cmd, **kw)

    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build, "PKG_BUILD_DIR", tmp_path / "_build")
    lib = _build.build_host("fpq_native")
    assert lib.parent == tmp_path / "_build" and lib.exists()
    assert lib.with_suffix(".log").exists()
    native_dir = str(ROOT / "native")
    assert len(calls) == 1
    cmd, kw = calls[0]
    assert "cwd" not in kw
    assert str(_build.CSRC / "fpq_native.cpp") in cmd
    assert not any(native_dir in str(a) for a in cmd)


def test_failed_build_is_not_silent(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fpq_native.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "PKG_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.warns(RuntimeWarning, match="numpy fallbacks"):
        assert not native.available()
    err = native.build_error()
    assert "fpq_native" in err and "error" in err      # g++'s own message
    assert native.zlib_version() is None
    x = np.float32([0.25, -0.25, 2.5])
    np.testing.assert_array_equal(native.snap_to_grid(x, G.FP4_E2M1),
                                  [0.5, 0.0, 3.0])
    assert native.write_png_batch(np.zeros((1, 2, 2, 3), np.uint8),
                                  [str(tmp_path / "a.png")]) is False


@pytest.mark.parametrize("name", sorted(ALL_GRIDS))
def test_snap_and_encode_bit_equal(name):
    g = ALL_GRIDS[name]
    x = _probe(g)
    snap, code = native.snap_to_grid(x, g), native.encode_to_grid(x, g)
    assert code.dtype == np.int32
    np.testing.assert_array_equal(snap, Jnative.snap_to_grid(x, g))
    np.testing.assert_array_equal(code, Jnative.encode_to_grid(x, g))
    np.testing.assert_array_equal(snap, g[code])
    np.testing.assert_array_equal(
        snap, Q.snap_to_grid(torch.from_numpy(x), g).numpy())
    np.testing.assert_array_equal(
        code, P.encode_to_grid(torch.from_numpy(x), g).numpy())
    # a 2-D input keeps its shape
    x2 = x[: x.size // 4 * 4].reshape(4, -1)
    np.testing.assert_array_equal(native.snap_to_grid(x2, g),
                                  snap[: x2.size].reshape(x2.shape))


@pytest.mark.parametrize("name", sorted(ALL_GRIDS))
def test_fallback_snap_and_encode_bit_equal(name, fallback):
    g = ALL_GRIDS[name]
    x = _probe(g)
    np.testing.assert_array_equal(native.snap_to_grid(x, g),
                                  Jnative.snap_to_grid(x, g))
    np.testing.assert_array_equal(native.encode_to_grid(x, g),
                                  Jnative.encode_to_grid(x, g))


def test_snap_ties_go_to_the_larger_value():
    out = native.snap_to_grid(np.float32([0.25, -0.25, 2.5]), G.FP4_E2M1)
    np.testing.assert_array_equal(out, [0.5, 0.0, 3.0])


@pytest.mark.parametrize("use_fallback", [False, True])
def test_pack_rows_is_the_ports_layout(use_fallback, monkeypatch):
    if use_fallback:
        monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32))
    pt = P.pack(w, "fp_e2")
    codes = P.unpack_codes(pt).numpy()
    ours = native.pack_rows(codes)
    assert ours.dtype == np.int8 and ours.shape == (128, 384)
    np.testing.assert_array_equal(ours, pt.codes.numpy())
    np.testing.assert_array_equal(ours, Jnative.pack_rows(codes))
    with pytest.raises(ValueError, match="divisible by 128"):
        native.pack_rows(codes[:64])


@pytest.mark.parametrize("use_fallback", [False, True])
def test_images_to_uint8_bit_equal(use_fallback, monkeypatch):
    if use_fallback:
        monkeypatch.setattr(native, "_load", lambda: None)
    k = np.arange(256, dtype=np.float32) / np.float32(255)
    vals = np.concatenate([k, np.nextafter(k, np.float32(2)),
                           np.nextafter(k, np.float32(-1)),
                           np.float32([-0.5, -0.0, 1.0, 1.5, 7.0])])
    rng = np.random.default_rng(3)
    imgs = rng.choice(vals, size=(3, 3, 10, 12)).astype(np.float32)
    ours = native.images_to_uint8(imgs)
    assert ours.shape == (3, 10, 12, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, Jnative.images_to_uint8(imgs))
    np.testing.assert_array_equal(ours, Im.to_uint8(torch.from_numpy(imgs)))


def _png_images():
    rng = np.random.default_rng(4)
    h, w = 40, 72
    grad = (np.outer(np.linspace(0, 1, h), np.linspace(0, 1, w))
            * 255).astype(np.uint8)
    return np.stack([
        np.stack([grad, grad[::-1], np.full((h, w), 7, np.uint8)], -1),
        rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
        np.zeros((h, w, 3), np.uint8),
    ])


def _idat(data: bytes) -> bytes:
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            out.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return zlib.decompress(b"".join(out))


def test_write_png_batch_matches_png_py(tmp_path):
    """Byte-equal files where Python's zlib is the library's; otherwise
    (deflate's output may differ between zlib versions) the same filtered
    scanlines and the same pixels."""
    imgs = _png_images()
    paths = [str(tmp_path / f"img{i}.png") for i in range(len(imgs))]
    assert native.write_png_batch(imgs, paths)
    jpaths = [str(tmp_path / f"jax{i}.png") for i in range(len(imgs))]
    assert Jnative.write_png_batch(imgs, jpaths)
    same_zlib = native.zlib_version() == zlib.ZLIB_RUNTIME_VERSION
    print(f"zlib: python {zlib.ZLIB_RUNTIME_VERSION}, library "
          f"{native.zlib_version()}")
    for img, p, jp in zip(imgs, paths, jpaths):
        with open(p, "rb") as f:
            ours = f.read()
        with open(jp, "rb") as f:
            assert f.read() == ours                 # JAX's library's bytes
        want = png.encode_png(img)
        if same_zlib:
            assert ours == want
        else:
            assert _idat(ours) == _idat(want)
        np.testing.assert_array_equal(png.decode_png(ours), img)


def test_save_images_png_goes_through_the_library(tmp_path, monkeypatch):
    """``eval/imaging`` writes through the library when it loads, and
    through ``eval/png.py`` when it does not: the same pixels either way."""
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.random((2, 3, 8, 8)).astype(np.float32))
    calls = []
    real = native.write_png_batch
    monkeypatch.setattr(native, "write_png_batch",
                        lambda a, p: calls.append(len(p)) or real(a, p))
    Im.save_images_png(images, str(tmp_path / "a"), class_id=3, start_idx=5)
    assert calls == [2]
    monkeypatch.setattr(native, "_load", lambda: None)
    Im.save_images_png(images, str(tmp_path / "b"), class_id=3, start_idx=5)
    want = Im.to_uint8(images)
    for j, name in enumerate(["class3_img5.png", "class3_img6.png"]):
        for d in ("a", "b"):
            np.testing.assert_array_equal(
                png.read_png(str(tmp_path / d / name)), want[j])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _torch_dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_vae_var_matches_jax_tree(dtype):
    from fpqvar_tpu.config import var_tiny as jax_var_tiny

    # the shapes and dtypes of JAX's trees, traced without drawing them
    jv, jr = jax.eval_shape(
        lambda key: jax_build_vae_var(key, jax_var_tiny(),
                                      dtype=getattr(jnp, dtype)),
        jax.random.PRNGKey(0))
    tv, tr = build_vae_var(0, var_tiny(), "cpu", getattr(torch, dtype))
    for jt, tt in ((jv, tv), (jr, tr)):
        jp, tp = _paths(jt), _paths(tt)
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert tuple(tp[k].shape) == tuple(jp[k].shape), k
            assert _torch_dtype_name(tp[k]) == str(jp[k].dtype), k
    # the two trees come from seeds of their own; a seed gives the same
    # trees again, another seed others
    tv2, tr2 = build_vae_var(0, var_tiny(), "cpu", getattr(torch, dtype))
    assert torch.equal(tr["head"]["w"], tr2["head"]["w"])
    assert torch.equal(tv["quantize"]["embedding"],
                       tv2["quantize"]["embedding"])
    _, tr3 = build_vae_var(1, var_tiny(), "cpu", getattr(torch, dtype))
    assert not torch.equal(tr["head"]["w"], tr3["head"]["w"])


def _ladder_vae_cfg(cls):
    return cls(vocab_size=512, z_channels=16, ch=32, ch_mult=(1, 2),
               num_res_blocks=1, patch_nums=LADDER_PN)


def jax_ladder_vqvae():
    """JAX's initial VQVAE draw of ``scripts/quality_ladder.py:149``."""
    return jax_init_vqvae(jax.random.PRNGKey(0), _ladder_vae_cfg(JVQVAEConfig))


def write_ladder_vqvae(path=LADDER_VQVAE):
    """Write :func:`jax_ladder_vqvae` with JAX's ``save_params``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    JC.save_params(str(path), jax_ladder_vqvae(), compress=True)


def test_ladder_vqvae_file_is_jax_draw():
    want = JC._flatten(jax_ladder_vqvae())
    with np.load(LADDER_VQVAE) as f:
        got = dict(f)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # the port reads it into its own tree layout
    tree = C.load_params(str(LADDER_VQVAE), "cpu")
    ours = init_vqvae_params(_ladder_vae_cfg(VQVAEConfig), seed=0,
                             device="cpu")
    tp, op = _paths(tree), _paths(ours)
    assert sorted(tp) == sorted(op)
    for k in op:
        assert tp[k].shape == op[k].shape and tp[k].dtype == op[k].dtype, k
