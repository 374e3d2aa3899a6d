"""Scoring in the port against the JAX package: the metrics, the Inception
features, uint8 conversion and PNG I/O, the eval-set generator, and the
``evaluate`` and ``score`` CLIs.

- FID, sFID and IS: the same float64 host math, so within a relative 1e-9
  of JAX's on shared features.
- Precision and recall are discontinuous: a pair at a k-th neighbour's
  radius flips with one float32 ulp of its distance, and the two packages'
  GEMMs sum in other orders.  On features of small integers every
  distance is exact in float32, so the two must agree exactly, duplicate
  rows (self-distances tied with true neighbours) included; on Gaussian
  features the counts may differ by at most the pairs whose distance lies
  within the derived float32 bound ``TIE_BOUND`` of a radius, counted in
  the test.
- Inception: one seeded numpy state dict through both converters; pool3
  and spatial within 1e-4 of their largest magnitude, probs within 1e-5,
  at 16, 256 and 512 px (the 512 px case needs the antialiased resize
  that ``jax.image.resize`` computes).
- uint8: bit-equal to JAX's native conversion and its numpy fallback at
  every ``k/255`` and its float32 neighbours.
- PNG: the port's files read back bit-equal by PIL, and PIL's, the native
  encoder's and JAX's ``save_images_png``'s files read bit-equal by the
  port.
- ``generate_eval_set`` at ``var_tiny`` with ``top_k=1`` (argmax): uint8
  images at most 1 level from JAX's, the same files, and the same resume
  behaviour; under a dp 2 mesh of two gloo ranks, the same files within
  one level of the one-device set.
"""
import dataclasses
import json
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fpqvar_tpu.config import GenerateConfig as JaxGenerateConfig
from fpqvar_tpu.config import QuantConfig as JaxQuantConfig
from fpqvar_tpu.eval import imaging as JIm
from fpqvar_tpu.eval import inception as JI
from fpqvar_tpu.eval import metrics as JM
from fpqvar_tpu.eval import pipeline as JP
from fpqvar_tpu.models.engine import VARGenerator as JaxGenerator
from fpqvar_tpu.utils import native as Jnative

from fpqvar_tpu_torch.config import GenerateConfig, QuantConfig, var_tiny
from fpqvar_tpu_torch.eval import imaging as Im
from fpqvar_tpu_torch.eval import inception as I
from fpqvar_tpu_torch.eval import metrics as M
from fpqvar_tpu_torch.eval import pipeline as P
from fpqvar_tpu_torch.eval import png
from fpqvar_tpu_torch.models import VARGenerator
from fpqvar_tpu_torch.tools import evaluate, score
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_generate import _jax_float_params, _jax_vae
from torch_mesh_worker import run_cli_ranks, run_ranks
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
U = 2.0 ** -24        # float32 unit roundoff


def TIE_BOUND(a, b):
    """A bound on the float32 error of ``|a|^2 + |b|^2 - 2 a.b`` for rows
    of length D, as either package computes it (pairwise or blocked sums):
    D u (|a| + |b|)^2 per pair, doubled for the two packages."""
    d = a.shape[1]
    na = np.linalg.norm(a.astype(np.float64), axis=1)
    nb = np.linalg.norm(b.astype(np.float64), axis=1)
    return 2 * d * U * (na[:, None] + nb[None, :]) ** 2


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_fid_sfid_is_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((200, 48))
    b = 0.9 * rng.standard_normal((180, 48)) + 0.1
    sa, sb = rng.standard_normal((200, 21)), rng.standard_normal((180, 21))
    logits = rng.standard_normal((300, 10)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ours = M.FIDStatistics.from_features(a).frechet_distance(
        M.FIDStatistics.from_features(b))
    theirs = JM.FIDStatistics.from_features(a).frechet_distance(
        JM.FIDStatistics.from_features(b))
    assert ours == pytest.approx(theirs, rel=1e-9)
    out = M.evaluate_all(a.astype(np.float32), b.astype(np.float32), sa, sb,
                         probs, device="cpu")
    ref = JM.evaluate_all(a.astype(np.float32), b.astype(np.float32), sa, sb,
                          probs)
    assert list(out) == list(ref)
    for k in ("inception_score", "fid", "sfid"):
        assert out[k] == pytest.approx(ref[k], rel=1e-9), k
    assert M.inception_score(probs, split_size=100) == pytest.approx(
        JM.inception_score(probs, split_size=100), rel=1e-9)


@pytest.mark.parametrize("dups", [0, 30], ids=["distinct", "duplicate_rows"])
def test_precision_recall_exact_on_exact_distances(dups):
    """Small-integer features: every squared distance is an exact float32
    integer, so radii, precision and recall must equal JAX's exactly;
    duplicate rows tie the self-distance with a true neighbour's."""
    rng = np.random.default_rng(1)
    ref = rng.integers(-3, 4, (120, 16)).astype(np.float32)
    sam = rng.integers(-3, 4, (100, 16)).astype(np.float32)
    if dups:
        ref[-dups:] = ref[:dups]
        sam[-dups // 2:] = ref[:dups // 2]
    est, jest = M.ManifoldEstimator(device="cpu"), JM.ManifoldEstimator()
    r_ref, r_sam = est.manifold_radii(ref), est.manifold_radii(sam)
    np.testing.assert_array_equal(r_ref, jest.manifold_radii(ref))
    np.testing.assert_array_equal(r_sam, jest.manifold_radii(sam))
    assert est.evaluate_pr(ref, r_ref, sam, r_sam) == jest.evaluate_pr(
        ref, r_ref, sam, r_sam)


def test_precision_recall_within_counted_near_ties():
    rng = np.random.default_rng(2)
    ref = rng.standard_normal((150, 64)).astype(np.float32)
    sam = (rng.standard_normal((130, 64)) * 1.1).astype(np.float32)
    est, jest = M.ManifoldEstimator(device="cpu"), JM.ManifoldEstimator()
    r_ref, r_sam = est.manifold_radii(ref), est.manifold_radii(sam)
    jr_ref, jr_sam = jest.manifold_radii(ref), jest.manifold_radii(sam)
    # the radii are k-th distances: within the bound of their rows
    np.testing.assert_array_less(
        np.abs(r_ref - jr_ref), TIE_BOUND(ref, ref).max(1) + 1e-30)
    prec, rec = est.evaluate_pr(ref, r_ref, sam, r_sam)
    jprec, jrec = jest.evaluate_pr(ref, jr_ref, sam, jr_sam)
    d = ((ref.astype(np.float64)[:, None] - sam[None]) ** 2).sum(-1)
    bound = TIE_BOUND(ref, sam) + TIE_BOUND(ref, ref).max(1)[:, None]
    ties_prec = int((np.abs(d - r_ref[:, None]) <= bound).any(0).sum())
    ties_rec = int((np.abs(d - r_sam[None, :]) <= bound).any(1).sum())
    assert abs(prec - jprec) * len(sam) <= ties_prec
    assert abs(rec - jrec) * len(ref) <= ties_rec
    assert 0 < prec <= 1 and 0 < rec <= 1


def test_manifold_batches_do_not_change_results():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((90, 32)).astype(np.float32)
    g = rng.standard_normal((70, 32)).astype(np.float32)
    whole = M.ManifoldEstimator(device="cpu")
    split = M.ManifoldEstimator(row_batch=17, col_batch=23, device="cpu")
    np.testing.assert_array_equal(whole.manifold_radii(f),
                                  split.manifold_radii(f))
    r, s = whole.manifold_radii(f), whole.manifold_radii(g)
    assert whole.evaluate_pr(f, r, g, s) == split.evaluate_pr(f, r, g, s)


# ---------------------------------------------------------------------------
# Inception
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inception_pair():
    sd = {k: v.numpy() for k, v in I.random_inception_state_dict(0).items()}
    return JI.convert_inception_state_dict(sd), \
        I.convert_inception_state_dict(sd, "cpu")


@pytest.mark.parametrize("hw", [16, 256, 512])
def test_inception_features_match_jax(inception_pair, hw):
    jp, tp = inception_pair
    imgs = np.random.default_rng(hw).uniform(
        size=(2, 3, hw, hw)).astype(np.float32)
    theirs = [np.asarray(a) for a in JI._jit_inception(jp, jnp.asarray(imgs))]
    ours = [a.numpy() for a in I.inception_features(tp,
                                                    torch.from_numpy(imgs))]
    for name, o, t, tol in zip(("pool3", "spatial", "probs"), ours, theirs,
                               (None, None, 1e-5)):
        assert o.shape == t.shape and o.dtype == np.float32, name
        atol = tol if tol is not None else 1e-4 * np.abs(t).max()
        np.testing.assert_allclose(o, t, rtol=0, atol=atol, err_msg=name)


def test_extract_features_batched_uint8_matches_jax(inception_pair):
    """uint8 images, a batch that leaves a tail (JAX pads it)."""
    jp, tp = inception_pair
    imgs = np.random.default_rng(4).integers(0, 256, (3, 3, 16, 16),
                                             dtype=np.uint8)
    theirs = JI.extract_features_batched(jp, imgs, batch=2)
    ours = I.extract_features_batched(tp, imgs, batch=2)
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o, t, rtol=0, atol=1e-4 * np.abs(t).max())


def test_inception_converter_rejects_missing_keys():
    sd = I.random_inception_state_dict(0)
    del sd["Mixed_6d.branch7x7_2.bn.running_var"]
    with pytest.raises(KeyError, match="lacks 1 keys"):
        I.convert_inception_state_dict(sd, "cpu")
    with pytest.raises(KeyError):
        JI.convert_inception_state_dict({k: v.numpy() for k, v in sd.items()})


def test_init_inception_params_shapes_and_scales():
    """The seeded random net has JAX's conv shapes and tree, JAX's He
    scales, and is the same on every call (CPU draws)."""
    assert I.conv_shapes() == JI._shapes()
    sd = I.random_inception_state_dict(0)
    ours = I.init_inception_params(0, "cpu")
    theirs = JI.convert_inception_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    flat_o = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), ours))[0]
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, o), (_, t) in zip(flat_o, flat_t):
        np.testing.assert_array_equal(o, t, err_msg=str(path))
    w = ours["Mixed_7c"]["branch3x3dbl_1"]["conv"]
    assert float(w.std()) == pytest.approx(np.sqrt(2.0 / 2048), rel=0.02)
    assert float(ours["fc"]["w"].std()) == pytest.approx(8 / 45, rel=0.02)


# ---------------------------------------------------------------------------
# uint8 and PNG
# ---------------------------------------------------------------------------

def _edge_values():
    k = np.arange(256, dtype=np.float32) / np.float32(255.0)
    vals = np.concatenate([k, np.nextafter(k, np.float32(2)),
                           np.nextafter(k, np.float32(-1)),
                           np.array([-0.5, -0.0, 1.5, 2.0], np.float32)])
    n = -(-vals.size // 3 // 8) * 3 * 8
    vals = np.resize(vals, n)
    return vals.reshape(2, 3, -1, 4)


def test_to_uint8_bit_equal_to_jax(monkeypatch):
    imgs = _edge_values()
    ours = Im.to_uint8(torch.from_numpy(imgs))
    assert ours.dtype == np.uint8 and ours.shape == (2,) + imgs.shape[2:] + (3,)
    np.testing.assert_array_equal(ours, JIm.to_uint8(imgs))        # native
    monkeypatch.setattr(Jnative, "_load", lambda: None)           # numpy
    np.testing.assert_array_equal(ours, JIm.to_uint8(imgs))
    np.testing.assert_array_equal(Im.to_uint8(imgs), ours)


def _test_images():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:37, 0:29]
    grad = np.stack([(xx * 7) % 256, (yy * 5) % 256, (xx + yy) % 256], -1)
    return [rng.integers(0, 256, (37, 29, 3), dtype=np.uint8),
            grad.astype(np.uint8),
            np.full((37, 29, 3), 200, np.uint8),
            np.clip(grad + rng.integers(-3, 4, grad.shape), 0,
                    255).astype(np.uint8)]


def _filter_types(path):
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            hdr = data[pos + 8:pos + 8 + n]
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w = int.from_bytes(hdr[:4], "big")
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[hdr[9]]
    raw = zlib.decompress(idat)
    return set(raw[::w * bpp + 1])


def test_png_written_by_port_reads_bit_equal_in_pil(tmp_path):
    imgs = np.stack(_test_images())
    paths = [str(tmp_path / f"a{i}.png") for i in range(len(imgs))]
    png.write_png_batch(imgs, paths)
    for img, p in zip(imgs, paths):
        with Image.open(p) as im:
            assert im.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(png.read_png(p), img)
    # the port chooses None or Sub per row by the native encoder's cost
    assert set().union(*map(_filter_types, paths)) == {0, 1}


def _png_every_filter(img: np.ndarray) -> bytes:
    """An RGB PNG whose row y is filtered with type y % 5 (the PNG
    specification's None, Sub, Up, Average and Paeth)."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int64)
    rows = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros(w * 3, np.int64)
        left = np.concatenate([np.zeros(3, np.int64), x[y, :-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][y % 5]
        rows.append(bytes([y % 5]) + ((x[y] - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (len(data).to_bytes(4, "big") + kind + data
                + zlib.crc32(kind + data).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0,
                                                                 0])
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_written_by_pil_and_native_read_bit_equal(tmp_path):
    for i, img in enumerate(_test_images()):
        p = str(tmp_path / f"filters{i}.png")
        with open(p, "wb") as f:
            f.write(_png_every_filter(img))
        assert _filter_types(p) == {0, 1, 2, 3, 4}
        with Image.open(p) as im:
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(png.read_png(p), img)
        for mode, arr in (("RGB", img), ("RGBA", np.concatenate(
                [img, img[..., :1]], -1)), ("L", img[..., 0])):
            p = str(tmp_path / f"pil{i}{mode}.png")
            Image.fromarray(arr, mode).save(p)
            with Image.open(p) as im:
                want = np.asarray(im.convert("RGB"))
            np.testing.assert_array_equal(png.read_png(p), want)
    imgs = np.stack(_test_images())
    paths = [str(tmp_path / f"native{i}.png") for i in range(len(imgs))]
    assert Jnative.write_png_batch(imgs, paths)
    for img, p in zip(imgs, paths):
        np.testing.assert_array_equal(png.read_png(p), img)
        # the port's encoder writes the native encoder's bytes
        with open(p, "rb") as f:
            assert png.encode_png(img) == f.read()


def test_save_images_png_and_npz_match_jax(tmp_path):
    imgs = np.random.default_rng(6).uniform(
        -0.1, 1.1, (3, 3, 8, 10)).astype(np.float32)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    Im.save_images_png(torch.from_numpy(imgs), str(ours), 7, start_idx=4)
    JIm.save_images_png(imgs, str(theirs), 7, start_idx=4)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) == [
        f"class7_img{j}.png" for j in (4, 5, 6)]
    for n in names:
        np.testing.assert_array_equal(png.read_png(str(theirs / n)),
                                      png.read_png(str(ours / n)))
    npz = Im.create_npz_from_sample_folder(str(ours), expected=3)
    jnpz = JIm.create_npz_from_sample_folder(str(theirs), expected=3)
    with np.load(npz) as a, np.load(jnpz) as b:
        assert a["arr_0"].dtype == np.uint8
        np.testing.assert_array_equal(a["arr_0"], b["arr_0"])
    with pytest.raises(ValueError, match="expected 4"):
        Im.create_npz_from_sample_folder(str(ours), expected=4)


# ---------------------------------------------------------------------------
# The eval-set generator
# ---------------------------------------------------------------------------

def test_class_range_for_host_matches_jax():
    for n, hosts in ((1000, 3), (7, 2), (5, 8)):
        assert [list(P.class_range_for_host(n, h, hosts))
                for h in range(hosts)] == [
            list(JP.class_range_for_host(n, h, hosts)) for h in range(hosts)]


def _u8_folder(d):
    return {n: png.read_png(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def _assert_same_set(ours, theirs):
    """The same PNG files, each within one uint8 level (a rank decodes
    its own rows: the CPU's convolutions round differently for another
    number of rows, and a value near a level's edge can round over it)."""
    assert list(ours) == list(theirs)
    for n in ours:
        diff = np.abs(ours[n].astype(int) - theirs[n].astype(int))
        assert diff.max() <= 1, n


def test_generate_eval_set_matches_jax(tmp_path):
    """Two classes of 3 images at batch 2 (the tail sliced), ``top_k=1``
    so that no RNG enters; then resume: nothing runs again, and a deleted
    PNG makes its class run again."""
    jcfg, jp = _jax_float_params(128)
    jvae = _jax_vae()
    jgen = JaxGenerator(jcfg, JaxQuantConfig(),
                        JaxGenerateConfig(top_k=1, top_p=0.0),
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    JP.generate_eval_set(jgen, jp, jvae, str(tmp_path / "jax"),
                         num_img_per_class=3, classes=[3, 5], batch=2)
    cfg = dataclasses.replace(var_tiny(), embed_dim=128, num_heads=2)
    gen = VARGenerator(cfg, QuantConfig(), GenerateConfig(top_k=1, top_p=0.0),
                       cache_dtype=torch.float32, compute_dtype=torch.float32,
                       device="cpu")
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tvae = to_torch(jax.tree_util.tree_map(np.asarray, jvae), "cpu")
    out = str(tmp_path / "port")
    assert P.generate_eval_set(gen, tp, tvae, out, num_img_per_class=3,
                               classes=[3, 5], batch=2) == 4
    ours, theirs = _u8_folder(out), _u8_folder(str(tmp_path / "jax"))
    assert list(ours) == list(theirs) == [
        f"class{c}_img{j}.png" for c in (3, 5) for j in range(3)]
    for n in ours:
        diff = np.abs(ours[n].astype(int) - theirs[n].astype(int))
        assert diff.max() <= 1, n
    # resume: a complete set runs nothing; a missing PNG re-runs its class
    assert P.generate_eval_set(gen, tp, tvae, out, num_img_per_class=3,
                               classes=[3, 5], batch=2) == 0
    before = open(os.path.join(out, "class5_img1.png"), "rb").read()
    os.remove(os.path.join(out, "class5_img1.png"))
    assert P.generate_eval_set(gen, tp, tvae, out, num_img_per_class=3,
                               classes=[3, 5], batch=2) == 2
    assert open(os.path.join(out, "class5_img1.png"), "rb").read() == before
    # dp 2 on two gloo ranks: the same files, rank 0 writes them
    mesh_out = str(tmp_path / "dp2")
    res = run_ranks(2, dict(cfg=cfg, qcfg=QuantConfig(),
                            gen_cfg=GenerateConfig(top_k=1, top_p=0.0),
                            params=tp, vae=tvae, cases=[(
                                "set", "eval_set", dict(
                                    dp=2, tp=1, out_dir=mesh_out,
                                    num_img_per_class=3, classes=[3, 5],
                                    batch=2))]), str(tmp_path / "ranks"))
    assert [r["set"] for r in res] == [4, 4]
    _assert_same_set(_u8_folder(mesh_out), _u8_folder(out))


def test_generate_eval_set_seeds_by_class_and_position(tmp_path):
    """Sampled generation: a batch's images depend on (seed, class,
    position) alone, so one class made alone equals the same class made
    after another, and another seed gives other images."""
    cfg = var_tiny()
    from fpqvar_tpu_torch.models import init_var_params, init_vqvae_params

    p = init_var_params(cfg, seed=0, device="cpu", adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=1, device="cpu")
    gen = VARGenerator(cfg, QuantConfig(), device="cpu")
    P.generate_eval_set(gen, p, vae, str(tmp_path / "a"), 2, [1, 2], batch=2)
    P.generate_eval_set(gen, p, vae, str(tmp_path / "b"), 2, [2], batch=2)
    P.generate_eval_set(gen, p, vae, str(tmp_path / "c"), 2, [2], batch=2,
                        seed=1)
    a, b = _u8_folder(str(tmp_path / "a")), _u8_folder(str(tmp_path / "b"))
    c = _u8_folder(str(tmp_path / "c"))
    for n in b:
        np.testing.assert_array_equal(a[n], b[n])
    assert any(not np.array_equal(b[n], c[n]) for n in b)
    assert P.batch_seed(0, 2000) != P.batch_seed(1, 2000)


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", ["evaluate", "score"])
def test_cli_help(tool):
    res = subprocess.run(
        [sys.executable, "-m", f"fpqvar_tpu_torch.tools.{tool}", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout


def _jax_evaluate_args(argv):
    import evaluate as jax_evaluate

    old = sys.argv
    sys.argv = ["evaluate.py"] + argv
    try:
        return jax_evaluate.parse_args()
    finally:
        sys.argv = old


def _retarget(argv, out):
    """``argv`` with its ``--out`` replaced."""
    i = argv.index("--out")
    return argv[:i + 1] + [out] + argv[i + 2:]


def test_evaluate_cli_flags_and_tiny_run(tmp_path):
    """Every JAX flag with its default (the port adds ``--device`` and
    ``--dist-backend``); a tiny run on the CPU writes the PNGs,
    ``config.json`` with JAX's keys, and the packed npz; ``--dp 2`` on two
    gloo ranks writes the same PNGs (within one uint8 level), and two
    ``--coordinator`` processes split the classes and write the same
    files, byte for byte."""
    out = str(tmp_path / "figs")
    argv = ["--tiny", "--out", out, "--num-img-per-class", "2",
            "--classes", "0:2", "--batch", "2", "--pack-npz", "--quant",
            "--w_bit", "4", "--a_bit", "4", "--weight_quant", "per_group",
            "--act_quant", "per_group", "--activation_fp_quant",
            "--weight_fp_quant", "--backend", "int8"]
    ours = vars(evaluate.parse_args(argv + ["--device", "cpu"]))
    theirs = vars(_jax_evaluate_args(argv))
    assert set(ours) - set(theirs) == {"device", "dist_backend"}
    assert {k: ours[k] for k in theirs} == theirs
    defaults = vars(evaluate.parse_args(["--out", out]))
    jdefaults = vars(_jax_evaluate_args(["--out", out]))
    assert {k: defaults[k] for k in jdefaults} == jdefaults
    assert defaults["device"] == "cuda"
    evaluate.main(argv + ["--device", "cpu"])
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == [
        f"class{c}_img{j}.png" for c in (0, 1) for j in (0, 1)]
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert set(cfg) == {"model", "L", "width"}
    assert set(cfg["model"]) - set(theirs) == {"device", "dist_backend"}
    with np.load(out + ".npz") as d:
        assert d["arr_0"].shape == (4, 6, 6, 3)
    # --dp 2 on two gloo ranks (torchrun's environment): the same PNGs
    dp2 = str(tmp_path / "dp2")
    run_cli_ranks("fpqvar_tpu_torch.tools.evaluate",
                  _retarget(argv, dp2) + ["--device", "cpu", "--dp", "2"], 2)
    png_names = [f for f in os.listdir(out) if f.endswith(".png")]
    pngs = {n: png.read_png(os.path.join(out, n)) for n in sorted(png_names)}
    _assert_same_set({n: png.read_png(os.path.join(dp2, n))
                      for n in sorted(png_names)}, pngs)
    # two --coordinator processes split the classes: one each, byte-equal
    # to the one-process run's, packed by rank 0
    coord = str(tmp_path / "coord")
    run_cli_ranks("fpqvar_tpu_torch.tools.evaluate",
                  _retarget(argv, coord) + ["--device", "cpu"], 2,
                  coordinator=True)
    assert sorted(f for f in os.listdir(coord) if f.endswith(".png")) == \
        sorted(png_names)
    for n in png_names:
        with open(os.path.join(coord, n), "rb") as f, \
                open(os.path.join(out, n), "rb") as g:
            assert f.read() == g.read(), n
    with np.load(coord + ".npz") as d:
        assert d["arr_0"].shape == (4, 6, 6, 3)


def test_evaluate_cli_coordinator_writes_every_class(tmp_path):
    """Two ``--coordinator`` processes without ``--classes`` split all of
    the tiny config's classes once between them: every class's PNG is on
    disk, and rank 0 packs the whole set."""
    out = str(tmp_path / "all")
    n = var_tiny().num_classes
    run_cli_ranks("fpqvar_tpu_torch.tools.evaluate",
                  ["--tiny", "--device", "cpu", "--out", out,
                   "--num-img-per-class", "1", "--batch", "1",
                   "--pack-npz"], 2, coordinator=True)
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == \
        sorted(f"class{c}_img0.png" for c in range(n))
    with np.load(out + ".npz") as d:
        assert d["arr_0"].shape == (n, 6, 6, 3)


def test_score_cli_matches_jax(tmp_path):
    """Feature npz inputs: the port's JSON has JAX's keys and values
    (precision and recall on exactly computed distances); an image input
    without weights is refused."""
    rng = np.random.default_rng(7)
    ref = rng.integers(-3, 4, (60, 24)).astype(np.float32)
    sam = rng.integers(-3, 4, (50, 24)).astype(np.float32)
    probs = rng.dirichlet(np.ones(10), 50).astype(np.float32)
    np.savez(tmp_path / "ref.npz", features=ref, spatial=ref[:, :8])
    np.savez(tmp_path / "sam.npz", features=sam, spatial=sam[:, :8],
             probs=probs)
    jout = str(tmp_path / "s.json")
    ours = score.main([str(tmp_path / "ref.npz"), str(tmp_path / "sam.npz"),
                       "--json-out", jout, "--device", "cpu",
                       "--save-features", str(tmp_path / "f.npz")])
    theirs = JM.evaluate_all(ref, sam, ref[:, :8], sam[:, :8], probs)
    with open(jout) as f:
        saved = json.load(f)
    assert list(saved) == list(theirs) == list(ours)
    for k in theirs:
        assert saved[k] == pytest.approx(theirs[k], rel=1e-9), k
    with np.load(tmp_path / "f.npz") as d:
        np.testing.assert_array_equal(d["features"], sam)
        np.testing.assert_array_equal(d["probs"], probs)
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "x.png")
    with pytest.raises(SystemExit, match="--inception"):
        score.main([str(tmp_path), str(tmp_path / "sam.npz"),
                    "--device", "cpu"])


def test_score_cli_images_random_inception(tmp_path):
    """A PNG folder and an image npz through ``--inception random`` (seed
    0): the saved features equal the in-process extraction's."""
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    folder = tmp_path / "pngs"
    Im.save_uint8_png(imgs, str(folder), 0)
    np.savez(tmp_path / "ref.npz", arr_0=imgs[::-1].copy())
    feats = str(tmp_path / "f.npz")
    out = score.main([str(tmp_path / "ref.npz"), str(folder), "--inception",
                      "random", "--batch", "4", "--device", "cpu",
                      "--save-features", feats])
    assert set(out) == {"inception_score", "fid", "sfid", "precision",
                        "recall"}
    want = I.extract_features_batched(
        I.init_inception_params(0, "cpu"), imgs.transpose(0, 3, 1, 2),
        batch=4)
    with np.load(feats) as d:
        for k, w in zip(("features", "spatial", "probs"), want):
            np.testing.assert_array_equal(d[k], w)


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_tf32_flags(flags):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def test_float32_exact_restores_the_flags():
    """``ieee_f32``, the port's one TF32 pin, turns both flags off inside
    a block, nested or not, and restores each as it was."""
    from fpqvar_tpu_torch.ops.precision import ieee_f32

    prev = _tf32_flags()
    try:
        for flags in ((True, True), (False, True), (True, False),
                      (False, False)):
            _set_tf32_flags(flags)
            with ieee_f32():
                assert _tf32_flags() == (False, False)
                with ieee_f32():
                    assert _tf32_flags() == (False, False)
                assert _tf32_flags() == (False, False)
            assert _tf32_flags() == flags
    finally:
        _set_tf32_flags(prev)


def test_ieee_f32_holds_while_any_thread_is_inside():
    """The flags are process-wide: a thread that leaves its block while
    another thread is still inside one leaves TF32 off, and the last to
    leave restores the flags as they were before the first entered."""
    import threading

    from fpqvar_tpu_torch.ops.precision import ieee_f32

    prev = _tf32_flags()
    inside, release, seen = threading.Event(), threading.Event(), []

    def worker():
        with ieee_f32():
            inside.set()
            release.wait(30)
            seen.append(_tf32_flags())

    try:
        _set_tf32_flags((True, True))
        t = threading.Thread(target=worker)
        t.start()
        assert inside.wait(30)
        with ieee_f32():
            assert _tf32_flags() == (False, False)
        assert _tf32_flags() == (False, False)      # the worker is inside
        release.set()
        t.join(30)
        assert seen == [(False, False)]
        assert _tf32_flags() == (True, True)
    finally:
        release.set()
        _set_tf32_flags(prev)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0), (1, 0)])
def test_conv2d_plain_cpu_is_f_conv2d(stride, padding):
    """On CPU tensors ``conv2d_plain`` is ``F.conv2d`` bit for bit and
    leaves every backend switch as it was."""
    import torch.nn.functional as F

    from fpqvar_tpu_torch.ops.precision import conv2d_plain

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 8, 9, 9), np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 8, 3, 3), np.float32))
    b = torch.from_numpy(rng.standard_normal(4, np.float32))
    before = (torch.backends.cudnn.enabled, _tf32_flags())
    got = conv2d_plain(x, w, b, stride=stride, padding=padding)
    assert (torch.backends.cudnn.enabled, _tf32_flags()) == before
    assert torch.equal(got, F.conv2d(x, w, b, stride=stride,
                                     padding=padding))


def test_conv_route_probe_tiny_cpu(capsys):
    """The probe's rows at ``var_tiny``'s VQVAE on the CPU: both routes
    for each stage and batch, the same outputs (both are ``F.conv2d``
    here), and the VQVAE's convolution restored after it."""
    from fpqvar_tpu_torch.models import vqvae as vq
    from fpqvar_tpu_torch.ops.precision import conv2d_plain
    from fpqvar_tpu_torch.tools import conv_route_probe

    rows = conv_route_probe.main(["--tiny", "--device", "cpu",
                                  "--encode-batches", "2",
                                  "--decode-batches", "2", "--reps", "1"])
    assert [(r["stage"], r["batch"], r["route"]) for r in rows] == [
        ("encode", 2, "plain"), ("encode", 2, "cudnn"),
        ("decode", 2, "plain"), ("decode", 2, "cudnn")]
    assert all(r["max_abs_diff"] == 0.0 and r["convs"] > 0 for r in rows)
    assert vq.conv2d_plain is conv2d_plain
    assert capsys.readouterr().out.count("conv_route_probe: ") == 5
