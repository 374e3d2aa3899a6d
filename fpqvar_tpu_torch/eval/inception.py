"""InceptionV3 feature extractor (the FID variant) as plain functions.

The JAX package's ``eval/inception.py``: the "2015" Inception that every
FID implementation uses, as a forward over a params tree in NCHW / OIHW
layouts, a converter from the PyTorch weights (``pt_inception-2015-12-05``
of pytorch-fid, whose module names match torchvision's ``inception_v3``)
and a seeded random init with the real shapes.  No weights ship with the
repository; point the converter at a downloaded ``.pth``.

The FID variant differs from stock torchvision:

- every in-block 3x3 average pool has ``count_include_pad=False``;
- Mixed_7c's pool branch is a MAX pool (the TF graph's quirk);
- the classifier has 1008 outputs (TF's padded softmax);
- taps: ``pool3`` [N, 2048] (FID, precision / recall), ``spatial`` = the
  first 7 channels of Mixed_6d's 1x1 branch, flattened (the TF graph's
  ``mixed_6/conv:0[..., :7]``, for sFID), ``probs`` [N, 1008] (IS).

Input: float images in [0, 1], NCHW, resized to 299 x 299 by a bilinear
resize that antialiases when it shrinks (what ``jax.image.resize(...,
"bilinear")`` computes: ``F.interpolate(..., antialias=True)``, so a 512 px
image gets JAX's features), then scaled to [-1, 1].

``inception_features`` runs in float32 whatever the process's TF32 flags
say: cuDNN and cuBLAS TF32 are off inside it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fpqvar_tpu_torch.ops.precision import ieee_f32

BN_EPS = 1e-3
NUM_CLASSES = 1008
SPATIAL_CHANNELS = 7
IMAGE_SIZE = 299


# ---------------------------------------------------------------------------
# Primitives (NCHW activations, OIHW conv weights)
# ---------------------------------------------------------------------------

def conv_bn(x: torch.Tensor, p: Dict, stride=1, padding=0) -> torch.Tensor:
    """Conv -> eval-mode BatchNorm(eps=1e-3) -> ReLU (torchvision's
    BasicConv2d), the BatchNorm folded into a scale and a shift in float32
    as JAX folds it."""
    y = F.conv2d(x, p["conv"].to(x.dtype), stride=stride, padding=padding)
    bn = p["bn"]
    inv = torch.rsqrt(bn["var"].to(torch.float32) + BN_EPS)
    s = bn["scale"].to(torch.float32)
    scale = (s * inv)[None, :, None, None]
    shift = (bn["bias"].to(torch.float32)
             - bn["mean"].to(torch.float32) * s * inv)[None, :, None, None]
    return torch.relu(y * scale.to(y.dtype) + shift.to(y.dtype))


def max_pool(x: torch.Tensor, window=3, stride=2, padding=0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding)


def avg_pool_nocount(x: torch.Tensor, window=3, stride=1,
                     padding=1) -> torch.Tensor:
    """3x3 average pool, ``count_include_pad=False`` (border windows
    divide by the number of real elements)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=False)


# ---------------------------------------------------------------------------
# Inception blocks (torchvision naming; FID-variant pooling)
# ---------------------------------------------------------------------------

def inception_a(x, p):
    b1 = conv_bn(x, p["branch1x1"])
    b5 = conv_bn(conv_bn(x, p["branch5x5_1"]), p["branch5x5_2"], padding=2)
    b3 = conv_bn(x, p["branch3x3dbl_1"])
    b3 = conv_bn(b3, p["branch3x3dbl_2"], padding=1)
    b3 = conv_bn(b3, p["branch3x3dbl_3"], padding=1)
    bp = conv_bn(avg_pool_nocount(x), p["branch_pool"])
    return torch.cat([b1, b5, b3, bp], dim=1)


def inception_b(x, p):
    b3 = conv_bn(x, p["branch3x3"], stride=2)
    bd = conv_bn(x, p["branch3x3dbl_1"])
    bd = conv_bn(bd, p["branch3x3dbl_2"], padding=1)
    bd = conv_bn(bd, p["branch3x3dbl_3"], stride=2)
    return torch.cat([b3, bd, max_pool(x)], dim=1)


def inception_c(x, p, tap_branch1x1=False):
    b1 = conv_bn(x, p["branch1x1"])
    b7 = conv_bn(x, p["branch7x7_1"])
    b7 = conv_bn(b7, p["branch7x7_2"], padding=(0, 3))
    b7 = conv_bn(b7, p["branch7x7_3"], padding=(3, 0))
    bd = conv_bn(x, p["branch7x7dbl_1"])
    bd = conv_bn(bd, p["branch7x7dbl_2"], padding=(3, 0))
    bd = conv_bn(bd, p["branch7x7dbl_3"], padding=(0, 3))
    bd = conv_bn(bd, p["branch7x7dbl_4"], padding=(3, 0))
    bd = conv_bn(bd, p["branch7x7dbl_5"], padding=(0, 3))
    bp = conv_bn(avg_pool_nocount(x), p["branch_pool"])
    out = torch.cat([b1, b7, bd, bp], dim=1)
    return (out, b1) if tap_branch1x1 else out


def inception_d(x, p):
    b3 = conv_bn(conv_bn(x, p["branch3x3_1"]), p["branch3x3_2"], stride=2)
    b7 = conv_bn(x, p["branch7x7x3_1"])
    b7 = conv_bn(b7, p["branch7x7x3_2"], padding=(0, 3))
    b7 = conv_bn(b7, p["branch7x7x3_3"], padding=(3, 0))
    b7 = conv_bn(b7, p["branch7x7x3_4"], stride=2)
    return torch.cat([b3, b7, max_pool(x)], dim=1)


def inception_e(x, p, pool: str):
    b1 = conv_bn(x, p["branch1x1"])
    b3 = conv_bn(x, p["branch3x3_1"])
    b3 = torch.cat([conv_bn(b3, p["branch3x3_2a"], padding=(0, 1)),
                    conv_bn(b3, p["branch3x3_2b"], padding=(1, 0))], dim=1)
    bd = conv_bn(x, p["branch3x3dbl_1"])
    bd = conv_bn(bd, p["branch3x3dbl_2"], padding=1)
    bd = torch.cat([conv_bn(bd, p["branch3x3dbl_3a"], padding=(0, 1)),
                    conv_bn(bd, p["branch3x3dbl_3b"], padding=(1, 0))], dim=1)
    if pool == "avg":
        bp = avg_pool_nocount(x)
    else:                       # Mixed_7c: MAX pool (FIDInceptionE_2 quirk)
        bp = max_pool(x, window=3, stride=1, padding=1)
    bp = conv_bn(bp, p["branch_pool"])
    return torch.cat([b1, b3, bd, bp], dim=1)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def preprocess(images: torch.Tensor, resize: bool = True) -> torch.Tensor:
    """Float images in [0, 1], NCHW -> [-1, 1] at 299 x 299 (bilinear,
    antialiased when shrinking, as ``jax.image.resize`` computes it)."""
    x = images.to(torch.float32)
    if resize and tuple(x.shape[-2:]) != (IMAGE_SIZE, IMAGE_SIZE):
        x = F.interpolate(x, size=(IMAGE_SIZE, IMAGE_SIZE), mode="bilinear",
                          align_corners=False, antialias=True)
    return x * 2.0 - 1.0


@torch.inference_mode()
def inception_features(
    params: Dict, images: torch.Tensor, resize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """images [N, 3, H, W] in [0, 1], on the params' device -> (pool3 [N,
    2048], spatial [N, 7*17*17], probs [N, 1008]), float32."""
    with ieee_f32():
        x = preprocess(images, resize)
        x = conv_bn(x, params["Conv2d_1a_3x3"], stride=2)
        x = conv_bn(x, params["Conv2d_2a_3x3"])
        x = conv_bn(x, params["Conv2d_2b_3x3"], padding=1)
        x = max_pool(x)
        x = conv_bn(x, params["Conv2d_3b_1x1"])
        x = conv_bn(x, params["Conv2d_4a_3x3"])
        x = max_pool(x)
        x = inception_a(x, params["Mixed_5b"])
        x = inception_a(x, params["Mixed_5c"])
        x = inception_a(x, params["Mixed_5d"])
        x = inception_b(x, params["Mixed_6a"])
        x = inception_c(x, params["Mixed_6b"])
        x = inception_c(x, params["Mixed_6c"])
        x, tap = inception_c(x, params["Mixed_6d"], tap_branch1x1=True)
        spatial = tap[:, :SPATIAL_CHANNELS]        # mixed_6/conv[..., :7]
        x = inception_c(x, params["Mixed_6e"])
        x = inception_d(x, params["Mixed_7a"])
        x = inception_e(x, params["Mixed_7b"], pool="avg")
        x = inception_e(x, params["Mixed_7c"], pool="max")
        pool3 = x.mean(dim=(2, 3))                 # adaptive avg -> [N, 2048]
        logits = pool3 @ params["fc"]["w"].T + params["fc"]["b"]
        probs = torch.softmax(logits, dim=-1)
    return pool3, spatial.reshape(images.shape[0], -1), probs


def extract_features_batched(params, images, batch: int = 64):
    """Host or device images [N, 3, H, W] (uint8, or float in [0, 1]) ->
    numpy (pool3, spatial, probs), ``batch`` images at a time on the
    params' device; uint8 becomes ``x / 255`` in float32 there, as JAX
    divides on the host."""
    dev = params["fc"]["w"].device
    pool3, spatial, probs = [], [], []
    for i in range(0, images.shape[0], batch):
        chunk = torch.as_tensor(images[i: i + batch]).to(dev)
        if chunk.dtype == torch.uint8:
            chunk = chunk.to(torch.float32) / 255.0
        p3, sp, pr = inception_features(params, chunk)
        pool3.append(p3.cpu().numpy())
        spatial.append(sp.cpu().numpy())
        probs.append(pr.cpu().numpy())
    return (np.concatenate(pool3), np.concatenate(spatial),
            np.concatenate(probs))


# ---------------------------------------------------------------------------
# Weight conversion + random init
# ---------------------------------------------------------------------------

_BLOCK_BRANCHES = {
    "Mixed_5b": ["branch1x1", "branch5x5_1", "branch5x5_2",
                 "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3",
                 "branch_pool"],
    "Mixed_6a": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                 "branch3x3dbl_3"],
    "Mixed_6b": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                 "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                 "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "Mixed_7a": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1",
                 "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"],
    "Mixed_7b": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
                 "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
                 "branch3x3dbl_3b", "branch_pool"],
}
_BLOCK_BRANCHES.update({
    "Mixed_5c": _BLOCK_BRANCHES["Mixed_5b"],
    "Mixed_5d": _BLOCK_BRANCHES["Mixed_5b"],
    "Mixed_6c": _BLOCK_BRANCHES["Mixed_6b"],
    "Mixed_6d": _BLOCK_BRANCHES["Mixed_6b"],
    "Mixed_6e": _BLOCK_BRANCHES["Mixed_6b"],
    "Mixed_7c": _BLOCK_BRANCHES["Mixed_7b"],
})
_STEM = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
         "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
_CONV_BN = (".conv.weight", ".bn.weight", ".bn.bias", ".bn.running_mean",
            ".bn.running_var")


def _conv_names():
    return _STEM + [f"{blk}.{br}" for blk, brs in _BLOCK_BRANCHES.items()
                    for br in brs]


def expected_inception_keys():
    """The state-dict keys the converter reads (BatchNorm's
    ``num_batches_tracked`` and torchvision's ``AuxLogits`` are not read)."""
    return [n + suf for n in _conv_names() for suf in _CONV_BN] + [
        "fc.weight", "fc.bias"]


def convert_inception_state_dict(sd: Dict, device="cuda") -> Dict:
    """torchvision / pytorch-fid ``inception_v3`` state dict (torch
    tensors or numpy arrays) -> params tree of float32 tensors on
    ``device``.  Works for the FID weights (fc of 1008) and stock
    torchvision weights (fc of 1000).  Raises ``KeyError`` naming the
    missing keys."""
    missing = [k for k in expected_inception_keys() if k not in sd]
    if missing:
        raise KeyError(f"inception state dict lacks {len(missing)} keys, "
                       f"e.g. {missing[:4]}")

    def t(key):
        v = sd[key]
        v = (v.detach() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.asarray(v)))
        return v.to(device=device, dtype=torch.float32)

    def cb(prefix):
        return {"conv": t(prefix + ".conv.weight"),
                "bn": {"scale": t(prefix + ".bn.weight"),
                       "bias": t(prefix + ".bn.bias"),
                       "mean": t(prefix + ".bn.running_mean"),
                       "var": t(prefix + ".bn.running_var")}}

    params = {name: cb(name) for name in _STEM}
    for blk, branches in _BLOCK_BRANCHES.items():
        params[blk] = {br: cb(f"{blk}.{br}") for br in branches}
    params["fc"] = {"w": t("fc.weight"), "b": t("fc.bias")}
    return params


def conv_shapes() -> Dict[str, Tuple[int, int, int, int]]:
    """(out, in, kh, kw) of every conv, by its state-dict prefix."""
    s = {}

    def add(name, o, i, k):
        kh, kw = k if isinstance(k, tuple) else (k, k)
        s[name] = (o, i, kh, kw)

    add("Conv2d_1a_3x3", 32, 3, 3)
    add("Conv2d_2a_3x3", 32, 32, 3)
    add("Conv2d_2b_3x3", 64, 32, 3)
    add("Conv2d_3b_1x1", 80, 64, 1)
    add("Conv2d_4a_3x3", 192, 80, 3)
    for blk, cin, pf in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                         ("Mixed_5d", 288, 64)):
        add(f"{blk}.branch1x1", 64, cin, 1)
        add(f"{blk}.branch5x5_1", 48, cin, 1)
        add(f"{blk}.branch5x5_2", 64, 48, 5)
        add(f"{blk}.branch3x3dbl_1", 64, cin, 1)
        add(f"{blk}.branch3x3dbl_2", 96, 64, 3)
        add(f"{blk}.branch3x3dbl_3", 96, 96, 3)
        add(f"{blk}.branch_pool", pf, cin, 1)
    add("Mixed_6a.branch3x3", 384, 288, 3)
    add("Mixed_6a.branch3x3dbl_1", 64, 288, 1)
    add("Mixed_6a.branch3x3dbl_2", 96, 64, 3)
    add("Mixed_6a.branch3x3dbl_3", 96, 96, 3)
    for blk, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160),
                    ("Mixed_6d", 160), ("Mixed_6e", 192)):
        add(f"{blk}.branch1x1", 192, 768, 1)
        add(f"{blk}.branch7x7_1", c7, 768, 1)
        add(f"{blk}.branch7x7_2", c7, c7, (1, 7))
        add(f"{blk}.branch7x7_3", 192, c7, (7, 1))
        add(f"{blk}.branch7x7dbl_1", c7, 768, 1)
        add(f"{blk}.branch7x7dbl_2", c7, c7, (7, 1))
        add(f"{blk}.branch7x7dbl_3", c7, c7, (1, 7))
        add(f"{blk}.branch7x7dbl_4", c7, c7, (7, 1))
        add(f"{blk}.branch7x7dbl_5", 192, c7, (1, 7))
        add(f"{blk}.branch_pool", 192, 768, 1)
    add("Mixed_7a.branch3x3_1", 192, 768, 1)
    add("Mixed_7a.branch3x3_2", 320, 192, 3)
    add("Mixed_7a.branch7x7x3_1", 192, 768, 1)
    add("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7))
    add("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1))
    add("Mixed_7a.branch7x7x3_4", 192, 192, 3)
    for blk, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        add(f"{blk}.branch1x1", 320, cin, 1)
        add(f"{blk}.branch3x3_1", 384, cin, 1)
        add(f"{blk}.branch3x3_2a", 384, 384, (1, 3))
        add(f"{blk}.branch3x3_2b", 384, 384, (3, 1))
        add(f"{blk}.branch3x3dbl_1", 448, cin, 1)
        add(f"{blk}.branch3x3dbl_2", 384, 448, 3)
        add(f"{blk}.branch3x3dbl_3a", 384, 384, (1, 3))
        add(f"{blk}.branch3x3dbl_3b", 384, 384, (3, 1))
        add(f"{blk}.branch_pool", 192, cin, 1)
    return s


def random_inception_state_dict(seed: int = 0,
                                num_classes: int = NUM_CLASSES) -> Dict:
    """A seeded float32 state dict with the real shapes, drawn on the CPU
    from one ``torch.Generator`` (so every device gets the same weights):
    He-init convs (``sqrt(2 / fan_in)``: the net stacks ~94 conv + ReLU
    layers, and a ``1/sqrt(fan_in)`` init decays pool3 to constant
    features), identity BatchNorm, and an fc of std ``8/45`` (logits of
    std ~3, so the softmax is not uniform and IS varies with the set), in
    JAX's order: the convs by sorted name, then fc."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    sd = {}
    for name, shp in sorted(conv_shapes().items()):
        o = shp[0]
        fan_in = shp[1] * shp[2] * shp[3]
        sd[name + ".conv.weight"] = (torch.randn(shp, generator=gen)
                                     * np.sqrt(2.0 / fan_in)).float()
        sd[name + ".bn.weight"] = torch.ones(o)
        sd[name + ".bn.bias"] = torch.zeros(o)
        sd[name + ".bn.running_mean"] = torch.zeros(o)
        sd[name + ".bn.running_var"] = torch.ones(o)
    sd["fc.weight"] = (torch.randn((num_classes, 2048), generator=gen)
                       * (8.0 / 45.0)).float()
    sd["fc.bias"] = torch.zeros(num_classes)
    return sd


def init_inception_params(seed: int = 0, device="cuda",
                          num_classes: int = NUM_CLASSES) -> Dict:
    """A random-weight network with the real shapes (smoke runs and
    relative studies; real evaluation needs converted pt_inception
    weights), the same for a seed on every device."""
    return convert_inception_state_dict(
        random_inception_state_dict(seed, num_classes), device)


def load_inception_params(path: str, device="cuda") -> Dict:
    """``'random'`` -> ``init_inception_params(0)``; else a ``.pth`` state
    dict, read as tensors only (``torch.load(weights_only=True)``) and
    converted."""
    from fpqvar_tpu_torch.utils.checkpoint import load_torch_state_dict

    if path == "random":
        return init_inception_params(0, device)
    return convert_inception_state_dict(load_torch_state_dict(path), device)
