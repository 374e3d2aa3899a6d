"""GALT (GHT-Aware Learnable Transformation): training and artifact IO.

The JAX package's ``quantize/galt.py``.  Per block, a smoothing vector
``s`` in R^C (init ones) is trained with AdamW (lr 0.01, optax's weight
decay 1e-4), 50 epochs, one optimizer step per scale step per epoch, on

    mean((x W^T - Q((x*s) @ Q_h) Q((W/s) @ Q_h)^T)^2)

with straight-through estimators through Q and ``Q_h`` the block
Hadamard; the ``s`` of the best epoch is kept.  Float32 throughout, with
TF32 off on a card; the step runs eagerly.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fpqvar_tpu_torch.ops.hadamard import (apply_block_hadamard,
                                           block_hadamard_block)
from fpqvar_tpu_torch.ops.precision import ieee_f32
from fpqvar_tpu_torch.quantize.search import as_f32
from fpqvar_tpu_torch.quantize.ste import fp_quant_ste, int_sym_ste


def make_quant_ste(w_bit: int, fmt: Optional[str] = None,
                   group_size: int = 128):
    """fp4 -> e2m1 STE; fp6 -> e2m3 STE; other bit widths -> the
    symmetric INT STE."""
    if fmt is None:
        fmt = {4: "fp_e2", 6: "fp6_e2m3"}.get(w_bit)
    if fmt is None:
        return int_sym_ste(w_bit, group_size)
    return fp_quant_ste(fmt, group_size)


def quant_error(x, w, s, q_block, quant) -> torch.Tensor:
    """The output MSE of the smoothed, block-rotated, quantized product
    against ``x @ w.T``."""
    fp = x @ w.T
    xq = quant(apply_block_hadamard(x * s, q_block))
    wq = quant(apply_block_hadamard(w / s, q_block))
    return torch.mean((fp - xq @ wq.T) ** 2)


def train_galt_block(
    acts_per_step: Sequence[np.ndarray],   # list of [N, C] per scale step
    weight,                                # [out, C]
    *,
    w_bit: int = 4,
    fmt: Optional[str] = None,
    lr: float = 0.01,
    epochs: int = 50,
    group_size: int = 128,
    rotation_seed: int = 42,
    rotation_block: int = 128,
    device="cuda",
) -> Tuple[np.ndarray, float]:
    """Optimize one block's smoothing vector on ``device``; returns
    (best_s, best_loss).  An epoch's loss is the mean of its steps' losses,
    each taken before its step's update; ``best_s`` is ``s`` after the
    last update of the first epoch with the least loss (JAX's strict
    ``<``)."""
    q_block = torch.as_tensor(
        block_hadamard_block(rotation_block, rotation_seed),
        dtype=torch.float32, device=device)
    quant = make_quant_ste(w_bit, fmt, group_size)
    w = as_f32(weight, device)
    xs = [as_f32(a, device) for a in acts_per_step]
    s = torch.ones((w.shape[-1],), dtype=torch.float32, device=device,
                   requires_grad=True)
    # optax.adamw's defaults: decay 1e-4 (torch's default is 1e-2)
    opt = torch.optim.AdamW([s], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    best_loss, best_s = float("inf"), s.detach().clone()
    with ieee_f32():
        for _ in range(epochs):
            losses = []
            for x in xs:
                opt.zero_grad(set_to_none=True)
                loss = quant_error(x, w, s, q_block, quant)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            # JAX's float sum of the step losses, in order (one device
            # read per epoch)
            epoch_loss = 0.0
            for v in torch.stack(losses).tolist():
                epoch_loss += v
            epoch_loss /= len(xs)
            if epoch_loss < best_loss:
                best_loss, best_s = epoch_loss, s.detach().clone()
    return best_s.cpu().numpy(), best_loss


def train_galt(
    store,                      # CalibrationStore
    weights,                    # [depth, out, C]
    kind: str,                  # "mat_qkv" or "fc1"
    *,
    w_bit: int = 4,
    max_samples_per_step: int = 256,
    seed: int = 0,
    **kw,
) -> np.ndarray:
    """Train all blocks -> ``[depth, C]`` best_s stack.  A step's rows
    beyond ``max_samples_per_step`` are subsampled with the JAX package's
    draws (per block, then per step)."""
    depth, _, c = weights.shape
    rng = np.random.default_rng(seed)
    out = []
    for blk in range(depth):
        acts = []
        for st in range(store.steps(kind, blk)):
            a = store.load(kind, blk, st).reshape(-1, c)
            if a.shape[0] > max_samples_per_step:
                a = a[rng.choice(a.shape[0], max_samples_per_step,
                                 replace=False)]
            acts.append(a)
        s, _ = train_galt_block(acts, weights[blk], w_bit=w_bit, **kw)
        out.append(s)
    return np.stack(out)


# ---------------------------------------------------------------------------
# Artifact IO, including the reference's shipped .pt tensors
# ---------------------------------------------------------------------------

def load_reference_best_s(path: str) -> np.ndarray:
    """A reference best_s ``.pt`` (a list of depth ``[C]`` tensors, as
    shipped under ``best_lambda_var{30,36}/``) -> ``[depth, C]``."""
    tensors = torch.load(path, map_location="cpu", weights_only=True)
    return np.stack([t.detach().to(torch.float32).numpy() for t in tensors])


def save_best_s(path: str, s: np.ndarray) -> None:
    np.savez_compressed(path, best_s=s)


def load_best_s(path: str) -> np.ndarray:
    with np.load(path) as f:
        return f["best_s"]


def load_best_s_pair(best_s_dir: str, bit: int):
    """The (mat_qkv, fc1) best_s pair of a directory, preferring the npz
    artifacts over the reference's ``.pt``; raises ``FileNotFoundError``
    with the candidate paths when one kind is missing."""
    out = []
    for kind in ("mat_qkv", "fc1"):
        candidates = [
            (os.path.join(best_s_dir, f"{kind}_best_s_fp{bit}.npz"),
             load_best_s),
            (os.path.join(best_s_dir, f"{kind}_best_s_fp{bit}.pt"),
             load_reference_best_s),
        ]
        for path, loader in candidates:
            if os.path.exists(path):
                out.append(loader(path))
                break
        else:
            raise FileNotFoundError(
                f"no {kind} best_s artifact; looked for "
                + " , ".join(p for p, _ in candidates))
    return tuple(out)
