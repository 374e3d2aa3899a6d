"""FP-format grid search over calibration data.

The JAX package's ``quantize/search.py``: per block and layer kind, choose
the (weight_format, activation_format) pair minimizing the matmul-output
MSE

    loss = mean((x W^T - Q_a(x) Q_w(W)^T)^2)

over the calibration activations.  Output is a JSON list with the schema
of the shipped ``optimal_quantization_formats_*.json`` files
([{"block_idx", "weight_format", "activation_format", "loss"}, ...]).
The products run in IEEE float32 (TF32 off on a card); the losses differ
from JAX's by the order of the float32 sums only.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from fpqvar_tpu_torch.ops import quantizers as Q
from fpqvar_tpu_torch.quantize.recipe import ieee_f32

#: the search space for fp4 in the JSON naming (e1m2/e2m1/e3m0), mapped
#: to the port's format names
FP4_SPACE = {"e1m2": "fp_e1", "e2m1": "fp_e2", "e3m0": "fp_e3"}
FP6_SPACE = {"e2m3": "fp6_e2m3", "e3m2": "fp6_e3m2"}


def _pair_loss(x: torch.Tensor, w: torch.Tensor, w_fmt: str, a_fmt: str,
               group_size: int, granularity: str = "per_group") -> float:
    with ieee_f32(), torch.no_grad():
        ref = x @ w.T
        qx = Q.fake_quant_fp(x, a_fmt, granularity=granularity,
                             group_size=group_size)
        qw = Q.fake_quant_fp(w, w_fmt, granularity=granularity,
                             group_size=group_size)
        return float(torch.mean((ref - qx @ qw.T) ** 2))


def _best_pair(x: torch.Tensor, w: torch.Tensor, space: Dict[str, str],
               group_size: int, granularity: str = "per_group"):
    """(weight_format_name, act_format_name, loss) of the pair with the
    least loss; the first such pair in the space's order on a tie."""
    best = (None, None, float("inf"))
    for wn, wf in space.items():
        for an, af in space.items():
            loss = _pair_loss(x, w, wf, af, group_size, granularity)
            if loss < best[2]:
                best = (wn, an, loss)
    return best


def as_f32(a, device) -> torch.Tensor:
    """``a`` (a tensor or an array) as a float32 tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32)


def search_formats_for_block(
    acts,                       # [N, C] calibration activations
    weight,                     # [out, C]
    space: Dict[str, str] = FP4_SPACE,
    group_size: int = 128,
    device="cuda",
) -> Tuple[str, str, float]:
    """Returns (weight_format_name, act_format_name, loss) in JSON naming."""
    return _best_pair(as_f32(acts, device), as_f32(weight, device), space,
                      group_size)


def search_formats(
    store,                      # CalibrationStore
    weights,                    # [depth, out, C] stacked layer weights
    kind: str,
    space: Dict[str, str] = FP4_SPACE,
    max_samples: int = 1024,
    group_size: int = 128,
    seed: int = 0,
    device="cuda",
) -> List[dict]:
    """Full per-block search for one layer kind -> JSON-ready list.  Rows
    beyond ``max_samples`` are subsampled with the JAX package's draws."""
    depth = weights.shape[0]
    rng = np.random.default_rng(seed)
    results = []
    for blk in range(depth):
        steps = store.steps(kind, blk)
        xs = [store.load(kind, blk, s).reshape(-1, weights.shape[-1])
              for s in range(steps)]
        x = np.concatenate(xs, axis=0)
        if x.shape[0] > max_samples:
            x = x[rng.choice(x.shape[0], max_samples, replace=False)]
        wn, an, loss = search_formats_for_block(
            x, weights[blk], space, group_size, device)
        results.append({"block_idx": blk, "weight_format": wn,
                        "activation_format": an, "loss": loss})
    return results


def search_ada_formats(
    cond_acts,                  # [N, C] SiLU'd class-condition activations
    ada_weights,                # [depth, 6C, C] stacked ada_lin weights
    space: Dict[str, str] = FP4_SPACE,
    granularity: str = "per_token",
    group_size: int = 128,
    device="cuda",
) -> List[dict]:
    """Format search for the AdaLN ``ada_lin`` condition input: per block,
    the (weight_format, act_format) pair minimizing the MSE of
    ``silu(cond) @ W_ada^T`` after fake quantization, per token by
    default.  The condition comes from
    :func:`fpqvar_tpu_torch.quantize.calibration.capture_condition`.
    Emits the schema of the linear-layer search."""
    x = as_f32(cond_acts, device)
    results = []
    for blk in range(ada_weights.shape[0]):
        wn, an, loss = _best_pair(x, as_f32(ada_weights[blk], device), space,
                                  group_size, granularity)
        results.append({"block_idx": blk, "weight_format": wn,
                        "activation_format": an, "loss": loss})
    return results


def save_formats_json(path: str, results: List[dict]) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=4)


def load_formats_json(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def formats_to_mixed_config(results: List[dict],
                            space: Dict[str, str] = FP4_SPACE) -> tuple:
    """JSON results -> the per-block activation-format tuple of
    ``QuantConfig.mixed_act_formats``."""
    return tuple(space[r["activation_format"]] for r in results)
