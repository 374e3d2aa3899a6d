"""Generation-quality metrics: FID, sFID, Inception Score, precision and
recall.

The JAX package's ``eval/metrics.py``, after the OpenAI guided-diffusion
evaluator (``openai_evaluator.py``):

- ``FIDStatistics.frechet_distance``: float64 host math, ``np.cov`` and
  scipy's ``sqrtm`` with the same eps fallback and imaginary-part check
  (``sqrtm`` is called without JAX's ``disp=False``, which newer SciPy
  no longer takes; the root is the same);
- ``inception_score``: split-KL in numpy (split size 5000);
- ``ManifoldEstimator``: kNN-hypersphere precision and recall (``k`` =
  3).  The squared distances run on the features' device in float32, in
  the JAX form ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0 (not
  ``torch.cdist``, which sums in another form), with TF32 off; the k-th
  neighbour radius and the membership tests run there too.

The evaluator takes feature arrays; any Inception implementation can feed
it (``eval/inception.py`` is the port's).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import linalg

from fpqvar_tpu_torch.ops.precision import ieee_f32
from fpqvar_tpu_torch.quantize.search import as_f32


@dataclass
class FIDStatistics:
    mu: np.ndarray
    sigma: np.ndarray

    @staticmethod
    def from_features(feats: np.ndarray) -> "FIDStatistics":
        return FIDStatistics(
            feats.mean(axis=0), np.cov(feats, rowvar=False))

    def frechet_distance(self, other: "FIDStatistics", eps=1e-6) -> float:
        mu1, sigma1 = self.mu, np.atleast_2d(self.sigma)
        mu2, sigma2 = other.mu, np.atleast_2d(other.sigma)
        diff = mu1 - mu2
        # JAX's sqrtm(..., disp=False)[0]: the same root (newer SciPy
        # drops ``disp``)
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            warnings.warn(
                f"fid: singular product; adding {eps} to cov diagonals")
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise ValueError(
                    f"imaginary component {np.max(np.abs(covmean.imag))}")
            covmean = covmean.real
        return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                     - 2 * np.trace(covmean))


def inception_score(probs: np.ndarray, split_size: int = 5000) -> float:
    """Split-KL inception score over class probabilities [N, classes]."""
    scores = []
    for i in range(0, len(probs), split_size):
        part = probs[i: i + split_size]
        kl = part * (np.log(part) - np.log(part.mean(axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores))


def pairwise_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [Na, Nb] of float32 rows, in JAX's form
    ``|a|^2 + |b|^2 - 2 a @ b.T``, clamped at 0, with TF32 off."""
    with ieee_f32():
        d = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
             - 2.0 * (a @ b.T))
    return torch.clamp_min(d, 0.0)


class ManifoldEstimator:
    """kNN-hypersphere manifold precision and recall
    (``openai_evaluator.py:204-359``), on ``device`` (default: the
    features' own device when they are tensors, else ``cuda``)."""

    def __init__(self, nhood_size: int = 3, row_batch: int = 10000,
                 col_batch: int = 10000, device=None):
        self.k = nhood_size
        self.row_batch = row_batch
        self.col_batch = col_batch
        self.device = device

    def _dev(self, feats):
        if self.device is not None:
            return torch.device(self.device)
        if isinstance(feats, torch.Tensor):
            return feats.device
        return torch.device("cuda")

    def manifold_radii(self, feats) -> np.ndarray:
        """Each row's squared distance to its k-th nearest neighbour,
        counting the row itself at position 0 (JAX's ``np.partition(d,
        k)[:, k]``: with coinciding rows the self-distance need not come
        first, and the rule stays as written)."""
        dev = self._dev(feats)
        f = as_f32(feats, dev)
        n = f.shape[0]
        radii = torch.empty((n,), dtype=torch.float32, device=dev)
        for b1 in range(0, n, self.row_batch):
            e1 = min(b1 + self.row_batch, n)
            drow = torch.cat([
                pairwise_dist2(f[b1:e1], f[b2:min(b2 + self.col_batch, n)])
                for b2 in range(0, n, self.col_batch)], dim=1)
            # the (k+1)-th smallest value: np.partition's value at k
            radii[b1:e1] = torch.kthvalue(drow, self.k + 1, dim=1).values
        return radii.cpu().numpy()

    def evaluate_pr(self, ref, radii_ref, sample,
                    radii_sample) -> Tuple[float, float]:
        """Returns (precision, recall): precision = the fraction of sample
        features inside any ref hypersphere; recall = vice versa."""
        dev = self._dev(ref)
        ref, sample = as_f32(ref, dev), as_f32(sample, dev)
        r_ref, r_sam = (as_f32(radii_ref, dev),
                        as_f32(radii_sample, dev))
        in_ref = torch.zeros((len(sample),), dtype=torch.bool, device=dev)
        in_sample = torch.zeros((len(ref),), dtype=torch.bool, device=dev)
        for b1 in range(0, len(ref), self.row_batch):
            e1 = min(b1 + self.row_batch, len(ref))
            for b2 in range(0, len(sample), self.col_batch):
                e2 = min(b2 + self.col_batch, len(sample))
                d = pairwise_dist2(ref[b1:e1], sample[b2:e2])
                in_sample[b1:e1] |= (d <= r_sam[None, b2:e2]).any(dim=1)
                in_ref[b2:e2] |= (d <= r_ref[b1:e1, None]).any(dim=0)
        # exact counts over exact sizes, as numpy's float64 mean of bools
        return (int(in_ref.sum()) / len(sample),
                int(in_sample.sum()) / len(ref))


def evaluate_all(
    ref_features: np.ndarray,
    sample_features: np.ndarray,
    ref_spatial: Optional[np.ndarray] = None,
    sample_spatial: Optional[np.ndarray] = None,
    sample_probs: Optional[np.ndarray] = None,
    nhood_size: int = 3,
    device="cuda",
) -> Dict[str, float]:
    """The whole suite (``openai_evaluator.py:26-59``): IS, FID, sFID,
    precision, recall; the manifold estimator on ``device``."""
    out: Dict[str, float] = {}
    if sample_probs is not None:
        out["inception_score"] = inception_score(sample_probs)
    out["fid"] = FIDStatistics.from_features(ref_features).frechet_distance(
        FIDStatistics.from_features(sample_features))
    if ref_spatial is not None and sample_spatial is not None:
        out["sfid"] = FIDStatistics.from_features(
            ref_spatial).frechet_distance(
            FIDStatistics.from_features(sample_spatial))
    est = ManifoldEstimator(nhood_size, device=device)
    radii_ref = est.manifold_radii(ref_features)
    radii_sample = est.manifold_radii(sample_features)
    prec, rec = est.evaluate_pr(
        ref_features, radii_ref, sample_features, radii_sample)
    out["precision"] = prec
    out["recall"] = rec
    return out
