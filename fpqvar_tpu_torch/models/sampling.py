"""Top-k / top-p sampling and the Gumbel-softmax blend with explicit
``torch.Generator``s: one for the whole batch, or one per row (the serving
path, so that a row's draws do not depend on what it is batched with).

Nothing here synchronises the host with the device: the masks use Python
scalars, not tensors copied from the host."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

#: one generator for the whole batch, or one per row of the batch
Generators = Union[torch.Generator, Sequence[torch.Generator]]


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 0.0) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus top-p set with -inf.

    Top-k first, then top-p over the already filtered logits; ties at the
    k-th value are kept.  The same operations as the JAX package's
    ``models/sampling.py`` (one ascending sort serves both filters)."""
    v = logits.shape[-1]
    neg_inf, pos_inf = float("-inf"), float("inf")

    def _nucleus_floor(sorted_logits):
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) > (1.0 - top_p)
        keep[..., -1] = True              # never drop the argmax
        return torch.where(keep, sorted_logits, pos_inf).amin(
            dim=-1, keepdim=True)

    if top_k > 0 and top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1).values
        kth = sorted_logits[..., v - min(top_k, v), None]
        sorted_logits = torch.where(sorted_logits < kth, neg_inf,
                                    sorted_logits)
        min_kept = _nucleus_floor(sorted_logits)
        return torch.where((logits < kth) | (logits < min_kept), neg_inf,
                           logits)
    if top_k > 0:
        kth = torch.topk(logits, min(top_k, v), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p > 0.0:
        min_kept = _nucleus_floor(torch.sort(logits, dim=-1).values)
        logits = torch.where(logits < min_kept, neg_inf, logits)
    return logits


def gumbel_noise(shape, generator: Generators, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))``, U uniform in (0, 1), of
    ``shape``.  With a sequence of generators, one per row (``shape[0]`` of
    them), row ``i`` is drawn from ``generator[i]`` alone."""
    if isinstance(generator, torch.Generator) or generator is None:
        u = torch.rand(shape, generator=generator, device=device)
    else:
        gens = list(generator)
        if len(gens) != shape[0]:
            raise ValueError(f"{len(gens)} generators for {shape[0]} rows")
        u = torch.stack([torch.rand(tuple(shape[1:]), generator=g,
                                    device=device) for g in gens])
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def noise_plan(sizes: Sequence[int], vocab: int, batch: int,
               generator: Optional[Generators], more_smooth: bool, device,
               out: Optional[list] = None) -> list:
    """All of a generation's Gumbel noise, drawn up front: for each scale
    (``sizes`` holds its ``l = pn * pn`` tokens) the sample's ``(batch, l,
    vocab)`` noise, then, under ``more_smooth``, the soft blend's, as
    ``(sample, blend or None)`` pairs.  These are the eager loop's draws,
    in its order and from the same generators (one for the batch, or one
    per row), so each generator yields the same values and ends in the same
    state.  With ``out`` (a plan of the same shapes) the noise is copied
    into its buffers, which are returned."""
    plan = []
    for i, l in enumerate(sizes):
        pair = [gumbel_noise((batch, l, vocab), generator, device)
                for _ in range(2 if more_smooth else 1)]
        if out is not None:
            pair = [buf.copy_(t) for buf, t in zip(out[i], pair)]
        plan.append((pair[0], pair[1] if more_smooth else None))
    return plan


def sample_with_top_k_top_p(logits: torch.Tensor, top_k: int = 0,
                            top_p: float = 0.0,
                            generator: Optional[Generators] = None,
                            gumbel: Optional[torch.Tensor] = None):
    """Categorical sample after top-k/top-p filtering, as
    ``argmax(filtered + gumbel)`` (the construction of
    ``jax.random.categorical``).  The noise comes from ``generator`` (one,
    or one per row of ``logits``) unless ``gumbel`` is given, so that tests
    can feed the same noise to both packages.  Returns int64 indices of
    shape ``logits.shape[:-1]``."""
    filtered = top_k_top_p_filter(logits.to(torch.float32), top_k, top_p)
    if gumbel is None:
        gumbel = gumbel_noise(filtered.shape, generator, filtered.device)
    return torch.argmax(filtered + gumbel, dim=-1)


def gumbel_softmax(logits: torch.Tensor, tau: float,
                   generator: Optional[Generators] = None,
                   gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax((logits + gumbel) / tau)`` over the last axis in float32:
    the soft form (``hard=False``, as the generation calls it) of JAX's
    ``gumbel_softmax``.  The noise comes from ``generator`` (one, or one
    per row) unless ``gumbel`` is given."""
    lf = logits.to(torch.float32)
    if gumbel is None:
        gumbel = gumbel_noise(lf.shape, generator, lf.device)
    return torch.softmax((lf + gumbel) / tau, dim=-1)
