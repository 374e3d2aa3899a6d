"""The comparison that decides ``correct``.

Activation quantization to four bits makes a W4A4 network chaotic under
rounding: two sound implementations that sum in another order flip a few
codes in the first blocks, and the flips grow block by block, so that at
depth 30 their logits, and then their tokens, part ways (measured: a
teacher-forced reference agreed with 62-70% of the program's tokens,
``PERF.md``).  So the reference follows the program step by step from the
program's own state, which :class:`benchmark.program.StateTap` copies out
of the timed path for a few rows of one generation: each block's input,
the head's input and AdaLN scale and shift, and the sampled tokens.  The
run hands over those rows once the window has closed and the program is
freed; the reference (``benchmark/reference/``) makes the weights again
from the seed and draws each row's sampling noise again from the row's
generator seed.  Five numbers are compared:

- ``input_err``: the blocks' input the reference builds from the
  program's tokens (embeddings and the residual pyramid) against the
  program's, ``||ref - prog|| / ||prog||``;
- ``block_err``: for every block, the reference's block on the program's
  input against the program's output, ``||ref - prog||`` over the norm of
  the program's update ``||out - in||``; the largest over the blocks
  (the KV cache and attention are in each block, over all tokens at
  once under the mask by scale);
- ``head_mod_err``: the head's AdaLN scale and shift (a bfloat16 linear
  of the class embeddings), the reference's against the program's,
  ``||ref - prog|| / ||prog||``;
- ``token_gap``: the reference's guided logits from the program's last
  block output and AdaLN scale and shift (a last-bit difference there
  moves a logit by up to 0.02 at d30: measured, ``PERF.md``), and at
  every position how far the program's token's
  Gumbel-perturbed logit lies below the best among the tokens top-k /
  top-p keep (:func:`gaps`); the widest;
- ``image_err``: the largest absolute difference, on the [0, 1] scale,
  between the program's image and the reference's decode of the
  program's tokens.

``control=True`` puts the reference in the program's place at the
nearest lower precision (``reference/model.py``) and reads the same
numbers for it, each against the reference at the stated precision.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import weights
from benchmark.reference.model import Reference, scale_sizes

INF = float("inf")
NAMES = ("input_err", "block_err", "head_mod_err", "token_gap", "image_err")


def row_seed(base_seed: int, seed: int) -> int:
    """The sampling generator's seed of a served request: the server's
    documented pure function of ``(base_seed, seed)`` (each modulo 2^32,
    mixed by numpy's SeedSequence)."""
    words = np.random.SeedSequence(
        [base_seed & 0xFFFFFFFF, seed & 0xFFFFFFFF]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & 0x7FFFFFFFFFFFFFFF


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def noise(source, patch_nums, vocab: int, device):
    """Each sampled row's Gumbel noise per scale: ``[R, l, V]`` tensors.
    ``source`` is ``("batch", seed, B, rows)`` (one generator drew the
    whole batch's noise, scale after scale) or ``("rows", seeds)`` (one
    generator a row)."""
    out = []
    if source[0] == "batch":
        _, seed, b, rows = source
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        for _, _, l in scale_sizes(patch_nums):
            u = torch.rand((b, l, vocab), generator=g, device=device)
            out.append(_gumbel(u[rows.to(u.device)]))
        return out
    gens = []
    for s in source[1]:
        g = torch.Generator(device=device)
        g.manual_seed(s)
        gens.append(g)
    for _, _, l in scale_sizes(patch_nums):
        out.append(_gumbel(torch.stack(
            [torch.rand((l, vocab), generator=g, device=device)
             for g in gens])))
    return out


def keep_floor(z: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """The smallest logit that top-k, then top-p keep (``[..., 1]``): ties
    at the k-th value kept; then the most probable tokens whose
    probabilities before them sum below ``top_p`` (the first always)."""
    v = z.shape[-1]
    floor = z.amin(dim=-1, keepdim=True)
    keep = torch.ones_like(z, dtype=torch.bool)
    if top_k > 0:
        floor = torch.topk(z, min(top_k, v), dim=-1).values[..., -1:]
        keep = z >= floor
    if top_p > 0.0:
        zs = torch.sort(torch.where(keep, z, float("-inf")), dim=-1,
                        descending=True).values
        ps = torch.softmax(zs, dim=-1)
        n = ((torch.cumsum(ps, dim=-1) - ps) < top_p).sum(-1, keepdim=True)
        floor = torch.maximum(floor, torch.gather(zs, -1,
                                                  (n - 1).clamp_min(0)))
    return floor


def gaps(z, g, tokens, smp, margin: float) -> torch.Tensor:
    """Per position: how far ``z + g`` at ``tokens`` lies below the best
    ``z + g`` among the tokens kept by a margin (logit at least the keep
    floor plus ``margin``); 0 where it lies above; infinite where the
    token lies more than ``margin`` below the floor (a token the sampler
    masks).  Tokens within ``margin`` of the floor may fall on either side
    of it under rounding: they neither count as the best nor make a gap
    infinite."""
    floor = keep_floor(z, smp["top_k"], smp["top_p"])
    s = z + g
    best = torch.where(z >= floor + margin, s, float("-inf")).amax(dim=-1)
    zt = torch.gather(z, -1, tokens[..., None])[..., 0]
    st = torch.gather(s, -1, tokens[..., None])[..., 0]
    gap = (best - st).clamp_min(0.0)
    return torch.where(zt < floor[..., 0] - margin, INF, gap)


def first_choice(z, g, smp) -> torch.Tensor:
    """The token that logits ``z`` put first under noise ``g``."""
    floor = keep_floor(z, smp["top_k"], smp["top_p"])
    return torch.where(z >= floor, z + g, float("-inf")).argmax(dim=-1)


def _rel(a: torch.Tensor, b: torch.Tensor, base: torch.Tensor) -> float:
    den = float(base.float().norm())
    num = float((a.float() - b.float()).norm())
    return num / den if den > 0 else (0.0 if num == 0 else INF)


def judge(spec: dict, seed: int, rows: dict, device,
          control: bool = False) -> dict:
    """The compared numbers (:data:`NAMES`) of a run's checked ``rows``:
    ``labels`` ``[R]``, the program's ``tokens`` ``[R, L]`` and state
    ``X`` ``[depth + 1, 2R, L, C]`` and ``S`` ``[2R, 2C]`` (the tap's),
    ``images`` of the rows listed in
    ``image_rows`` (on the host), and ``noise`` as :func:`noise`'s
    ``source``; with ``control`` also the control's, as ``control_<name>``.
    Missing state, tokens outside the vocabulary or a row whose noise
    cannot be told make every number infinite."""
    smp, pns = spec["sampling"], spec["model"]["patch_nums"]
    margin = spec["check"]["mask_margin"]
    vocab, depth = spec["vae"]["vocab_size"], spec["model"]["depth"]
    names = NAMES + (tuple("control_" + n for n in NAMES) if control
                     else ())
    tokens, X, src = rows["tokens"], rows["X"], rows["noise"]
    if (tokens is None or X is None or rows["S"] is None
            or (src[0] == "rows" and None in src[1])
            or bool(((tokens < 0) | (tokens >= vocab)).any())):
        return dict.fromkeys(names, INF)
    labels = rows["labels"].to(device)
    tokens, X = tokens.to(device), X.to(device)
    raw = weights.make(spec, seed, device)
    ref = Reference(spec, raw)
    ctrl = Reference(spec, raw, control=True) if control else None
    st = ref.inputs(labels, tokens)
    out = {"input_err": _rel(st["x"], X[0], X[0])}
    sc = ctrl.inputs(labels, tokens) if control else None
    if control:
        out["control_input_err"] = _rel(sc["x"], st["x"], st["x"])
    blk = cblk = 0.0
    for j in range(depth):
        y = ref.block(j, X[j], st)
        upd = X[j + 1].float() - X[j].float()
        blk = max(blk, _rel(y, X[j + 1], upd))
        if control:
            cblk = max(cblk, _rel(ctrl.block(j, X[j], sc), y, upd))
        del y, upd
    out["block_err"] = blk
    S = rows["S"].to(device)
    hn = ref.head_mod(st["cond"])
    out["head_mod_err"] = _rel(hn, S, S)
    z = ref.head(X[depth], S)
    zc = None
    if control:
        hc = ctrl.head_mod(sc["cond"])
        out["control_head_mod_err"] = _rel(hc, hn, hn)
        zc = ctrl.head(X[depth], hc)
    g = noise(src, pns, vocab, device)
    gap, cgap = [], []
    for si, (_, cur, l) in enumerate(scale_sizes(pns)):
        seg = slice(cur, cur + l)
        gap.append(gaps(z[:, seg], g[si], tokens[:, seg], smp,
                        margin).amax())
        if control:
            t_c = first_choice(zc[:, seg], g[si], smp)
            cgap.append(gaps(z[:, seg], g[si], t_c, smp, margin).amax())
    out["token_gap"] = float(torch.stack(gap).amax())
    img = ref.images(st["f_hat"])
    ir = rows["image_rows"]
    out["image_err"] = (float((img[ir].cpu() - rows["images"].float())
                              .abs().amax()) if ir else 0.0)
    if control:
        out["control_block_err"] = cblk
        out["control_token_gap"] = float(torch.stack(cgap).amax())
        out["control_image_err"] = float(
            (ctrl.images(st["f_hat"]) - img).abs().amax())
    return {k: out[k] for k in names}
