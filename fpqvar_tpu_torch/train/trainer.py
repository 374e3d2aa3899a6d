"""VAR training: loss, schedules, optimizer, train step.

The port of the JAX package's ``train/trainer.py``: the teacher-forcing
cross-entropy with label smoothing, the reference's warmup + {cos, lin*,
exp} LR annealing with cosine weight-decay annealing (``lr_wd_schedule``),
AdamW behind a global-norm clip, and one train step (label dropout, an
optional bf16 forward off float32 master params, optional per-block
rematerialization).

Where the port departs from the JAX package, and why:

- The optimizer is ``torch.optim.AdamW`` (``foreach`` on a card), which
  keeps its moments and step count itself; ``train_step`` updates the
  params in place and returns them in a new :class:`TrainState`.  AdamW
  multiplies ``p`` by ``1 - lr*wd`` before the Adam step where optax adds
  ``lr*wd*p`` to it, so the two agree in exact arithmetic only.
- Leaves that get no gradient (``mat_qkv_s`` and ``fc1_s`` when no GALT
  smoothing runs) get zeros, as JAX's ``grad`` gives them, so that the
  weight decay reaches them too (AdamW skips a parameter without a
  gradient).
- Label dropout draws from the caller's ``torch.Generator`` where JAX
  takes a key: the same rate, other masks.

Under a ``{dp, tp}`` mesh (``train_step(mesh=)``, the layout of JAX's
``scripts/train.py``) each rank holds its shards of the params
(``parallel.shard_params``) and its dp rows of the batch.  The tp splits
run through the autograd collectives of ``parallel/collectives.py``; the
gradients are averaged over dp; the clip sees the global norm (the
squares of sharded leaves summed over tp, replicated leaves counted
once); the AdamW moments live beside their shards (sharded like their
parameter, as JAX shards ``opt_state``); the loss comes back as the dp
mean.  The label-dropout mask is drawn for the whole batch and each rank
keeps its rows, so a mesh step equals the one-device step up to the order
of float32 sums.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fpqvar_tpu_torch.config import VARConfig
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.parallel import collectives as C
from fpqvar_tpu_torch.quantize.runtime import QuantRuntime


class TrainState(NamedTuple):
    params: Any                     # float32 master params (leaf tensors)
    opt_state: torch.optim.AdamW    # its moments and step count
    step: int


def cross_entropy_loss(
    logits: torch.Tensor,        # [B, L, V] f32
    targets: torch.Tensor,       # [B, L] int
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean of ``(1 - eps) * nll + eps * mean(-logp)`` over the tokens
    (``eps`` = ``label_smoothing``), as the JAX package writes it."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return nll.mean()


def lr_wd_schedule(
    sche_type: str, peak_lr: float, wd: float, wd_end: float,
    cur_it: int, wp_it: int, max_it: int,
    wp0: float = 0.005, wpe: float = 0.001,
) -> Tuple[float, float]:
    """(lr, wd) at iteration ``cur_it``: warmup from ``wp0 * peak_lr``,
    then the ``sche_type`` annealing towards ``wpe * peak_lr``; the weight
    decay anneals from ``wd`` to ``wd_end`` by a cosine."""
    wp_it = round(wp_it)
    if cur_it < wp_it:
        cur_lr = wp0 + (1 - wp0) * cur_it / wp_it
    else:
        pasd = (cur_it - wp_it) / (max_it - 1 - wp_it)
        rest = 1 - pasd
        if sche_type == "cos":
            cur_lr = wpe + (1 - wpe) * (0.5 + 0.5 * math.cos(math.pi * pasd))
        elif sche_type == "lin":
            t = 0.15
            cur_lr = 1.0 if pasd < t else wpe + (1 - wpe) * rest / (1 - t)
        elif sche_type == "lin0":
            t = 0.05
            cur_lr = 1.0 if pasd < t else wpe + (1 - wpe) * rest / (1 - t)
        elif sche_type == "lin00":
            cur_lr = wpe + (1 - wpe) * rest
        elif sche_type.startswith("lin"):
            t = float(sche_type[3:])
            max_rest = 1 - t
            wpe_mid = wpe + (1 - wpe) * max_rest
            wpe_mid = (1 + wpe_mid) / 2
            if pasd < t:
                cur_lr = 1 + (wpe_mid - 1) * pasd / t
            else:
                cur_lr = wpe + (wpe_mid - wpe) * rest / max_rest
        elif sche_type == "exp":
            t = 0.15
            if pasd < t:
                cur_lr = 1.0
            else:
                cur_lr = math.exp((pasd - t) / (1 - t) * math.log(wpe))
        else:
            raise NotImplementedError(f"unknown sche_type {sche_type}")
    lr = cur_lr * peak_lr
    pasd = cur_it / (max_it - 1)
    cur_wd = wd_end + (wd - wd_end) * (0.5 + 0.5 * math.cos(math.pi * pasd))
    return lr, cur_wd


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (counted from 0), held after."""
    alpha = end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("warmup_cosine_decay needs decay_steps > "
                         "warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def tree_leaves(tree) -> list:
    """The tensors of a params tree, in the tree's order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float, mesh=None,
                         sharded=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global norm is
    at least ``max_norm``, every gradient becomes ``(g / norm) *
    max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by ``norm +
    1e-6`` instead).  No host sync.  Returns the norm.  Under a ``mesh``,
    ``sharded[i]`` says whether ``grads[i]`` is a tp shard: those squares
    are summed over tp, the replicated ones counted once."""
    if mesh is None or mesh.tp <= 1:
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
    else:
        sq = [sum((g.square().sum() for g, s in zip(grads, sharded)
                   if s == part), torch.zeros((), device=grads[0].device))
              for part in (True, False)]
        norm = torch.sqrt(C.sum_partials(sq[0], mesh) + sq[1])
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@dataclass(frozen=True)
class Optimizer:
    """The JAX package's optax chain: ``clip_by_global_norm(grad_clip)``,
    then ``adamw(lr, b1, b2, weight_decay=wd)`` on every leaf, ``lr`` a
    constant ``peak_lr`` or ``schedule(count)`` of the updates made."""

    peak_lr: float = 1e-4
    wd: float = 0.05
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 2.0
    schedule: Optional[Callable[[int], float]] = None

    def lr(self, count: int) -> float:
        return self.schedule(count) if self.schedule is not None \
            else self.peak_lr

    def init(self, leaves: list) -> torch.optim.AdamW:
        on_card = leaves[0].is_cuda
        return torch.optim.AdamW(leaves, lr=self.lr(0),
                                 betas=(self.b1, self.b2), eps=1e-8,
                                 weight_decay=self.wd, foreach=on_card)

    def update(self, opt: torch.optim.AdamW, leaves: list,
               count: int, mesh=None, sharded=None) -> None:
        """Clip the leaves' gradients, set the learning rate of update
        ``count`` and step; the gradients are then released.  Under a
        ``mesh`` the gradients are first averaged over dp, and the clip
        takes the global norm (``sharded``: which leaves are tp
        shards)."""
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in leaves]
        if mesh is not None:
            C.dp_mean_(grads, mesh)
        clip_by_global_norm_(grads, self.grad_clip, mesh, sharded)
        for group in opt.param_groups:
            group["lr"] = self.lr(count)
        opt.step()
        opt.zero_grad(set_to_none=True)


def make_optimizer(
    peak_lr: float = 1e-4, wd: float = 0.05, b1: float = 0.9,
    b2: float = 0.95, grad_clip: float = 2.0, schedule=None,
) -> Optimizer:
    """AdamW with grad-norm clipping (upstream VAR's defaults: betas (0.9,
    0.95), clip 2.0)."""
    return Optimizer(peak_lr, wd, b1, b2, grad_clip, schedule)


def make_train_state(params, optimizer: Optimizer) -> TrainState:
    """A train state of float32 copies of ``params`` (the caller's tree
    is left as it is) at step 0."""
    master = tree_map(lambda t: t.detach().to(torch.float32, copy=True)
                      .requires_grad_(True), params)
    return TrainState(master, optimizer.init(tree_leaves(master)), 0)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def loss_fn(
    params, cfg: VARConfig, qrt, label_B, x_teacher, targets,
    generator: Optional[torch.Generator] = None,
    label_smoothing: float = 0.0, mixed_precision: bool = False,
    remat: bool = False, mesh=None,
) -> torch.Tensor:
    """Teacher-forcing cross-entropy with classifier-free-guidance label
    dropout: with a ``generator``, each label becomes ``num_classes``
    with probability ``cfg.cond_drop_rate``.  ``mixed_precision`` runs the
    forward in bf16 off the float32 params (gradients flow back to them
    in float32); the loss is reduced in float32.  ``remat`` recomputes
    each block on the backward pass.  Under a ``mesh`` the rows are this
    rank's dp share: the mask is drawn for the whole batch and the rank
    keeps its rows, and the forward runs tensor-parallel."""
    if generator is not None and cfg.cond_drop_rate > 0:
        n = label_B.shape[0]
        dp, d = (1, 0) if mesh is None else (mesh.dp, mesh.dp_rank)
        u = torch.rand((n * dp,), generator=generator,
                       device=label_B.device)[d * n:(d + 1) * n]
        label_B = torch.where(u < cfg.cond_drop_rate, cfg.num_classes,
                              label_B)
    if mesh is not None:
        qrt = dataclasses.replace(
            qrt if qrt is not None else QuantRuntime(), mesh=mesh)
    fwd = params
    if mixed_precision:
        fwd = tree_map(_bf16, params)
        x_teacher = x_teacher.to(torch.bfloat16)
    logits = V.var_forward(fwd, cfg, qrt, label_B, x_teacher, remat=remat)
    return cross_entropy_loss(logits.to(torch.float32), targets,
                              label_smoothing)


def train_step(
    state: TrainState, cfg: VARConfig, optimizer: Optimizer,
    batch: Dict[str, torch.Tensor], qrt=None,
    generator: Optional[torch.Generator] = None,
    mixed_precision: bool = False, label_smoothing: float = 0.0,
    remat: bool = False, mesh=None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step on ``batch`` = {"label": [B], "x": [B, L -
    first_l, Cvae], "targets": [B, L]}.  The params are updated in place;
    the loss comes back as a device tensor (reading it waits for the
    device).  Under a ``mesh`` (module docstring) ``state`` holds this
    rank's shards and ``batch`` its dp rows; the loss is the dp mean."""
    leaves = tree_leaves(state.params)
    loss = loss_fn(state.params, cfg, qrt, batch["label"], batch["x"],
                   batch["targets"], generator=generator,
                   label_smoothing=label_smoothing,
                   mixed_precision=mixed_precision, remat=remat, mesh=mesh)
    loss.backward()
    sharded = None
    if mesh is not None:
        from fpqvar_tpu_torch.parallel.mesh import param_specs

        sharded = [s is not None for s in tree_leaves(
            param_specs(state.params, mesh))]
    optimizer.update(state.opt_state, leaves, state.step, mesh, sharded)
    loss = loss.detach()
    if mesh is not None:
        C.dp_mean_([loss], mesh)
    return (TrainState(state.params, state.opt_state, state.step + 1),
            {"loss": loss})
