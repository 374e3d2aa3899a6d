"""The collectives of the tensor-parallel layers, as autograd functions.

JAX leaves these to XLA; here each is explicit.  Activations are
replicated over tp outside the GEMMs, so:

- ``copy_to_tp``: before a column GEMM, identity forward; backward, the
  all-reduce of the input's gradient (each rank holds only its columns'
  share of it);
- ``gather_cols``: a column GEMM's output, all-gathered along a dim over
  tp; backward, the rank's slice of the gradient;
- ``take_slice``: the rank's chunk of a replicated tensor along a dim (a
  row GEMM's K-slice, attention's heads); backward, the all-gather of the
  chunks' gradients;
- ``sum_partials``: a row GEMM's partial products, all-reduced over tp;
  backward, identity.

``linear_out`` ends every tensor-parallel linear, float or quantized, by
one rule: the bias (a column split's shard of it) added to the rank's
output, then a column split's columns gathered.

``int_sum`` adds int32 partials exactly (the per-channel row split),
``dp_mean_`` / ``gather_dp`` work over the dp axis outside autograd, and
``broadcast_flag`` shares rank 0's decision.  Only ``all_reduce``,
``all_gather`` and ``broadcast`` are used, which gloo also takes on CUDA
tensors; the backend is whatever the caller initialised.  Every function
is the identity on an axis of size 1.

``stats`` counts, per collective of this process, its calls, the bytes
of its result on this rank (an all-gather's whole output, an
all-reduce's tensor) and the host seconds inside the calls: a gloo call
returns when its data has moved, an NCCL call only queues it
(``reset_stats`` zeroes them).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: collective -> [calls, bytes, host seconds] of this process
stats = {"all_gather": [0, 0, 0.0], "all_reduce": [0, 0, 0.0],
         "broadcast": [0, 0, 0.0]}


def reset_stats() -> None:
    for v in stats.values():
        v[:] = [0, 0, 0.0]


def _count(name: str, nbytes: int, t0: float) -> None:
    s = stats[name]
    s[0] += 1
    s[1] += nbytes
    s[2] += time.perf_counter() - t0


def _all_gather(t: torch.Tensor, dim: int, size: int, group) -> torch.Tensor:
    t = t.contiguous()
    t0 = time.perf_counter()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    _count("all_gather", size * t.nbytes, t0)
    return torch.cat(parts, dim)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    all_reduce_(t, group)
    return t


def all_reduce_(t: torch.Tensor, group) -> None:
    """A sum over ``group``, in place (counted in ``stats``)."""
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    _count("all_reduce", t.nbytes, t0)


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh.tp_group), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _all_gather(x, dim, mesh.tp, mesh.tp_group)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return g.chunk(m.tp, ctx.dim)[m.tp_rank].contiguous(), None, None


class _TakeSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return x.chunk(mesh.tp, dim)[mesh.tp_rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _all_gather(g, ctx.dim, m.tp, m.tp_group), None, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.tp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh.tp <= 1 else _CopyToTp.apply(x, mesh)


def gather_cols(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    return x if mesh.tp <= 1 else _GatherCols.apply(x, dim % x.dim(), mesh)


def take_slice(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    return x if mesh.tp <= 1 else _TakeSlice.apply(x, dim % x.dim(), mesh)


def sum_partials(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh.tp <= 1 else _SumPartials.apply(x, mesh)


def linear_out(y: torch.Tensor, b, mesh, parallel: str,
               split: bool) -> torch.Tensor:
    """The whole output of a ``parallel`` ("col" or "row") linear from
    ``y``, this rank's output in the activation's dtype: this rank's
    columns where a column split is ``split``, else the whole output.  The
    bias ``b`` (None, or this rank's shard of a column split's bias) is
    added in ``y``'s dtype, then the columns are all-gathered over tp.  A
    column linear whose weight stays whole (a replicated pack) still has
    its bias split, as JAX's specs split ``fc1_b`` whatever its pack does,
    so that bias is gathered instead."""
    cols = parallel == "col"
    if b is not None:
        if cols and not split:
            b = gather_cols(b, mesh)
        y = y + b.to(y.dtype)
    return gather_cols(y, mesh) if cols and split else y


def int_sum(p: torch.Tensor, mesh) -> torch.Tensor:
    """The exact sum over tp of int32 partial products."""
    if mesh.tp <= 1:
        return p
    return _all_reduce(p.to(torch.int32), mesh.tp_group)


def dp_mean_(tensors, mesh) -> None:
    """Average each tensor over dp in place (gradients, the loss)."""
    if mesh.dp <= 1:
        return
    for t in tensors:
        all_reduce_(t, mesh.dp_group)
        t.div_(mesh.dp)


def broadcast_flag(flag: bool, device) -> bool:
    """Rank 0's ``flag`` on every rank of the default group."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], device=device)
    t0 = time.perf_counter()
    dist.broadcast(t, 0)
    _count("broadcast", t.nbytes, t0)
    return bool(t.item())


def gather_dp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The dp ranks' rows of ``x`` stacked in rank order (every rank of
    the dp column gets them)."""
    if mesh.dp <= 1:
        return x
    return _all_gather(x.detach(), 0, mesh.dp, mesh.dp_group)
