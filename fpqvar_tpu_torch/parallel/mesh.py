"""The ``{dp, tp}`` process mesh and its sharding rules, on
``torch.distributed``.

The JAX package's ``parallel/mesh.py`` lays devices out as a ``(dp, tp)``
grid and lets XLA place each leaf by a ``PartitionSpec``.  Here each rank
is one process (``torchrun``, or ``--coordinator`` in the CLIs) and keeps
only its own shards: rank ``r`` sits at ``(r // tp, r % tp)``, row-major,
as ``make_mesh`` reshapes JAX's devices.  The split of every leaf follows
JAX's specs (Megatron column / row split per block):

- ``mat_qkv_w`` ``[d, 3C, C]`` and ``fc1_w`` ``[d, 4C, C]``: the output
  dim over tp (column split), ``fc1_b`` with it;
- ``proj_w`` ``[d, C, C]`` and ``fc2_w`` ``[d, C, 4C]``: the input dim
  over tp (row split);
- the head's ``w`` ``[V, C]`` and ``b``: the vocabulary over tp;
- every other leaf replicated.

Quantized packs split as JAX's ``_pack_shardings`` decides, on the port's
layouts (``IntPack`` codes ``[d, N, K]``, ``PackedTensor`` scales ``[d,
G, N]``, both transposed to JAX's): a column split needs ``N % (128 *
tp) == 0``, a row split ``K % (group_size * tp) == 0``; a per-channel
``IntPack`` (one scale group) splits its codes on K when ``K % (128 * tp)
== 0`` and replicates its one scale row.  Where the rule fails the pack is
replicated and its GEMM runs whole.  A sharded pack keeps its global
logical ``shape`` (as JAX's arrays are global), so that the linears take
the same decision from it.

dp replicates every weight; the KV cache puts the batch over dp and the
heads over tp, as JAX's ``kv_cache_shardings`` (a rank allocates only its
share: ``VARGenerator.init_cache``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from fpqvar_tpu_torch.config import MeshConfig
from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor

#: block leaves split over tp and the dim of the depth-stacked float leaf
FLOAT_BLOCK_DIMS = {"mat_qkv_w": 1, "fc1_w": 1, "fc1_b": 1,
                    "proj_w": 2, "fc2_w": 2}
#: the head's leaves, split over the vocabulary
HEAD_DIMS = {"w": 0, "b": 0}
#: the column-split (output dim) and row-split (input dim) block linears
COL_LINEARS = ("mat_qkv_w", "fc1_w")
ROW_LINEARS = ("proj_w", "fc2_w")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(dp, tp)`` grid and the process groups of
    its tp row and dp column (None for an axis of size 1)."""

    dp: int
    tp: int
    rank: int
    tp_group: Any = None
    dp_group: Any = None
    device: Optional[torch.device] = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def make_mesh(mcfg: MeshConfig, device=None) -> Mesh:
    """The mesh of this process over the default process group, which must
    hold ``dp * tp`` ranks (``ValueError`` otherwise, as JAX's "need n
    devices").  Every rank builds every subgroup, in one order."""
    n = mcfg.num_devices
    world = dist.get_world_size() if (
        dist.is_available() and dist.is_initialized()) else 1
    if world != n:
        raise ValueError(f"a dp={mcfg.dp} x tp={mcfg.tp} mesh needs {n} "
                         f"ranks, have {world}")
    rank = dist.get_rank() if world > 1 else 0
    tp_group = dp_group = None
    if mcfg.tp > 1:
        for d in range(mcfg.dp):
            g = dist.new_group([d * mcfg.tp + t for t in range(mcfg.tp)])
            if d == rank // mcfg.tp:
                tp_group = g
    if mcfg.dp > 1:
        for t in range(mcfg.tp):
            g = dist.new_group([d * mcfg.tp + t for d in range(mcfg.dp)])
            if t == rank % mcfg.tp:
                dp_group = g
    return Mesh(mcfg.dp, mcfg.tp, rank, tp_group, dp_group,
                None if device is None else torch.device(device))


# ---------------------------------------------------------------------------
# Which leaves split
# ---------------------------------------------------------------------------

def linear_split(pack, parallel: str, tp: int) -> bool:
    """Whether a pack of a ``parallel`` ("col" or "row") linear is split
    over ``tp`` ranks (``_pack_shardings``' rule, on its global shape)."""
    if tp <= 1:
        return False
    n, k = pack.shape[-2], pack.shape[-1]
    gs = pack.group_size
    if parallel == "col":
        return n % (128 * tp) == 0
    if isinstance(pack, IntPack) and gs == k:
        return k % (128 * tp) == 0
    return k % (gs * tp) == 0


def pack_dims(key: str, pack, tp: int):
    """``(codes dim, scales dim)`` of a depth-stacked pack's split, None
    for a replicated field."""
    col = key in COL_LINEARS
    if key not in COL_LINEARS + ROW_LINEARS or not linear_split(
            pack, "col" if col else "row", tp):
        return (None, None)
    if isinstance(pack, IntPack) and not col and pack.group_size == \
            pack.shape[-1]:
        return (2, None)            # per channel: codes on K, scales whole
    return (1, 2) if col else (2, 1)


def param_specs(params, mesh: Mesh):
    """The split dim of every leaf of a params tree (full or local), None
    where replicated; a pack's is its ``(codes, scales)`` pair."""
    tp = mesh.tp

    def spec(keys, leaf):
        if isinstance(leaf, (IntPack, PackedTensor)):
            return pack_dims(keys[-1], leaf, tp)
        if tp <= 1:
            return None
        if "blocks" in keys and keys[-1] in FLOAT_BLOCK_DIMS:
            return FLOAT_BLOCK_DIMS[keys[-1]]
        if len(keys) >= 2 and keys[-2] == "head" and keys[-1] in HEAD_DIMS:
            return HEAD_DIMS[keys[-1]]
        return None

    return _map_with_keys(spec, params)


def _map_with_keys(fn, tree, keys=()):
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_keys(fn, v, keys + (i,)) for i, v in enumerate(tree)]
    return fn(keys, tree)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_tensor(t: torch.Tensor, dim, mesh: Mesh) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (a fresh contiguous
    tensor), or ``t`` itself for None."""
    if dim is None or mesh.tp <= 1:
        return t
    if t.shape[dim] % mesh.tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over tp={mesh.tp}")
    return t.chunk(mesh.tp, dim)[mesh.tp_rank].clone(
        memory_format=torch.contiguous_format)


def shard_params(params, mesh: Mesh):
    """This rank's shards of a full params tree (every rank passes the
    same tree); replicated leaves are the same tensors."""

    def local(leaf, spec):
        if isinstance(leaf, (IntPack, PackedTensor)):
            cd, sd = spec
            return dataclasses.replace(
                leaf, codes=shard_tensor(leaf.codes, cd, mesh),
                scales=shard_tensor(leaf.scales, sd, mesh))
        return shard_tensor(leaf, spec, mesh)

    return _map2(local, params, param_specs(params, mesh))


def gather_tensor(t: torch.Tensor, dim, mesh: Mesh) -> torch.Tensor:
    """The full tensor of this rank's chunk along ``dim`` (every rank of
    the tp row calls it): an all-gather over tp."""
    if dim is None or mesh.tp <= 1:
        return t
    from fpqvar_tpu_torch.parallel.collectives import _all_gather

    return _all_gather(t.detach(), dim, mesh.tp, mesh.tp_group)


def gather_params(local, mesh: Mesh):
    """The inverse of :func:`shard_params`: every rank gets the full
    tree (checkpoints write it)."""

    def full(leaf, spec):
        if isinstance(leaf, (IntPack, PackedTensor)):
            cd, sd = spec
            return dataclasses.replace(
                leaf, codes=gather_tensor(leaf.codes, cd, mesh),
                scales=gather_tensor(leaf.scales, sd, mesh))
        return gather_tensor(leaf, spec, mesh)

    return _map2(full, local, param_specs(local, mesh))
