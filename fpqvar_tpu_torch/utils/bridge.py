"""Carry parameter trees of the JAX package over to the port.

Takes a tree as the JAX package builds it (nested dicts and lists of numpy
arrays, with quantized weights as leaves that have ``codes``, ``scales``,
``fmt``, ``shape`` and ``group_size``), or the flat ``{"a/b/0/c": array}``
dict that the JAX package's ``utils/checkpoint.save_params`` writes, and
returns the same tree of torch tensors on ``device``.

Quantized leaves.  A leaf with a ``nibble_packed`` field (in the flat npz,
a ``__packed_codes/scales/meta`` triplet) is a JAX ``PackedTensor`` (the
``packed`` backend) and becomes the port's :class:`PackedTensor`; any other
such leaf is an ``IntPack`` (the ``int8`` backend, ``__intpack_*`` in the
npz).  Both carry the five other fields, so that field is what tells them
apart.

- ``PackedTensor``: codes keep JAX's ``[..., N/2 or N, K]`` layout, which
  is already K-contiguous for the kernel's B operand; scales are
  transposed once here from JAX's ``[..., N, G]`` to ``[..., G, N]``, the
  port's layout (the kernel reads one scale row per K group).
- ``IntPack``: JAX keeps the codes transposed, ``[..., K, N]``; the port
  keeps the weight's own ``[..., N, K]`` layout (the CUDA kernel reads the
  B operand K-contiguous), so the codes are transposed once here.  Scales
  stay ``[..., G, N]``.
"""
from __future__ import annotations

import json
import re
from types import SimpleNamespace

import numpy as np
import torch

from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor

_QUANT_LEAF = re.compile(r"(.*)/__(intpack|packed)_(codes|scales|meta)$")


def _bf16(arr, keep: bool):
    """A ``__bf16`` uint16 view: widened to float32 numpy, or with
    ``keep`` a ``torch.bfloat16`` tensor of the same bits."""
    bits = np.asarray(arr).view(np.uint16)
    if keep:
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def unflatten(flat: dict, keep_bf16: bool = False) -> dict:
    """The flat dict of ``save_params`` back to a nested tree (lists from
    all-digit keys, empty containers, bfloat16 views, the codes / scales /
    meta triplets of IntPack and PackedTensor leaves).  bfloat16 leaves
    and scales are widened to float32, or with ``keep_bf16`` kept as
    ``torch.bfloat16`` tensors (``utils/checkpoint.load_params``)."""
    tree: dict = {}
    packs: dict = {}

    def insert(keys, val):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val

    for key, val in flat.items():
        m = _QUANT_LEAF.match(key)
        if m:
            packs.setdefault((m.group(1), m.group(2)), {})[m.group(3)] = val
        elif key.endswith("/__bf16"):
            insert(key[: -len("/__bf16")].split("/"), _bf16(val, keep_bf16))
        else:
            insert(key.split("/"), val)
    for (key, kind), parts in packs.items():
        meta = json.loads(bytes(np.asarray(parts["meta"])).decode())
        scales = np.asarray(parts["scales"])
        if meta.get("scales_bf16", False):
            scales = _bf16(scales, keep_bf16)
        leaf = SimpleNamespace(
            codes=parts["codes"], scales=scales, fmt=meta["fmt"],
            shape=tuple(meta["shape"]), group_size=meta["group_size"])
        if kind == "packed":
            leaf.nibble_packed = bool(meta["nibble_packed"])
        insert(key.split("/"), leaf)

    def listify(node):
        if isinstance(node, dict):
            if "__empty_list" in node:
                return []
            if "__empty_dict" in node:
                return {}
            keys = list(node)
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def _is_quant_leaf(x) -> bool:
    return all(hasattr(x, a) for a in ("codes", "scales", "fmt", "shape",
                                        "group_size"))


def _tensor(arr, device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.contiguous().to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def to_torch(tree, device="cuda"):
    """A JAX parameter tree (nested, or flat as ``save_params`` writes it)
    as the port's tree of tensors on ``device``."""
    if (isinstance(tree, dict) and any("/" in k for k in tree)
            and not any(isinstance(v, (dict, list, tuple))
                        for v in tree.values())):
        tree = unflatten(tree)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if _is_quant_leaf(node):
            meta = (node.fmt, tuple(node.shape), int(node.group_size))
            codes = np.asarray(node.codes)
            scales = node.scales            # float32, or kept bfloat16
            if not isinstance(scales, torch.Tensor):
                scales = np.asarray(scales, np.float32)
            scales = _tensor(scales, device)
            if hasattr(node, "nibble_packed"):
                return PackedTensor(
                    _tensor(codes, device),
                    scales.transpose(-1, -2).contiguous(), *meta,
                    bool(node.nibble_packed))
            return IntPack(_tensor(np.swapaxes(codes, -1, -2), device),
                           scales, *meta)
        if isinstance(node, torch.Tensor):
            return _tensor(node, device)
        arr = np.asarray(node)
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(
                np.float32)
        return _tensor(arr, device)

    return conv(tree)
