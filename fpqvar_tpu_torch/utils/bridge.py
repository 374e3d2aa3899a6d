"""Carry parameter trees of the JAX package over to the port.

Takes a tree as the JAX package builds it (nested dicts and lists of numpy
arrays, with quantized weights as ``IntPack``-like leaves that have
``codes``, ``scales``, ``fmt``, ``shape`` and ``group_size``), or the flat
``{"a/b/0/c": array}`` dict that the JAX package's
``utils/checkpoint.save_params`` writes, and returns the same tree of
torch tensors on ``device``.

JAX keeps int8 weight codes transposed, ``[..., K, N]``; the port keeps the
weight's own ``[..., N, K]`` layout (the CUDA kernel reads the B operand
K-contiguous), so the codes are transposed once here.  Scales stay
``[..., G, N]``.
"""
from __future__ import annotations

import json
import re
from types import SimpleNamespace

import numpy as np
import torch

from fpqvar_tpu_torch.ops.packing import IntPack

_INTPACK = re.compile(r"(.*)/__intpack_(codes|scales|meta)$")


def unflatten(flat: dict) -> dict:
    """The flat dict of ``save_params`` back to a nested tree (lists from
    all-digit keys, empty containers, bfloat16 views, IntPack triplets)."""
    tree: dict = {}
    packs: dict = {}

    def insert(keys, val):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val

    for key, val in flat.items():
        m = _INTPACK.match(key)
        if m:
            packs.setdefault(m.group(1), {})[m.group(2)] = val
        elif "/__packed_" in key:
            raise NotImplementedError(
                "packed-backend leaves are not ported yet (ROADMAP: the "
                "packed recipe)")
        elif key.endswith("/__bf16"):
            arr = np.asarray(val).view(np.uint16).astype(np.uint32) << 16
            insert(key[: -len("/__bf16")].split("/"), arr.view(np.float32))
        else:
            insert(key.split("/"), val)
    for key, parts in packs.items():
        meta = json.loads(bytes(np.asarray(parts["meta"])).decode())
        scales = np.asarray(parts["scales"])
        if meta.get("scales_bf16", False):
            scales = (scales.view(np.uint16).astype(np.uint32) << 16
                      ).view(np.float32)
        insert(key.split("/"), SimpleNamespace(
            codes=parts["codes"], scales=scales, fmt=meta["fmt"],
            shape=tuple(meta["shape"]), group_size=meta["group_size"]))

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


def _is_intpack(x) -> bool:
    return all(hasattr(x, a) for a in ("codes", "scales", "fmt", "shape",
                                        "group_size"))


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
        if _is_intpack(node):
            codes = torch.from_numpy(np.array(
                np.swapaxes(np.asarray(node.codes), -1, -2), order="C"))
            scales = torch.from_numpy(np.array(node.scales, np.float32,
                                               order="C"))
            return IntPack(codes.to(device), scales.to(device), node.fmt,
                           tuple(node.shape), int(node.group_size))
        arr = np.asarray(node)
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(
                np.float32)
        return torch.from_numpy(np.array(arr, order="C")).to(device)

    return conv(tree)
