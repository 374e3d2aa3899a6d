"""Deterministic data sharding: eval shards and infinite batch index streams.

A copy of the JAX package's ``train/data.py`` (pure numpy; the port imports
nothing of that package).  Each process runs these generators locally:
every rank computes its own disjoint slice from the same seeds, so no
broadcast is needed.  Feed the yielded index arrays to the host-local
dataset and copy the batch to the device.

- ``eval_shard``: contiguous ``linspace`` split, uneven tails allowed.
- ``infinite_batches``: per-epoch reshuffle with seed ``epoch + seed``,
  optional tail-fill to a full batch; the ``(start_ep, start_it)`` resume
  offset applies.
- ``dist_infinite_batches``: one global per-epoch permutation, optional
  repeated augmentation and tail-fill, then a ``linspace`` split across
  ranks.

Permutations come from numpy's PCG64, so the port's index streams equal
the JAX package's.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def eval_shard(n: int, rank: int, world: int) -> np.ndarray:
    """Contiguous slice of ``range(n)`` for ``rank`` of ``world`` processes.
    Covers every index exactly once across ranks; tail ranks may get one
    fewer (reference `data_sampler.py:8-10`)."""
    seps = np.linspace(0, n, world + 1, dtype=int)
    return np.arange(seps[rank], seps[rank + 1])


def _epoch_perm(n: int, epoch: int, base_seed: int, shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    return np.random.Generator(
        np.random.PCG64(epoch + base_seed)).permutation(n)


def infinite_batches(
    dataset_len: int,
    batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    fill_last: bool = False,
    drop_last: bool = False,
    start_ep: int = 0,
    start_it: int = 0,
) -> Iterator[np.ndarray]:
    """Endless stream of index batches, reshuffled each epoch with seed
    ``epoch + seed``.  ``fill_last`` recycles head indices so the tail batch
    is full; ``drop_last`` drops it; otherwise the tail batch is short.
    Resume mid-epoch with ``(start_ep, start_it)``."""
    if drop_last:
        iters_per_ep = dataset_len // batch_size
    else:
        iters_per_ep = -(-dataset_len // batch_size)
    epoch = start_ep
    while True:
        indices = _epoch_perm(dataset_len, epoch, seed, shuffle)
        tail = iters_per_ep * batch_size - dataset_len
        if tail > 0 and fill_last:
            indices = np.concatenate([indices, indices[:tail]])
        limit = iters_per_ep * batch_size
        it = start_it if epoch == start_ep else 0
        for p in range(it * batch_size, limit, batch_size):
            yield indices[p:p + batch_size]
        epoch += 1


def dist_infinite_batches(
    world_size: int,
    rank: int,
    dataset_len: int,
    glb_batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    fill_last: bool = False,
    repeated_aug: int = 0,
    start_ep: int = 0,
    start_it: int = 0,
) -> Iterator[np.ndarray]:
    """Per-rank slice of a globally-consistent infinite batch stream: every
    epoch all ranks draw the SAME global permutation (same seed), each takes
    its ``linspace`` slice, and yields local batches of
    ``glb_batch_size // world_size``.  Under ``torch.distributed`` use
    ``world_size=get_world_size(), rank=get_rank()``."""
    if glb_batch_size % world_size != 0:
        raise ValueError(
            f"glb_batch_size {glb_batch_size} % world_size {world_size} != 0")
    batch_size = glb_batch_size // world_size
    iters_per_ep = -(-dataset_len // glb_batch_size)
    global_max_p = iters_per_ep * glb_batch_size
    epoch = start_ep
    while True:
        indices = _epoch_perm(dataset_len, epoch, seed, shuffle)
        if repeated_aug > 1:
            keep = -(-dataset_len // repeated_aug)
            indices = np.repeat(indices[:keep], repeated_aug)[:global_max_p]
        filling = global_max_p - indices.shape[0]
        if filling > 0 and fill_last:
            indices = np.concatenate([indices, indices[:filling]])
        seps = np.linspace(0, indices.shape[0], world_size + 1, dtype=int)
        local = indices[seps[rank]:seps[rank + 1]]
        it = start_it if epoch == start_ep else 0
        for p in range(it * batch_size, len(local), batch_size):
            yield local[p:p + batch_size]
        epoch += 1
