"""The class-conditional eval-set generator (the 50k-image protocol).

The JAX package's ``eval/pipeline.py``, replacing the reference's eager
eval loop (``evaluate_fp_quant_transform_rotate.py:187-207``): classes x
``num_img_per_class`` images, PNGs on disk as the resume checkpoint (a
class whose files all exist is skipped; a partial class runs again), and
classes partitioned across hosts.

Seeds.  Where JAX folds ``PRNGKey(seed)`` with ``ci * 1000 + produced``,
each batch here draws its sampling noise from one ``torch.Generator`` on
the generator's device, seeded with ``batch_seed(seed, ci * 1000 +
produced)``: the first 32-bit word of numpy's ``SeedSequence([seed, ci *
1000 + produced])``.  A batch's images therefore depend only on (seed,
class, position), as in JAX, so a resumed class gives the same PNGs.

The loop keeps JAX's depth-2 pipeline: batch n's images are converted to
uint8 on the device and copied to pinned host memory behind an event,
batch n + 1 is dispatched, and only then is batch n waited for and its
PNGs encoded, so the encoding overlaps the card's work.

Under a ``{dp, tp}`` mesh (the generator's, ``VARGenerator(mesh=)``) every
rank runs the same loop: batches are rounded to a multiple of dp, as in
JAX, each generation's images are gathered over dp, rank 0 alone writes
the PNGs, and rank 0's resume decision (a class complete on disk) is
broadcast so that the ranks run the same generations.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fpqvar_tpu_torch.eval.imaging import png_paths, save_uint8_png
from fpqvar_tpu_torch.parallel import collectives as C
from fpqvar_tpu_torch.eval.imaging import to_uint8_device


def class_range_for_host(num_classes: int, host_id: int,
                         num_hosts: int) -> range:
    per = -(-num_classes // num_hosts)
    return range(host_id * per, min((host_id + 1) * per, num_classes))


def batch_seed(seed: int, position: int) -> int:
    """The generator seed of the batch that starts at ``position`` (=
    ``class * 1000 + images already made``) under ``seed``."""
    return int(np.random.SeedSequence([seed, position]).generate_state(1)[0])


def class_complete(out_dir: str, class_id: int, n: int) -> bool:
    return all(os.path.exists(p) for p in png_paths(out_dir, class_id, 0, n))


class _Pending:
    """One batch on its way to the host: uint8 images copied behind an
    event (pinned memory on a card, so the copy does not wait for later
    work)."""

    def __init__(self, imgs: torch.Tensor, class_id: int, start: int,
                 keep: int):
        u8 = to_uint8_device(imgs[:keep])
        if u8.is_cuda:
            self.host = torch.empty(u8.shape, dtype=torch.uint8,
                                    pin_memory=True)
            self.host.copy_(u8, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = u8, None
        self.class_id, self.start = class_id, start

    def flush(self, out_dir: str) -> None:
        if self.event is not None:
            self.event.synchronize()
        save_uint8_png(self.host.numpy(), out_dir, self.class_id,
                       self.start)


def generate_eval_set(
    generator,                  # VARGenerator
    params,
    vae_params,
    out_dir: str,
    num_img_per_class: int = 50,
    classes: Optional[Sequence[int]] = None,
    seed: int = 0,
    batch: Optional[int] = None,
    log_every: int = 50,
    mesh=None,
) -> int:
    """The reference protocol: per class, batches of ``batch`` (default
    ``num_img_per_class``) images of that class, sampled with the
    generator's ``GenerateConfig``.  Every batch runs at the full batch
    size, and the tail's extra rows are dropped.  Returns the number of
    generations run (0 when every class was already on disk).  ``mesh``:
    the generator's ``parallel.Mesh`` (module docstring); its params are
    this rank's shards."""
    cfg = generator.cfg
    classes = classes if classes is not None else range(cfg.num_classes)
    batch = batch or num_img_per_class
    writer = True
    if mesh is not None:
        if generator.mesh is not mesh:
            raise ValueError("generate_eval_set's mesh must be the "
                             "generator's")
        batch = max(mesh.dp, batch - batch % mesh.dp)   # dp-divisible
        writer = mesh.rank == 0
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    done = runs = 0
    pending = None
    rng = torch.Generator(device=generator.device)
    for ci in classes:
        complete = class_complete(out_dir, ci, num_img_per_class)
        if mesh is not None:
            complete = C.broadcast_flag(complete, generator.device)
        if complete:
            continue
        produced = 0
        while produced < num_img_per_class:
            labels = torch.full((batch,), ci, dtype=torch.long,
                                device=generator.device)
            rng.manual_seed(batch_seed(seed, ci * 1000 + produced))
            imgs = generator.generate(params, vae_params, labels, rng,
                                      gather=mesh is not None)
            runs += 1
            keep = min(batch, num_img_per_class - produced)
            if writer:
                nxt = _Pending(imgs, ci, produced, keep)
                if pending is not None:
                    pending.flush(out_dir)
                pending = nxt
            produced += keep
        done += 1
        if done % log_every == 0:
            rate = done / (time.time() - t0)
            print(f"[eval] {done} classes done ({rate:.2f} classes/s)",
                  flush=True)
    if pending is not None:
        pending.flush(out_dir)
    return runs
