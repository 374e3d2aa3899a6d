"""Continuous-batching generation server.

VAR generation is fixed-length (10 scale steps), which makes batching
simple: requests are (class label, seed) pairs, a worker thread coalesces
up to ``max_batch`` of them (classes mix freely: labels are per row), one
``VARGenerator.generate`` produces the whole batch, and the images are
handed back through per-request futures.  Every batch is padded to
``max_batch`` rows (label 0, the seed-0 row), so every generation runs the
same shapes and a request's image does not depend on what it is batched
with.  Under sustained load the worker runs a depth-2 pipeline: it queues
the next batch on the device before it fetches the previous batch's images,
so the host's launches for one batch overlap the device's work on the
other.  ``generate`` only queues work (labels reach the device through
pinned memory, without a wait), which is what makes the overlap real.  A
batch's images are fetched on a copy stream once an event recorded at the
end of that batch's work has fired: a copy on the compute stream would
also wait for the next batch, queued behind it (JAX waits for the one
buffer).  Over a fused generator (CUDA graphs, the engine's default) the
per-row generators reach the graphs only through the noise that
``generate`` draws before each replay, so the graphs captured by the
first batch serve every later request, and the copy that ``generate``
returns keeps a batch's images while the next batch replays.

A port of ``fpqvar_tpu/serving.py`` with the same API.  Each row's
``torch.Generator`` is a pure function of ``(base_seed, seed)``
(:func:`row_seed`), in place of JAX's ``fold_in(base_key, seed)``.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch


def row_seed(base_seed: int, seed: int) -> int:
    """The 64-bit seed of a request's generator: a pure function of the
    server's ``base_seed`` and the request's ``seed`` (each taken modulo
    2^32, as ``fold_in`` takes its data), mixed by numpy's
    ``SeedSequence``."""
    words = np.random.SeedSequence(
        [base_seed & 0xFFFFFFFF, seed & 0xFFFFFFFF]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & 0x7FFFFFFFFFFFFFFF


class GenerationServer:
    def __init__(self, generator, params, vae_params, max_batch: int = 16,
                 max_wait_ms: float = 50.0, base_seed: int = 0):
        """``generator`` is a ``VARGenerator``; requests run on its
        device."""
        self.generator = generator
        self.params = params
        self.vae_params = vae_params
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.base_seed = base_seed
        self.device = generator.device
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._batches = 0
        self._served = 0
        self._pipelined = 0
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, label: int, seed: int = 0) -> Future:
        """Enqueue one generation request; resolves to a host float32
        ``[3, H, W]`` image."""
        fut: Future = Future()
        self._q.put((int(label), int(seed), fut))
        return fut

    def stats(self) -> dict:
        return {"batches": self._batches, "served": self._served,
                "pipelined": self._pipelined}

    def stop(self) -> None:
        self._stop.set()
        self._worker.join(timeout=10)

    # ------------------------------------------------------------------
    def _collect(self):
        """Block for the first request, then coalesce for up to max_wait."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        t0 = time.monotonic()
        while len(batch) < self.max_batch:
            remaining = self.max_wait - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(row_seed(self.base_seed, seed))
        return gen

    def _dispatch(self, batch):
        """Queue one generation for a coalesced batch; returns the device
        images and an event that fires when they are ready (None on the
        CPU), without waiting for them."""
        pad = self.max_batch - len(batch)
        labels = torch.tensor([b[0] for b in batch] + [0] * pad,
                              dtype=torch.long)
        if self.device.type == "cuda":
            labels = labels.pin_memory().to(self.device, non_blocking=True)
        # one generator per row, from (base_seed, request seed) only: a
        # request's image is reproducible whatever it is batched with
        gens = ([self._generator(seed) for _, seed, _ in batch]
                + [self._generator(0) for _ in range(pad)])
        imgs = self.generator.generate(self.params, self.vae_params, labels,
                                       gens)
        if self._copy_stream is None:
            return imgs, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return imgs, ready

    def _fetch(self, imgs, ready, n: int) -> torch.Tensor:
        """The first ``n`` images on the host, as float32.  On a card the
        copy runs on the copy stream after ``ready``, so it does not wait
        for work queued after this batch; ``imgs`` stays referenced until
        the copy is done."""
        if ready is None:
            return imgs[:n].to("cpu", torch.float32)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            return imgs[:n].to("cpu", torch.float32)

    def _resolve(self, batch, dispatched):
        """Fetch a dispatched batch to the host and fan the images out."""
        try:
            host = self._fetch(*dispatched, len(batch))
            # counted before the futures resolve, so that a caller woken by
            # its result reads stats() that include its batch
            self._batches += 1
            self._served += len(batch)
            for i, (_, _, fut) in enumerate(batch):
                fut.set_result(host[i])
        except Exception as e:  # noqa: BLE001 - each future gets the error
            self._fail(batch, e)

    @staticmethod
    def _fail(batch, e):
        for _, _, fut in batch:
            if not fut.done():
                fut.set_exception(e)

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                out = self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 - each future gets the error
                self._fail(batch, e)
                continue
            # depth-2 pipeline: while the device runs this batch, coalesce
            # and queue the next whenever requests are already waiting, THEN
            # fetch this batch's images.  A lone request is fetched at once,
            # so idle-traffic latency is unchanged.
            while not self._stop.is_set() and not self._q.empty():
                nxt = self._collect()
                if not nxt:
                    break
                try:
                    out_nxt = self._dispatch(nxt)
                except Exception as e:  # noqa: BLE001
                    self._fail(nxt, e)
                    break
                self._pipelined += 1
                self._resolve(batch, out)
                batch, out = nxt, out_nxt
            self._resolve(batch, out)
