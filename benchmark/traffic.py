"""The general traffic generator: a mix is a data file of parameters
(``benchmark/traffic/<name>.json``) that this module turns, with
``--seed``, into what the run sends.

- ``"entry": "batch"``: a closed loop of whole batches of ``batch`` labels
  through the generator, ``ahead`` batches (default 1) queued beyond the
  one being fetched, so that the card stays fed while the host stands
  still; labels uniform over the classes; one sampling generator a batch,
  seeded by :func:`batch_seed`.
- ``"entry": "server"``: single-image requests through the server, an
  open loop at ``rate`` requests a second.  The gaps are the exponential
  distribution's quantiles at ``(i + 0.5) / n`` for the ``n = rate *
  seconds`` requests of the window, in an order drawn from the seed: every
  seed sends the same set of gaps, and so the same load, in another
  order.  With ``burst`` (requests a burst) they come in bursts of that
  many at once, the bursts spaced ``burst / rate`` apart.  Labels are
  uniform; request ``i`` carries seed ``i + 1`` (the server pads with seed
  0).

Every number comes from ``--seed`` and the file, never from the program.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent / "traffic"


def load(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / f"{name}.json").read_text())


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, stream])


def batch_seed(seed: int, i: int) -> int:
    """The sampling generator's seed of batch ``i`` of a run."""
    words = np.random.SeedSequence([seed & 0xFFFFFFFFFFFFFFFF, 7, i])
    return int(words.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


def batch_labels(mix: dict, num_classes: int, seed: int, n: int):
    """Labels ``[n, batch]`` of the first ``n`` batches of a run."""
    return _rng(seed, 1).integers(0, num_classes, size=(n, mix["batch"]))


def arrivals(mix: dict, num_classes: int, seed: int, seconds: float):
    """(due times in seconds from the window's start, labels, request
    seeds) of the requests of an open-loop window."""
    rate = float(mix["rate"])
    n = max(1, int(round(rate * seconds)))
    burst = int(mix.get("burst", 1))
    nb = -(-n // burst)
    q = (np.arange(nb) + 0.5) / nb
    gaps = -np.log1p(-q) * burst / rate
    gaps = _rng(seed, 2).permutation(gaps)
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    due = np.repeat(starts, burst)[:n]
    labels = _rng(seed, 3).integers(0, num_classes, size=n)
    return due, labels, np.arange(1, n + 1)
