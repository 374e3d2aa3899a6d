"""The batch driver's window: ``ahead`` batches stay queued beyond the one
being fetched, nothing is queued once the window's time is up, and every
batch queued is fetched and counted over the whole window."""
import time

import pytest

from benchmark.run import BatchDriver


class _Stub(BatchDriver):
    """The driver's loop over a stand-in for the generator: each batch
    completes ``batch_s`` after the previous one, as on a fed card."""

    def __init__(self, ahead, batch_s):
        self.ahead, self.b, self.batch_s = ahead, 4, batch_s
        self.copy = None
        self.done = 0
        self.gen_s, self.gen_cpu_s, self.done_at, self.card = [], [], [], []
        self.log = []
        self.ready = None

    def _queue(self, i):
        now = time.perf_counter()
        self.ready = max(self.ready or now, now) + self.batch_s
        self.log.append(("queue", i, len(self.log)))
        self.gen_s.append(0.0)
        self.gen_cpu_s.append(0.0)
        return i, self.ready, None

    def _fetch(self, q):
        i, ready, _ = q
        time.sleep(max(0.0, ready - time.perf_counter()))
        self.log.append(("fetch", i, len(self.log)))


@pytest.mark.parametrize("ahead", [1, 2, 4])
def test_window_counts_every_batch_queued(ahead):
    d = _Stub(ahead, 0.02)
    d.window(0.1, None)
    queued = [i for k, i, _ in d.log if k == "queue"]
    fetched = [i for k, i, _ in d.log if k == "fetch"]
    assert fetched == queued == list(range(len(queued)))
    assert d.facts()["images"] == len(queued) * d.b
    assert d.facts()["window_s"] == d.done_at[-1]
    # nothing is queued after the first fetch at or past the window's time
    first_late = next(n for n, t in enumerate(d.done_at) if t >= 0.1)
    fetch_pos = [p for k, _, p in d.log if k == "fetch"]
    assert all(p < fetch_pos[first_late] for k, _, p in d.log
               if k == "queue")
    # ``ahead`` batches stay queued beyond the one being fetched
    for n, p in enumerate(fetch_pos[:first_late]):
        q = sum(1 for k, _, pp in d.log if k == "queue" and pp < p)
        assert q - n == ahead + 1


def test_traced_window_queues_its_batches_only():
    d = _Stub(2, 0.01)
    d.window(100.0, None, n_batches=3)
    assert [i for k, i, _ in d.log if k == "fetch"] == [0, 1, 2]
    assert d.facts()["images"] == 3 * d.b
