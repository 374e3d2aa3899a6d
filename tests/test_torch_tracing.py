"""The port's program spans and stage markers on the CPU.

- ``utils/logging.py`` ``span`` records nothing while no profiler runs;
  under ``torch.profiler`` it records each span with its parent's id (per
  thread) and its attributes, in a buffer of ``SPAN_CAPACITY`` spans;
  a ``record_function`` block inside a span lies within it on the
  profiler's own timestamps (the shared clock), within 1 ms.
- ``GenerationServer`` records ``server.collect``, ``server.dispatch``
  and ``server.fetch`` for each batch with that batch's request ids, and
  the generator's ``engine.generate`` under ``server.dispatch``.
- A fused ``VARGenerator.generate`` records ``engine.draw``,
  ``engine.launch`` and ``engine.copy`` under ``engine.generate``, and
  launches the stage marker at the start of each scale and once after
  the last, in scale order, whether or not a profiler runs.
"""
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fpqvar_tpu_torch.config import QuantConfig, VARConfig, VQVAEConfig
from fpqvar_tpu_torch.models import (VARGenerator, engine, init_var_params,
                                     init_vqvae_params)
from fpqvar_tpu_torch.ops.stage_mark import STAGE_MARK_KERNEL, stage_mark
from fpqvar_tpu_torch.serving import GenerationServer
from fpqvar_tpu_torch.utils import logging as L
from torch_threads import one_torch_thread  # noqa: F401

#: ten scales, as VAR-d30 and VAR-d36-512 have, at a tiny width
TEN = VARConfig(
    depth=1, embed_dim=64, num_heads=2,
    patch_nums=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10), num_classes=8,
    vae=VQVAEConfig(vocab_size=32, z_channels=8, ch=16, ch_mult=(1, 2),
                    num_res_blocks=1,
                    patch_nums=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10)))
#: the serving tests' two-scale model
TINY = VARConfig(
    depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2), num_classes=8,
    vae=VQVAEConfig(vocab_size=32, z_channels=8, ch=16, ch_mult=(1, 2),
                    num_res_blocks=1, patch_nums=(1, 2)))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_buffer():
    L.clear_spans()
    yield
    L.clear_spans()


def _model(cfg):
    return (init_var_params(cfg, seed=0, device="cpu",
                            adaln_gamma_std=0.02),
            init_vqvae_params(cfg.vae, seed=1, device="cpu"))


def test_nothing_recorded_without_a_profiler():
    with L.span("off", batch=1) as sp:
        sp.set(requests=[1, 2])
        assert not sp
    assert L.spans() == []


def test_spans_record_parents_and_attributes_under_the_profiler():
    other = []

    def on_a_thread():
        with L.span("thread.top") as sp:
            other.append(sp.id)

    with _cpu_profile():
        with L.span("outer", batch=3) as outer:
            with L.span("inner") as inner:
                inner.set(requests=[4, 5])
            t = threading.Thread(target=on_a_thread)
            t.start()
            t.join()
    got = {s.name: s for s in L.spans()}
    assert set(got) == {"outer", "inner", "thread.top"}
    assert got["outer"].parent is None and got["outer"].id == outer.id
    assert got["inner"].parent == outer.id
    assert got["thread.top"].parent is None      # another thread's stack
    assert got["thread.top"].id == other[0]
    assert got["outer"].attrs == {"batch": 3}
    assert got["inner"].attrs == {"requests": [4, 5]}
    o, i = got["outer"], got["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert abs(o.start_ns - time.time_ns()) < 60e9
    L.clear_spans()
    assert L.spans() == []


def test_a_record_function_lies_inside_its_span_on_the_profilers_clock():
    with _cpu_profile() as prof:
        with L.span("program.block"):
            with record_function("user.block"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    sp, = L.spans()
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "user.block"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert sp.start_ns - 1e6 <= start and end <= sp.end_ns + 1e6
    assert start <= end


def test_the_buffer_keeps_the_newest_spans(monkeypatch):
    from collections import deque

    monkeypatch.setattr(L, "_spans", deque(maxlen=8))
    with _cpu_profile():
        for i in range(11):
            with L.span(f"s{i}"):
                pass
    assert [s.name for s in L.spans()] == [f"s{i}" for i in range(3, 11)]
    assert L.SPAN_CAPACITY >= 1 << 12


def test_server_records_each_batch_with_its_requests():
    params, vae = _model(TINY)
    gen = VARGenerator(TINY, QuantConfig(), device="cpu")
    srv = GenerationServer(gen, params, vae, max_batch=4, max_wait_ms=50)
    try:
        with _cpu_profile():
            futs = [srv.submit(i % 8, seed=i) for i in range(6)]
            for f in futs:
                f.result(timeout=120)
    finally:
        srv.stop()
    spans = L.spans()
    by = {}
    for s in spans:
        if s.name.startswith("server."):
            by.setdefault(s.attrs["batch"], {})[s.name] = s
    assert by and all(set(v) == {"server.collect", "server.dispatch",
                                 "server.fetch"} for v in by.values())
    served = []
    for bid, v in sorted(by.items()):
        reqs = v["server.collect"].attrs["requests"]
        assert v["server.dispatch"].attrs["requests"] == reqs
        assert v["server.fetch"].attrs["requests"] == reqs
        assert 1 <= len(reqs) <= 4
        c, d, f = v["server.collect"], v["server.dispatch"], v["server.fetch"]
        assert c.end_ns <= d.start_ns and d.end_ns <= f.start_ns
        served += reqs
    assert sorted(served) == list(range(6))
    dispatch = {v["server.dispatch"].id for v in by.values()}
    calls = [s for s in spans if s.name == "engine.generate"]
    assert len(calls) == len(by)
    assert all(s.parent in dispatch for s in calls)


@pytest.mark.parametrize("fuse", [True, False])
def test_generate_marks_every_scale_in_order(monkeypatch, fuse):
    marks = []
    monkeypatch.setattr(engine, "stage_mark",
                        lambda stage, device: marks.append(stage))
    params, vae = _model(TEN)
    gen = VARGenerator(TEN, QuantConfig(), device="cpu", fuse_steps=fuse)
    gen.generate(params, vae, [1, 2], torch.Generator().manual_seed(0))
    assert marks == list(range(11))
    assert L.spans() == []                   # no profiler: no span


def test_fused_generate_records_draw_launch_copy():
    params, vae = _model(TEN)
    gen = VARGenerator(TEN, QuantConfig(), device="cpu")
    with _cpu_profile():
        img = gen.generate(params, vae, [1, 2],
                           torch.Generator().manual_seed(0))
    assert img.shape == (2, 3, 20, 20)
    spans = L.spans()
    top, = [s for s in spans if s.name == "engine.generate"]
    kids = sorted((s for s in spans if s.parent == top.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["engine.draw", "engine.launch",
                                      "engine.copy"]
    assert top.attrs == {"batch": 2}
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert top.start_ns <= kids[0].start_ns
    assert kids[-1].end_ns <= top.end_ns


def test_stage_mark_is_a_no_op_on_the_cpu():
    stage_mark(0, "cpu")
    stage_mark(10, torch.device("cpu"))
    assert STAGE_MARK_KERNEL == "fpq_stage_mark"
