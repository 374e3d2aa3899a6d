"""Whole runs of the test-only cells on the CPU: the result's keys, a sound
run judged correct, the control and each fault of the timed path judged
not correct.  The card-only case runs a traced test-only cell."""
import pytest
import torch

from benchmark.tests.helpers import _threads, run_cell, test_bench  # noqa: F401

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]
CELLS = ["tiny-fp4kv6-batch", "tiny-int8kv-batch", "tiny-fp4kv6-serve"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run(test_bench, cell):  # noqa: F811
    out = run_cell(test_bench, cell)
    assert set(out.pop("info")) >= {"weights_s", "transform_s", "window_s"}
    assert list(out)[-1] == "check" and set(out) == set(KEYS)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert "setup_s" in out["metrics"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, v in out["check"].items():
        assert set(v) == {"value", "limit"}


def test_per_layer_metric_of_a_test_only_file(test_bench):  # noqa: F811
    out = run_cell(test_bench, "tiny-fp4kv6-batch", trace=True)
    assert out["metrics"]["tiny_requests"] == {"value": 8, "unit": "count"}
    assert out["correct"] is True


@pytest.mark.parametrize("cell", CELLS[:2])
def test_control_is_not_correct(test_bench, cell):  # noqa: F811
    """The reference at the nearest lower precision (fp8 operands, TF32)
    in the program's place reads a token gap over the cell's limit."""
    from benchmark.check import NAMES

    out = run_cell(test_bench, cell, control=True)
    c = out["check"]
    assert all(c[n]["value"] <= c[n]["limit"] for n in NAMES)
    assert any(c["control_" + n]["value"] > c[n]["limit"] for n in NAMES)


def _fault_state_unchanged(monkeypatch):
    from fpqvar_tpu_torch.models import var as V

    monkeypatch.setattr(V, "block_forward", lambda x, *a, **k: x)


def _fault_half_batch(monkeypatch):
    from fpqvar_tpu_torch.models.engine import VARGenerator

    orig = VARGenerator.generate

    def half(self, params, vae, labels, generator=None, **kw):
        h = len(labels) // 2
        if not isinstance(generator, torch.Generator):
            generator = list(generator)[:h]
        out = orig(self, params, vae, labels[:h], generator, **kw)
        return torch.cat([out, out])

    monkeypatch.setattr(VARGenerator, "generate", half)


def _fault_token(monkeypatch):
    from fpqvar_tpu_torch.models import var as V

    orig = V.sample_with_top_k_top_p

    def wrong(logits, *a, **k):
        idx = orig(logits, *a, **k).clone()
        idx[:, 0] = (idx[:, 0] + 1) % logits.shape[-1]
        return idx

    monkeypatch.setattr(V, "sample_with_top_k_top_p", wrong)


def _fault_image(monkeypatch):
    from fpqvar_tpu_torch.models.engine import VARGenerator

    orig = VARGenerator._decode
    monkeypatch.setattr(VARGenerator, "_decode",
                        lambda self, vp, f: orig(self, vp, f) + 0.01)


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch": _fault_half_batch, "token_altered": _fault_token,
          "image_altered": _fault_image}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny-fp4kv6-batch", "tiny-int8kv-batch"])
def test_fault_is_not_correct(test_bench, monkeypatch, cell,  # noqa: F811
                              fault):
    FAULTS[fault](monkeypatch)
    assert run_cell(test_bench, cell)["correct"] is False


@pytest.mark.parametrize("fault", ["token_altered", "image_altered"])
def test_served_fault_is_not_correct(test_bench, monkeypatch,  # noqa: F811
                                     fault):
    FAULTS[fault](monkeypatch)
    assert run_cell(test_bench, "tiny-fp4kv6-serve")["correct"] is False


@pytest.mark.cuda
def test_traced_tiny_cell_on_card(test_bench):  # noqa: F811
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import time

    from benchmark.run import run
    from benchmark.tests.helpers import CELLS as C, REPO

    out = run(test_bench, "tiny-fp4kv6-batch", 11, 1.0, True, "cuda",
              time.time(), root=REPO, traffic_dir=C / "traffic",
              metrics_dir=C / "metrics")
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
