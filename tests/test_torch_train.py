"""The training path against the JAX package: index streams, loss, LR
schedules, the optimizer and the train step, checkpoints and resume, the
metrics logger and the training CLI.

The same seeded numpy data and JAX-initialized params (``var_tiny``,
``adaln_gamma_std=0.02``, carried over by the bridge) go through both:

- ``eval_shard``, ``infinite_batches`` and ``dist_infinite_batches`` equal
  to JAX's (``np.array_equal``, the first batches of several epochs);
- ``cross_entropy_loss`` within 1e-6 of JAX's (values of order 1),
  ``lr_wd_schedule`` equal, and the CLI's ``warmup_cosine_decay`` within
  a relative 1e-6 plus 1e-6 of the peak of optax's schedule (float32
  there);
- ``loss_fn`` (float32, label smoothing off and on) and its gradients
  against ``jax.value_and_grad``: the loss within 1e-6, every gradient
  leaf within 1e-5 of its own largest magnitude (float32 sums in another
  order);
- three ``train_step``s against JAX's jitted ``train_step`` with the same
  optimizer (AdamW, lr 3e-3, and a clip at 0.9 of the first step's
  gradient norm, so that it fires): in float32 each step's loss within a
  relative 1e-6 and every weight's change within 1e-3 of three steps'
  size (3 lr; optax and ``torch.optim.AdamW`` apply the decay in two
  forms equal in exact arithmetic).  Under mixed precision (a bf16
  forward) the two frameworks round to bf16 in other places, and Adam
  turns a gradient's relative change into the same relative change of the
  step: each loss within a relative 1e-3, and each leaf's update within
  three times the L2 distance between JAX's own bf16 and float32 updates
  (plus 1e-3 of its size, for the leaves that only decay);
- optax's clip formula, ``(g / norm) * max_norm`` only where ``norm >=
  max_norm``, in :func:`clip_by_global_norm_`;
- label dropout at ``cond_drop_rate`` from the caller's generator (the
  same mask from the same seed);
- a run saved and resumed on the CPU continues bit for bit, the retention
  keeps the newest ``max_to_keep``, a killed save (a left ``.tmp``) is
  never the newest, and the restore refuses another tree;
- ``MetricLogger``'s JSONL lines, and ``profile_trace``'s Chrome trace;
- ``tools/train.py --tiny --device cpu`` run twice: the second resumes at
  the last step and adds nothing; with ``--dp 2``, ``--tp 2`` and
  ``--coordinator`` on two gloo ranks it takes the one-device run's
  steps.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fpqvar_tpu import config as JC
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.train import data as JD
from fpqvar_tpu.train import trainer as JT

from fpqvar_tpu_torch.config import var_tiny
from fpqvar_tpu_torch.tools import train as cli
from fpqvar_tpu_torch.train import data as D
from fpqvar_tpu_torch.train import resume as R
from fpqvar_tpu_torch.train import trainer as T
from fpqvar_tpu_torch.utils.bridge import to_torch
from fpqvar_tpu_torch.utils.logging import (MetricLogger, SmoothedValue,
                                            Timer, profile_trace)
from torch_mesh_worker import run_cli_ranks
from torch_threads import one_torch_thread  # noqa: F401

CFG = var_tiny()


def _take(gen, n):
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(dataset_len=37, batch_size=8),
    dict(dataset_len=37, batch_size=8, fill_last=True, seed=3),
    dict(dataset_len=37, batch_size=8, drop_last=True, start_ep=2,
         start_it=3),
    dict(dataset_len=16, batch_size=4, shuffle=False)])
def test_infinite_batches_equal_jax(kw):
    n, b = kw.pop("dataset_len"), kw.pop("batch_size")
    ours = _take(D.infinite_batches(n, b, **kw), 20)
    theirs = _take(JD.infinite_batches(n, b, **kw), 20)
    for a, t in zip(ours, theirs):
        assert np.array_equal(a, t)


@pytest.mark.parametrize("world,kw", [
    (1, dict(fill_last=True)), (4, dict(seed=5)),
    (4, dict(repeated_aug=3, fill_last=True, start_ep=1, start_it=1))])
def test_dist_infinite_batches_and_eval_shard_equal_jax(world, kw):
    for rank in range(world):
        ours = _take(D.dist_infinite_batches(world, rank, 45, 8 * world,
                                             **kw), 12)
        theirs = _take(JD.dist_infinite_batches(world, rank, 45, 8 * world,
                                                **kw), 12)
        for a, t in zip(ours, theirs):
            assert np.array_equal(a, t)
        assert np.array_equal(D.eval_shard(45, rank, world),
                              JD.eval_shard(45, rank, world))
    with pytest.raises(ValueError):
        next(D.dist_infinite_batches(3, 0, 45, 8))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 14, 64)) * 2).astype(np.float32)
    targets = rng.integers(0, 64, (2, 14))
    theirs = JT.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                   smoothing)
    ours = T.cross_entropy_loss(torch.from_numpy(logits),
                                torch.from_numpy(targets), smoothing)
    assert abs(float(ours) - float(theirs)) <= 1e-6


@pytest.mark.parametrize("sche", ["cos", "lin", "lin0", "lin00", "lin0.3",
                                  "exp"])
def test_lr_wd_schedule_equal_jax(sche):
    for it in (0, 3, 10, 11, 40, 99):
        assert (T.lr_wd_schedule(sche, 2e-4, 0.05, 0.01, it, 10, 100)
                == JT.lr_wd_schedule(sche, 2e-4, 0.05, 0.01, it, 10, 100))


@pytest.mark.parametrize("steps,warmup", [(4, 1), (100, 5), (1000, 1)])
def test_warmup_cosine_decay_matches_optax(steps, warmup):
    lr = 1e-4
    theirs = optax.warmup_cosine_decay_schedule(
        init_value=0.005 * lr, peak_value=lr, warmup_steps=warmup,
        decay_steps=steps, end_value=0.001 * lr)
    ours = T.warmup_cosine_decay(0.005 * lr, lr, warmup, steps, 0.001 * lr)
    for count in sorted({0, 1, warmup, warmup + 1, steps // 2, steps - 1,
                         steps, steps + 3}):
        # optax computes in float32, where the warmup's ``(init - peak) *
        # frac + peak`` cancels: a few float32 ulps of the peak
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-6,
                                            abs=1e-6 * lr)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.jit(functools.partial(
        JV.init_var_params, cfg=JC.var_tiny(), adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"label": rng.integers(0, CFG.num_classes, b),
            "x": rng.standard_normal((b, CFG.L - CFG.first_l,
                                      CFG.vae.z_channels)).astype(np.float32),
            "targets": rng.integers(0, CFG.vae.vocab_size, (b, CFG.L))}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pairs(ours, theirs, where=""):
    """(path, port leaf, JAX leaf) of two params trees, by key."""
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), where
        for k in theirs:
            yield from _pairs(ours[k], theirs[k], f"{where}/{k}")
    else:
        yield where, ours, np.asarray(theirs)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_grads_match_jax(smoothing):
    jp, batch = _jax_params(), _batch()
    jb = _jax_batch(batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, JC.var_tiny(), None, jb["label"], jb["x"],
                             jb["targets"], label_smoothing=smoothing)))(jp)
    state = T.make_train_state(to_torch(jax.tree_util.tree_map(
        np.asarray, jp), "cpu"), T.make_optimizer())
    tb = _torch_batch(batch)
    loss = T.loss_fn(state.params, CFG, None, tb["label"], tb["x"],
                     tb["targets"], label_smoothing=smoothing)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-6
    for path, p, g in _pairs(state.params, jgrads):
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        tol = 1e-5 * max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(got, g, rtol=0, atol=tol, err_msg=path)


LR = 3e-3


@functools.lru_cache(maxsize=None)
def _clip():
    """0.9 of the first step's float32 gradient norm: the clip fires."""
    jb = _jax_batch(_batch(0))
    g = jax.grad(lambda p: JT.loss_fn(p, JC.var_tiny(), None, jb["label"],
                                      jb["x"], jb["targets"]))(_jax_params())
    return 0.9 * float(optax.global_norm(g))


@functools.lru_cache(maxsize=None)
def _jax_run(mixed_precision):
    """JAX's jitted train_step three times: (losses, final params)."""
    opt = JT.make_optimizer(peak_lr=LR, grad_clip=_clip())
    state = JT.make_train_state(_jax_params(), opt)
    step = jax.jit(lambda s, b: JT.train_step(
        s, JC.var_tiny(), opt, b, mixed_precision=mixed_precision))
    losses = []
    for seed in range(3):
        state, m = step(state, _jax_batch(_batch(seed)))
        losses.append(float(m["loss"]))
    return losses, state.params


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_train_steps_match_jax(mixed_precision):
    jp = _jax_params()
    losses, jparams = _jax_run(mixed_precision)
    opt = T.make_optimizer(peak_lr=LR, grad_clip=_clip())
    start = to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    state = T.make_train_state(start, opt)
    for i, loss in enumerate(losses):
        state, m = T.train_step(state, CFG, opt, _torch_batch(_batch(i)),
                                mixed_precision=mixed_precision)
        assert state.step == i + 1
        assert abs(float(m["loss"]) - loss) <= (
            1e-3 if mixed_precision else 1e-6) * loss, i
    p0 = {path: a.numpy() for path, a, _ in _pairs(start, jp)}
    if mixed_precision:
        ref = dict((path, t) for path, _, t in _pairs(start, _jax_run(False)[1]))
    for path, p, theirs in _pairs(state.params, jparams):
        assert p.dtype == torch.float32
        ours, theirs = p.detach().numpy() - p0[path], theirs - p0[path]
        if not mixed_precision:
            np.testing.assert_allclose(ours, theirs, rtol=0,
                                       atol=1e-3 * 3 * LR, err_msg=path)
            continue
        # bf16 rounds in other places in the two frameworks: the port's
        # update lies within three times the distance of JAX's own bf16
        # update from its float32 one, plus 1e-3 of its size for the
        # leaves that bf16 does not move (mat_qkv_s and fc1_s only decay)
        noise = np.linalg.norm(theirs - (ref[path] - p0[path]))
        assert np.linalg.norm(ours - theirs) <= (
            3 * noise + 1e-3 * np.linalg.norm(theirs)), path


def test_clip_by_global_norm_is_optax():
    rng = np.random.default_rng(1)
    gs = [rng.standard_normal(s).astype(np.float32) for s in
          ((3, 4), (5,), (2, 2, 2))]
    norm = float(optax.global_norm(gs))
    for max_norm in (norm * 2, norm * 0.5):
        theirs, _ = optax.clip_by_global_norm(max_norm).update(gs, None)
        ours = [torch.from_numpy(g.copy()) for g in gs]
        got = T.clip_by_global_norm_(ours, max_norm)
        assert float(got) == pytest.approx(norm, rel=1e-6)
        for o, t in zip(ours, theirs):
            np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-6,
                                       atol=0)


def test_label_dropout_rate_and_determinism(monkeypatch):
    seen = []

    def forward(params, cfg, qrt, label_B, x, remat=False):
        seen.append(label_B.clone())
        return torch.zeros((label_B.shape[0], cfg.L, cfg.vae.vocab_size))

    monkeypatch.setattr(T.V, "var_forward", forward)
    labels = torch.zeros(20000, dtype=torch.long)
    x = torch.zeros((1,))
    targets = torch.zeros((20000, CFG.L), dtype=torch.long)
    for seed in (1, 1, 2):
        T.loss_fn({}, CFG, None, labels, x, targets,
                  generator=torch.Generator().manual_seed(seed))
    T.loss_fn({}, CFG, None, labels, x, targets)
    dropped = [(s == CFG.num_classes) for s in seen]
    rate = float(dropped[0].float().mean())
    # binomial(20000, 0.1): std 0.0021
    assert abs(rate - CFG.cond_drop_rate) < 0.01
    assert torch.equal(dropped[0], dropped[1])
    assert not torch.equal(dropped[0], dropped[2])
    assert not bool(dropped[3].any())
    assert bool((seen[0][~dropped[0]] == 0).all())


def _tiny_run():
    jp = _jax_params()
    opt = T.make_optimizer(peak_lr=3e-3)
    state = T.make_train_state(to_torch(jax.tree_util.tree_map(
        np.asarray, jp), "cpu"), opt)
    return state, opt


def _step(state, opt, i):
    gen = torch.Generator().manual_seed(100 + i)
    return T.train_step(state, CFG, opt, _torch_batch(_batch(i)),
                        generator=gen)


def test_resume_bit_identical(tmp_path):
    ref, opt = _tiny_run()
    ref_losses = []
    for i in range(5):
        ref, m = _step(ref, opt, i)
        ref_losses.append(float(m["loss"]))

    mngr = R.make_manager(str(tmp_path / "run"), max_to_keep=2)
    state, opt = _tiny_run()
    info, state, start = R.auto_resume(mngr, state)
    assert start == 0 and "no ckpt" in info[0]
    for i in range(3):
        state, _ = _step(state, opt, i)
        assert R.save_train_state(mngr, state)
    assert not R.save_train_state(mngr, state)          # step 3 again
    assert mngr.all_steps() == [2, 3]

    fresh, opt2 = _tiny_run()
    info, resumed, start = R.auto_resume(R.make_manager(
        str(tmp_path / "run")), fresh)
    assert start == 3 and resumed.step == 3 and "resume from step 3" in info[1]
    losses = []
    for i in range(start, 5):
        resumed, m = _step(resumed, opt2, i)
        losses.append(float(m["loss"]))
    assert losses == ref_losses[3:]
    for (_, a, b) in _pairs(resumed.params, _as_np(ref.params)):
        assert np.array_equal(a.detach().numpy(), b)
    sa, sb = resumed.opt_state.state_dict(), ref.opt_state.state_dict()
    for k in sb["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])


def _as_np(tree):
    if isinstance(tree, dict):
        return {k: _as_np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def test_retention_interval_and_killed_save(tmp_path):
    state, opt = _tiny_run()
    mngr = R.make_manager(str(tmp_path), max_to_keep=3,
                          save_interval_steps=2)
    for i in range(7):
        state, _ = _step(state, opt, i)
        assert R.save_train_state(mngr, state) == (state.step % 2 == 0)
    assert mngr.all_steps() == [2, 4, 6]
    # a save killed after its write began leaves only "<step>.tmp"
    os.makedirs(tmp_path / "8.tmp")
    (tmp_path / "8.tmp" / "state.pt").write_bytes(b"partial")
    os.makedirs(tmp_path / "9")                  # no state.pt inside
    assert mngr.latest_step() == 6
    other = T.make_train_state(
        {"w": torch.zeros(3)}, T.make_optimizer())
    with pytest.raises(ValueError, match="does not match"):
        mngr.restore(6, other)


def test_metric_logger_jsonl(tmp_path):
    path = tmp_path / "logs" / "metrics.jsonl"
    log = MetricLogger(str(path), window=2)
    log.update(step=1, loss=3.0, lr=0.1)
    log.update(step=2, loss=1.0, lr=0.2)
    log.update(loss=2.0)
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert [ln.get("step") for ln in lines] == [1, 2, None]
    assert [ln["loss"] for ln in lines] == [3.0, 1.0, 2.0]
    assert all(isinstance(ln["t"], float) for ln in lines)
    assert log.summary() == {"loss": 2.0, "lr": pytest.approx(0.15)}
    assert log.meters["loss"].avg == 1.5 and log.meters["loss"].median == 2.0
    assert "loss: 1.5000 (2.0000)" in str(log)
    sv = SmoothedValue()
    assert (sv.avg, sv.median, sv.global_avg) == (0.0, 0.0, 0.0)


def test_profile_trace_and_timer(tmp_path):
    timer = Timer()
    with timer.stage("matmul"), profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert timer.stages["matmul"] > 0.0
    with profile_trace(None):                       # a no-op
        pass


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--tiny", "--device", "cpu", "--steps", "4", "--save-every", "2",
            "--log-every", "1", "--glb-batch", "4", "--synthetic-n", "10",
            "--out", str(tmp_path)]
    cli.main(args)
    out = capsys.readouterr().out
    assert "no ckpt found" in out and "step 4/4" in out
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(json.loads(s)["loss"]) for s in lines)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "4"]
    cli.main(args)
    out = capsys.readouterr().out
    assert "resume from step 4" in out and "step 4/4" not in out
    assert (tmp_path / "metrics.jsonl").read_text().splitlines() == lines


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"],
                                   ["--coordinator", "--dp", "2"]])
def test_train_cli_refuses_parallel_flags(tmp_path, flags):
    """The parallel flags run: two gloo ranks of ``tools/train.py`` (from
    torchrun's environment, or each given ``--coordinator``) take the
    one-device run's steps: the same logged steps, each loss within a
    relative 1e-6, and the final checkpoint's params within 1e-3 of the
    three steps' size (float32 sums in another order; the step bound of
    ``test_train_steps_match_jax``)."""
    common = ["--tiny", "--device", "cpu", "--steps", "3", "--glb-batch",
              "4", "--synthetic-n", "10", "--log-every", "1"]
    cli.main(common + ["--out", str(tmp_path / "one")])
    coordinator = flags[0] == "--coordinator"
    run_cli_ranks("fpqvar_tpu_torch.tools.train",
                  common + ["--out", str(tmp_path / "mesh")]
                  + flags[coordinator:], 2, coordinator=coordinator)
    one, mesh = ([json.loads(s) for s in (tmp_path / d / "metrics.jsonl")
                  .read_text().splitlines()] for d in ("one", "mesh"))
    assert [m["step"] for m in mesh] == [m["step"] for m in one] == [1, 2, 3]
    for a, b in zip(mesh, one):
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * b["loss"]
    ours, theirs = (torch.load(tmp_path / d / "ckpt" / "3" / "state.pt",
                               weights_only=True)["params"]
                    for d in ("mesh", "one"))
    for a, b in zip(T.tree_leaves(ours), T.tree_leaves(theirs)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * 3 * 1e-4)
