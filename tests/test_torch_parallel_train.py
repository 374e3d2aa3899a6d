"""The port's dp x tp train step and its checkpoints against the JAX
package's sharded step and the port's one-device step.

The JAX side runs here on a dp 2 x tp 2 mesh of ``conftest.py``'s virtual
CPU devices, in the layout of ``__graft_entry__.py`` ``dryrun_multichip``
(params by ``param_shardings``, the optimizer state replicated, the batch
over dp), jitted, its outputs pinned to the same shardings (as
``scripts/train.py`` pins them) so that the state goes round three
steps.  The port runs on four gloo ranks (``torch_mesh_worker.py``,
torchrun's environment), once, every case inside them.  The same
JAX-initialized ``var_tiny`` params (``adaln_gamma_std=0.02``, carried over
by the bridge), the same seeded numpy batches of 4 rows (2 a dp rank), the
optimizer of ``test_torch_train.py`` (AdamW, lr 3e-3, a clip at 0.9 of the
first step's gradient norm, so that it fires), and its bounds:

- three steps in float32: each loss within a relative 1e-6 of JAX's
  sharded step's and of the port's one-device step's, every weight's
  change within 1e-3 of three steps' size (3 lr) of both (optax and
  ``torch.optim.AdamW`` apply the decay in two forms equal in exact
  arithmetic; the mesh sums its float32 partials in another order);
- three steps under mixed precision (a bf16 forward): each loss within a
  relative 1e-3 of both; each leaf's update within three times the L2
  distance between JAX's own sharded bf16 and float32 updates (plus 1e-3
  of its size, for the leaves that only decay) of the port's one-device
  mixed-precision update, and within that bound plus the one-device
  update's own distance of JAX's (the triangle inequality: at batch 4
  ``word_embed``'s bias update of the one-device port already lies 1.37
  bounds from JAX's, bf16 rounding in other places in the two
  frameworks);
- checkpoints: two mesh steps saved on dp 2 x tp 2 hold the one-device
  file (rank 0 writes it), which resumes on one device and takes the
  third step as the uninterrupted one-device run does (within the float32
  bound above); a one-device checkpoint of two steps resumes on the mesh,
  and its third step lands within the same bound.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from fpqvar_tpu import config as JC
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.parallel import make_mesh as jax_make_mesh
from fpqvar_tpu.parallel import param_shardings
from fpqvar_tpu.train import trainer as JT

from fpqvar_tpu_torch.config import var_tiny
from fpqvar_tpu_torch.train import resume as R
from fpqvar_tpu_torch.train import trainer as T
from fpqvar_tpu_torch.utils.bridge import to_torch
from torch_mesh_worker import run_ranks
from torch_threads import one_torch_thread  # noqa: F401

CFG = var_tiny()
LR = 3e-3
STEPS = 3


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.jit(functools.partial(
        JV.init_var_params, cfg=JC.var_tiny(), adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"label": rng.integers(0, CFG.num_classes, b),
            "x": rng.standard_normal((b, CFG.L - CFG.first_l,
                                      CFG.vae.z_channels)).astype(np.float32),
            "targets": rng.integers(0, CFG.vae.vocab_size, (b, CFG.L))}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _clip():
    """0.9 of the first step's float32 gradient norm: the clip fires."""
    b = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    g = jax.grad(lambda p: JT.loss_fn(p, JC.var_tiny(), None, b["label"],
                                      b["x"], b["targets"]))(_jax_params())
    return 0.9 * float(optax.global_norm(g))


def _start():
    return to_torch(jax.tree_util.tree_map(np.asarray, _jax_params()), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_sharded_run(mixed_precision):
    """JAX's sharded train step, three times: (losses, final params)."""
    mesh = jax_make_mesh(JC.MeshConfig(dp=2, tp=2))
    opt = JT.make_optimizer(peak_lr=LR, grad_clip=_clip())
    state = JT.make_train_state(_jax_params(), opt)
    repl = NamedSharding(mesh, JP())
    state_sh = type(state)(
        params=param_shardings(state.params, mesh),
        opt_state=jax.tree_util.tree_map(
            lambda _: repl, state.opt_state,
            is_leaf=lambda x: isinstance(x, jnp.ndarray)),
        step=repl)
    batch_sh = {"label": NamedSharding(mesh, JP("dp")),
                "x": NamedSharding(mesh, JP("dp", None, None)),
                "targets": NamedSharding(mesh, JP("dp", None))}
    step = jax.jit(lambda s, b: JT.train_step(
        s, JC.var_tiny(), opt, b, mixed_precision=mixed_precision),
        in_shardings=(state_sh, batch_sh),
        out_shardings=(state_sh, {"loss": repl}))
    losses = []
    with mesh:
        for seed in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in _batch(seed).items()})
            losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


def _one_device(mixed_precision, steps=STEPS, state=None):
    """The port's one-device steps: (losses, state)."""
    opt = T.make_optimizer(peak_lr=LR, grad_clip=_clip())
    state = state or T.make_train_state(_start(), opt)
    losses = []
    for seed in range(state.step, steps):
        state, m = T.train_step(state, CFG, opt, _torch_batch(_batch(seed)),
                                mixed_precision=mixed_precision)
        losses.append(float(m["loss"]))
    return losses, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    # the one-device checkpoint of two steps, for the mesh to resume
    _, two = _one_device(False, steps=2)
    R.save_train_state(R.make_manager(str(tmp / "one")), two)
    job = dict(cfg_train=CFG, train_params=_start(), lr=LR, clip=_clip(),
               batches=[_torch_batch(_batch(s)) for s in range(STEPS)],
               cases=[("f32", "train", dict(dp=2, tp=2, mixed_precision=False,
                                           steps=STEPS)),
                      ("mixed", "train", dict(dp=2, tp=2,
                                              mixed_precision=True,
                                              steps=STEPS)),
                      ("ckpt", "checkpoint", dict(
                          dp=2, tp=2, save_dir=str(tmp / "mesh"),
                          load_dir=str(tmp / "one")))])
    return tmp, run_ranks(4, job, str(tmp / "ranks"))


def _leaves(tree):
    return T.tree_leaves(tree)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_mesh_train_steps_match_jax_and_one_device(ranks, mixed_precision):
    _, res = ranks
    out = res[0]["mixed" if mixed_precision else "f32"]
    jlosses, jparams = _jax_sharded_run(mixed_precision)
    olosses, ostate = _one_device(mixed_precision)
    rel = 1e-3 if mixed_precision else 1e-6
    for r in res:                       # the dp mean on every rank
        assert r["mixed" if mixed_precision else "f32"]["losses"] == \
            out["losses"]
    for ours, theirs, one in zip(out["losses"], jlosses, olosses):
        assert abs(ours - theirs) <= rel * theirs
        assert abs(ours - one) <= rel * one
    p0 = [_np(t) for t in _leaves(_start())]
    mesh = [_np(t) - a for t, a in zip(_leaves(out["params"]), p0)]
    jax_upd = [np.asarray(t) - a for t, a in zip(
        _leaves(to_torch(jparams, "cpu")), p0)]
    one_upd = [_np(t) - a for t, a in zip(_leaves(ostate.params), p0)]
    if not mixed_precision:
        for m, j, o in zip(mesh, jax_upd, one_upd):
            np.testing.assert_allclose(m, j, rtol=0, atol=1e-3 * 3 * LR)
            np.testing.assert_allclose(m, o, rtol=0, atol=1e-3 * 3 * LR)
        return
    ref = [np.asarray(t) - a for t, a in zip(
        _leaves(to_torch(_jax_sharded_run(False)[1], "cpu")), p0)]
    for m, j, o, f in zip(mesh, jax_upd, one_upd, ref):
        bound = 3 * np.linalg.norm(j - f) + 1e-3 * np.linalg.norm(o)
        assert np.linalg.norm(m - o) <= bound
        assert np.linalg.norm(m - j) <= np.linalg.norm(o - j) + bound


def test_mesh_checkpoints_resume_both_ways(ranks):
    tmp, res = ranks
    out = res[0]["ckpt"]
    assert out["saved"] and out["start"] == 2 and out["step"] == STEPS
    assert sorted(os.listdir(tmp / "mesh")) == ["2"]
    _, three = _one_device(False)
    tol = 1e-3 * 3 * LR
    # the mesh's two-step checkpoint, resumed on one device
    opt = T.make_optimizer(peak_lr=LR, grad_clip=_clip())
    info, state, start = R.auto_resume(R.make_manager(str(tmp / "mesh")),
                                       T.make_train_state(_start(), opt))
    assert start == 2 and "resume from step 2" in info[-1]
    _, state = _one_device(False, state=state)
    for a, b in zip(_leaves(state.params), _leaves(three.params)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)
    # the one-device checkpoint, resumed on the mesh, one step on
    for a, b in zip(_leaves(out["params"]), _leaves(three.params)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)
