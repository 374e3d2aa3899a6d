"""Train-state checkpointing and auto-resume on ``torch.save``.

The port of the JAX package's ``train/resume.py``, which keeps orbax
checkpoints: step-indexed directories ``<directory>/<step>/state.pt``, a
save only at multiples of ``save_interval_steps`` past the newest step, and
``max_to_keep`` retention.  A save writes ``<step>.tmp`` first and renames
it, so a save killed half way never looks like the newest checkpoint.
Saves are synchronous.

Under a ``{dp, tp}`` mesh (``mesh=``) the state holds this rank's shards:
a save gathers the params and the AdamW moments over tp and rank 0 writes
the file a one-device run writes, while the other ranks wait at a
barrier; a restore reads that file on every rank and keeps the rank's
shards.  So a mesh run resumes a one-device checkpoint and the reverse.
The run directory must be the same for every rank.

Usage::

    mngr = make_manager(run_dir, max_to_keep=3)
    info, state, start_step = auto_resume(mngr, state)   # state: template
    for step in range(start_step, max_steps):
        state, metrics = train_step(...)
        save_train_state(mngr, state)
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from fpqvar_tpu_torch.train.trainer import TrainState, tree_leaves, tree_map

_FILE = "state.pt"


class CheckpointManager:
    """Step-indexed train-state checkpoints under one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def all_steps(self) -> List[int]:
        """The steps of every complete checkpoint, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, mesh=None) -> bool:
        """Save ``state`` as ``step`` unless the interval policy skips it
        (returns False), then drop the oldest beyond ``max_to_keep``.
        Under a ``mesh`` every rank calls it (module docstring)."""
        latest = self.latest_step()
        if ((latest is not None and latest >= step)
                or step % self.save_interval_steps):
            return False
        params = tree_map(lambda t: t.detach(), state.params)
        opt = state.opt_state.state_dict()
        if mesh is not None:
            params, opt = _gathered(params, opt, mesh)
            if mesh.rank != 0:
                dist.barrier()
                return True
        self._write(step, {"params": params, "opt_state": opt,
                           "step": int(state.step)})
        if mesh is not None:
            dist.barrier()
        return True

    def _write(self, step: int, payload: dict) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: int, template: TrainState,
                mesh=None) -> TrainState:
        """Checkpoint ``step`` loaded into ``template``: its params (in
        place, on their own devices), its optimizer's moments and step
        counts (``load_state_dict`` puts them beside the params) and its
        step.  Under a ``mesh`` the template holds this rank's shards,
        and so does the restored state."""
        saved = torch.load(os.path.join(self.directory, str(step), _FILE),
                           map_location="cpu", weights_only=True)
        if mesh is not None:
            saved["params"], saved["opt_state"] = _sharded(
                saved["params"], saved["opt_state"], mesh)
        dst, src = tree_leaves(template.params), tree_leaves(saved["params"])
        if len(dst) != len(src) or any(a.shape != b.shape
                                       for a, b in zip(dst, src)):
            raise ValueError(f"checkpoint {step} does not match the "
                             "template's params tree")
        with torch.no_grad():
            for a, b in zip(dst, src):
                a.copy_(b)
        template.opt_state.load_state_dict(saved["opt_state"])
        return TrainState(template.params, template.opt_state,
                          saved["step"])


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _opt_mapped(opt: dict, dims: list, fn) -> dict:
    """An AdamW ``state_dict`` with ``fn(tensor, dim)`` applied to each
    parameter's moments (``dims[i]``: parameter i's split dim)."""
    state = {i: {k: fn(v, dims[i]) if k in _MOMENTS else v
                 for k, v in st.items()}
             for i, st in opt["state"].items()}
    return {**opt, "state": state}


def _gathered(params, opt: dict, mesh):
    """The whole params tree and AdamW state of this rank's shards."""
    from fpqvar_tpu_torch.parallel.mesh import (gather_params,
                                                gather_tensor, param_specs)

    dims = tree_leaves(param_specs(params, mesh))
    return (gather_params(params, mesh),
            _opt_mapped(opt, dims, lambda t, d: gather_tensor(t, d, mesh)))


def _sharded(params, opt: dict, mesh):
    """This rank's shards of a whole params tree and AdamW state."""
    from fpqvar_tpu_torch.parallel.mesh import (param_specs, shard_params,
                                                shard_tensor)

    dims = tree_leaves(param_specs(params, mesh))
    return (shard_params(params, mesh),
            _opt_mapped(opt, dims, lambda t, d: shard_tensor(t, d, mesh)))


def make_manager(directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1) -> CheckpointManager:
    """A step-indexed checkpoint manager rooted at ``directory``."""
    return CheckpointManager(directory, max_to_keep, save_interval_steps)


def save_train_state(mngr: CheckpointManager, state: TrainState,
                     mesh=None) -> bool:
    """Save ``state`` under its own ``state.step``; False when the save
    interval skips the step."""
    return mngr.save(int(state.step), state, mesh)


def auto_resume(mngr: CheckpointManager, template: TrainState,
                mesh=None) -> Tuple[List[str], TrainState, int]:
    """Restore the newest checkpoint into ``template``, or pass the
    template through: (info lines, state, step to resume from)."""
    step = mngr.latest_step()
    if step is None:
        return ([f"[auto_resume] no ckpt found @ {mngr.directory}",
                 "[auto_resume quit]"], template, 0)
    state = mngr.restore(step, template, mesh)
    return ([f"[auto_resume] load ckpt from @ {mngr.directory}/{step} ...",
             f"[auto_resume success] resume from step {step}"], state, step)
