"""The rank side of the port's gloo mesh tests (``test_torch_parallel*.py``).

Each rank is one process, started as ``torchrun`` starts one (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``init_method=env://``):

    python tests/torch_mesh_worker.py <job.pt> <out dir>

The job (``torch.save``) holds the inputs and a list of ``(name, case,
kwargs)``; the rank runs every case in order (every rank runs the same
collectives in the same order) and saves ``{name: result}`` to ``<out
dir>/rank<r>.pt``.  It imports no JAX: the test process builds the JAX
side and compares.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from fpqvar_tpu_torch.config import GenerateConfig, MeshConfig
from fpqvar_tpu_torch.models import VARGenerator
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.ops import int8_matmul as I
from fpqvar_tpu_torch.ops import quant_matmul as Qm
from fpqvar_tpu_torch.parallel import make_mesh, shard_params
from fpqvar_tpu_torch.train import resume as R
from fpqvar_tpu_torch.train import trainer as T

#: kernel -> (module, wrapper): the wrappers the CPU calls count
WRAPPERS = {"K1": (I, "int8_group_gemm"), "K2": (Qm, "packed_matmul"),
            "K3": (I, "int8ch_gemm"), "K4": (I, "fused_ch_gemm"),
            "K5": (I, "int8_group_gemm_nd")}
CALLS = {k: 0 for k in WRAPPERS}
TOKENS: list = []


def _counting(kern, fn):
    def wrapped(*a, **kw):
        CALLS[kern] += 1
        return fn(*a, **kw)
    return wrapped


def _recording(fn):
    def wrapped(logits, *a, **kw):
        idx = fn(logits, *a, **kw)
        TOKENS.append((idx.clone(), logits.clone()))
        return idx
    return wrapped


def _install():
    for kern, (mod, name) in WRAPPERS.items():
        setattr(mod, name, _counting(kern, getattr(mod, name)))
    V.sample_with_top_k_top_p = _recording(V.sample_with_top_k_top_p)


def _mesh(job, dp, tp):
    return make_mesh(MeshConfig(dp, tp))


def case_shards(job, tree, dp, tp):
    """This rank's shards of a whole tree."""
    return shard_params(job["trees"][tree], _mesh(job, dp, tp))


def _generate(job, tree, recipe, mesh, labels, sampled=None):
    """(tokens and logits per scale, f_hat, images, kernel calls) of one
    eager generation in float32 (the mesh's whole batch): at top_k=1, or
    with ``sampled`` ("one" generator or one per "row") at the default
    sampling."""
    gcfg = (GenerateConfig(top_k=1, top_p=0.0) if sampled is None
            else GenerateConfig())
    gen = VARGenerator(job["cfg"], job["recipes"][recipe], gcfg,
                       cache_dtype=torch.float32, compute_dtype=torch.float32,
                       device="cpu", fuse_steps=False, mesh=mesh)
    params = job["trees"][tree]
    if mesh is not None:
        params = shard_params(params, mesh)
    for k in CALLS:
        CALLS[k] = 0
    TOKENS.clear()
    rng = torch.Generator().manual_seed(2)
    if sampled == "row":
        rng = [torch.Generator().manual_seed(10 + i)
               for i in range(len(labels))]
    f_hat = gen.generate(params, job["vae"], labels, rng, return_fhat=True,
                         gather=mesh is not None)
    calls = dict(CALLS)
    toks = list(TOKENS)
    img = (V.vq.decode(job["vae"], job["cfg"].vae, f_hat) + 1.0) * 0.5
    cache = {k: tuple(v.shape) for k, v in gen.init_cache(
        len(labels)).items()}
    return {"tokens": [t for t, _ in toks], "logits": [lg for _, lg in toks],
            "f_hat": f_hat, "images": img, "calls": calls, "cache": cache}


def case_generate(job, tree, recipe, dp, tp, sampled=None):
    """A mesh generation and, on every rank, the one-device generation
    of the same labels and generators."""
    labels = job["labels"]
    mesh = _mesh(job, dp, tp)
    out = _generate(job, tree, recipe, mesh, labels, sampled)
    out["one"] = _generate(job, tree, recipe, None, labels, sampled)
    out["rows"] = (mesh.dp_rank, mesh.dp)
    return out


def case_errors(job):
    """What make_mesh and a fused mesh generator raise."""
    out = {}
    try:
        make_mesh(MeshConfig(dp=4, tp=2))
    except ValueError as e:
        out["make_mesh"] = str(e)
    mesh = make_mesh(MeshConfig(dp=2, tp=2))
    try:
        VARGenerator(job["cfg"], job["recipes"]["bf16"], device="cpu",
                     mesh=mesh)
    except NotImplementedError as e:
        out["fused"] = str(e)
    return out


def case_col_bias(job, n):
    """``fc1`` as one column linear on a tp 2 mesh with ``n`` output
    columns, under each quantized route (``int8`` per group, per channel,
    ``packed``), its bias shard added as the linears add it: the mesh
    output and the one-device output with the whole bias (``n = 128``
    keeps the pack whole while ``fc1_b`` still splits)."""
    from fpqvar_tpu_torch.ops import packing as P

    mesh = _mesh(job, 1, 2)
    g = torch.Generator().manual_seed(n)
    k = 256
    w = torch.randn((1, n, k), generator=g) * 0.05
    b = torch.randn((1, n), generator=g)
    x = torch.randn((3, 5, k), generator=g)
    packs = {"int8": P.pack_int_codes(w, "fp_e2", 128),
             "int8ch": P.pack_int_codes(w, "fp_e2", k),
             "packed": P.pack_stacked(w, "fp_e2", 128)}
    out = {}
    for name, pw in packs.items():
        full = {"blocks": {"fc1_w": pw, "fc1_b": b}}
        one = V.block_params(full["blocks"], 0)
        loc = V.block_params(shard_params(full, mesh)["blocks"], 0)
        if name == "packed":
            out[name] = (V.linear(x, loc["fc1_w"], loc["fc1_b"], mesh, "col"),
                         V.linear(x, one["fc1_w"], one["fc1_b"]))
        else:
            out[name] = (I.int8_linear(x, loc["fc1_w"], "fp_e2", mesh=mesh,
                                       parallel="col", b=loc["fc1_b"]),
                         I.int8_linear(x, one["fc1_w"], "fp_e2",
                                       b=one["fc1_b"]))
        out[name] += (loc["fc1_b"].shape[-1],)
    return out


def case_train(job, dp, tp, mixed_precision, steps):
    """``steps`` mesh train steps from the job's float tree on this rank's
    rows; the whole params after each step (gathered) and the losses."""
    from fpqvar_tpu_torch.parallel import gather_params

    mesh = _mesh(job, dp, tp)
    opt = T.make_optimizer(peak_lr=job["lr"], grad_clip=job["clip"])
    state = T.make_train_state(shard_params(job["train_params"], mesh), opt)
    losses = []
    for batch in job["batches"][:steps]:
        n = batch["label"].shape[0] // mesh.dp
        rows = slice(mesh.dp_rank * n, (mesh.dp_rank + 1) * n)
        state, m = T.train_step(state, job["cfg_train"], opt,
                                {k: v[rows] for k, v in batch.items()},
                                mixed_precision=mixed_precision, mesh=mesh)
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "params": T.tree_map(lambda t: t.detach().clone(),
                                 gather_params(state.params, mesh))}


def case_checkpoint(job, dp, tp, save_dir, load_dir):
    """Two mesh steps saved into ``save_dir``; then the one-device
    checkpoint of ``load_dir`` restored onto the mesh and one step taken."""
    from fpqvar_tpu_torch.parallel import gather_params

    mesh = _mesh(job, dp, tp)
    opt = T.make_optimizer(peak_lr=job["lr"], grad_clip=job["clip"])

    def step(state, batch):
        n = batch["label"].shape[0] // mesh.dp
        rows = slice(mesh.dp_rank * n, (mesh.dp_rank + 1) * n)
        return T.train_step(state, job["cfg_train"], opt,
                            {k: v[rows] for k, v in batch.items()},
                            mesh=mesh)[0]

    state = T.make_train_state(shard_params(job["train_params"], mesh), opt)
    for batch in job["batches"][:2]:
        state = step(state, batch)
    mngr = R.make_manager(save_dir)
    saved = R.save_train_state(mngr, state, mesh)
    fresh = T.make_train_state(shard_params(job["train_params"], mesh), opt)
    info, restored, start = R.auto_resume(R.make_manager(load_dir), fresh,
                                          mesh)
    restored = step(restored, job["batches"][start])
    return {"saved": saved, "start": start, "step": restored.step,
            "params": T.tree_map(lambda t: t.detach().clone(),
                                 gather_params(restored.params, mesh))}


def case_eval_set(job, dp, tp, out_dir, **kw):
    """``generate_eval_set`` under a mesh -> the number of generations."""
    from fpqvar_tpu_torch.eval.pipeline import generate_eval_set

    mesh = _mesh(job, dp, tp)
    gen = VARGenerator(job["cfg"], job["qcfg"], job["gen_cfg"],
                       cache_dtype=torch.float32, compute_dtype=torch.float32,
                       device="cpu", fuse_steps=False, mesh=mesh)
    return generate_eval_set(gen, shard_params(job["params"], mesh),
                             job["vae"], out_dir, mesh=mesh, **kw)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(cmds, envs, timeout: float) -> list:
    """Run one process a rank to its end -> their outputs; a rank that
    fails fails the call with its output."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join([os.path.dirname(here), here])
    procs = [subprocess.Popen(cmd, env=dict(os.environ, OMP_NUM_THREADS="1",
                                            PYTHONPATH=path, **env),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for cmd, env in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{out[-3000:]}")
    return outs


def _torchrun_env(world: int) -> list:
    port = str(_free_port())
    return [dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                 WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
            for r in range(world)]


def run_ranks(world: int, job: dict, tmp: str, timeout: float = 240.0):
    """Run ``job`` on ``world`` gloo ranks (one process each, torchrun's
    environment) -> one result dict per rank."""
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "job.pt")
    torch.save(job, path)
    cmd = [sys.executable, os.path.abspath(__file__), path, tmp]
    _launch([cmd] * world, _torchrun_env(world), timeout)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_cli_ranks(module: str, argv: list, world: int,
                  coordinator: bool = False, timeout: float = 240.0) -> list:
    """``python -m module argv`` as ``world`` ranks: started with
    torchrun's environment, or with ``coordinator`` each given
    ``--coordinator 127.0.0.1:<port> --num-hosts world --host-id r`` ->
    the ranks' outputs."""
    cmd = [sys.executable, "-m", module] + list(argv)
    if not coordinator:
        return _launch([cmd] * world, _torchrun_env(world), timeout)
    addr = f"127.0.0.1:{_free_port()}"
    return _launch([cmd + ["--coordinator", addr, "--num-hosts", str(world),
                           "--host-id", str(r)] for r in range(world)],
                   [{}] * world, timeout)


CASES = {"shards": case_shards, "generate": case_generate,
         "errors": case_errors, "train": case_train,
         "col_bias": case_col_bias,
         "checkpoint": case_checkpoint, "eval_set": case_eval_set}


def main(job_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    _install()
    job = torch.load(job_path, weights_only=False)
    results = {}
    for name, case, kwargs in job["cases"]:
        results[name] = CASES[case](job, **kwargs)
    torch.save(results, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
