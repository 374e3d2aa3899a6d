"""Build and load the port's CUDA kernels.

A ``csrc/<name>.cu`` with a plain C interface is compiled at first use with
``nvcc`` for ``sm_90a`` into ``fpqvar_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ctypes; the caller sets the C signatures.
Only sources in the repository are built.  Nothing here runs at import
time: the CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()
#: source name -> nvcc's output (ptxas register / shared-memory report)
build_logs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact source was built
    already; returns the shared library's path.  Raises with nvcc's output
    if the build fails."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
