"""Build and load the port's CUDA kernels.

A ``csrc/<name>.cu`` with a plain C interface is compiled at first use with
``nvcc`` for ``sm_90a`` into ``fpqvar_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ctypes.  Every source exports
``int <name>(..., void* stream)``, which launches its kernel on ``stream``
and returns the launch's ``cudaError_t``, and ``const char*
<name>_error_string(int)``.  Only sources in the repository are built.
Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
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
    """Compile ``csrc/<name>.cu`` unless this exact source (with the
    shared headers ``csrc/*.cuh``) was built already; returns the shared
    library's path.  Raises with nvcc's output if the build fails."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
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


def load(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    the C signature of ``<name>``: ``argtypes`` then the stream."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(lib: ctypes.CDLL, name: str, device, *args) -> None:
    """Call ``<name>(*args, stream)`` on the current stream of ``device``
    (a CUDA ``torch.device``); raise if the launch was refused."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
