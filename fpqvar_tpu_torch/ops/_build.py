"""Build and load the port's CUDA kernels.

A ``csrc/<name>.cu`` with a plain C interface is compiled at first use with
``nvcc`` for ``sm_90a`` and loaded with ctypes.  The libraries go to
``fpqvar_tpu_torch/_build/`` (listed in ``.gitignore``) where the package
directory is writable, as in a checkout, and otherwise (an installed
package) to ``$XDG_CACHE_HOME/fpqvar_tpu_torch/`` or
``~/.cache/fpqvar_tpu_torch/``.  Every source exports
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
PKG_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()
#: source name -> nvcc's output (ptxas register / shared-memory report,
#: and its warnings), kept beside each library and read back with it
build_logs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _writable(path: Path) -> bool:
    """``path`` can be written, or created in its nearest existing
    ancestor."""
    while not path.exists():
        if path.parent == path:
            return False
        path = path.parent
    return os.access(path, os.W_OK | os.X_OK)


def build_dir() -> Path:
    """Where the libraries are built: the package's ``_build/`` if it is
    writable, else the user cache directory."""
    if _writable(PKG_BUILD_DIR):
        return PKG_BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "fpqvar_tpu_torch"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact source (with the
    shared headers ``csrc/*.cuh``) was built already; returns the shared
    library's path.  Raises with nvcc's output if the build fails."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    where = build_dir()
    out = where / f"lib{name}-{digest[:12]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        if name not in build_logs and log.exists():
            build_logs[name] = log.read_text()
        return out
    where.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    log.write_text(proc.stdout)
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
