"""How the port's kernels are shipped and where they are built.

- ``pyproject.toml``'s package data for ``fpqvar_tpu_torch`` matches every
  file of ``fpqvar_tpu_torch/csrc/``: the sources and the shared headers
  they include, so that an installed package can build its kernels.
- ``_build`` builds into the package's ``_build/`` where that directory is
  writable (a checkout), else into the user cache directory
  (``$XDG_CACHE_HOME`` or ``~/.cache``, under ``fpqvar_tpu_torch/``), and
  names each library by a digest of its source and every header.  nvcc is
  replaced by a stub that writes the output file: this machine has none.
"""
import fnmatch
import subprocess
import tomllib
from pathlib import Path

import pytest

from fpqvar_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent


def test_package_data_ships_every_kernel_file():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["fpqvar_tpu_torch"]
    files = sorted(p.relative_to(_build.CSRC.parent).as_posix()
                   for p in _build.CSRC.iterdir())
    assert any(f.endswith(".cuh") for f in files)
    assert any(f.endswith(".cu") for f in files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f, p) for p in patterns)]
    assert not missing, f"not shipped: {missing}"


def _fake_nvcc(monkeypatch, tmp_path):
    """A csrc/ with one source and one header, and an nvcc stub."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def run(cmd, **kwargs):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, stdout="")

    monkeypatch.setattr(_build.subprocess, "run", run)
    return csrc


@pytest.mark.parametrize("writable,xdg", [(True, True), (False, True),
                                          (False, False)])
def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path,
                                                writable, xdg):
    csrc = _fake_nvcc(monkeypatch, tmp_path)
    pkg_build = tmp_path / "pkg" / "_build"
    monkeypatch.setattr(_build, "PKG_BUILD_DIR", pkg_build)
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    if not writable:
        real = _build._writable
        monkeypatch.setattr(
            _build, "_writable",
            lambda p: False if p == pkg_build else real(p))
    want = (pkg_build if writable else
            (tmp_path / "xdg" if xdg else home / ".cache") /
            "fpqvar_tpu_torch")
    assert _build.build_dir() == want
    first = _build.build("k")
    assert first.parent == want and first.exists()
    assert _build.build("k") == first              # built once
    (csrc / "h.cuh").write_text("// v2\n")         # a header changed
    second = _build.build("k")
    assert second != first and second.parent == want
    assert not pkg_build.exists() or writable


def test_writable_walks_up_to_an_existing_directory(monkeypatch, tmp_path):
    """A directory not yet made is writable where its nearest existing
    ancestor is; the access check is asked of that ancestor."""
    asked = []

    def access(path, mode):
        asked.append(Path(path))
        return Path(path) != tmp_path

    assert _build._writable(tmp_path / "a" / "b")
    monkeypatch.setattr(_build.os, "access", access)
    assert not _build._writable(tmp_path / "a" / "b")
    assert asked == [tmp_path]
