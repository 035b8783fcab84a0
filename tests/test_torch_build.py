"""Where the port builds its native code (kernels/build.py): the sources are
package data beside the modules, and the build directory is the environment's,
the checkout's, or the user's cache: so a copy of the package outside any
checkout still builds and loads its C++ library."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mp3tpu_torch.kernels import build

REPO = Path(__file__).resolve().parents[1]


def test_sources_lie_beside_the_package():
    assert build.CSRC == REPO / "src" / "mp3tpu_torch" / "csrc"
    names = {p.name for p in build.CSRC.iterdir()}
    assert {"fused_z.cu", "synth.cu", "unpack.cpp", "mux_stream.cpp",
            "spec_tables.h"} <= names


def test_pyproject_names_the_sources_as_package_data():
    import tomllib
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert set(data["mp3tpu_torch"]) == {"csrc/*.cu", "csrc/*.cpp", "csrc/*.h"}


def test_build_dir_in_a_checkout(monkeypatch):
    monkeypatch.delenv(build.BUILD_DIR_ENV, raising=False)
    assert build.build_dir() == REPO / "build" / "mp3tpu_torch"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/mp3tpu_torch/" in ignored


def test_build_dir_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path / "libs"))
    assert build.build_dir() == tmp_path / "libs"
    with build.build_lock("probe"):         # made at first use
        assert (tmp_path / "libs" / "probe.lock").exists()


CODE = r"""
import sys
sys.modules["jax"] = sys.modules["mp3tpu"] = None
from mp3tpu_torch.kernels import build
print("DIR", build.build_dir())
if build.cxx_path():
    from mp3tpu_torch.bitstream import native
    assert native._load() is not None
    print("LIB", build.build("unpack.cpp"))
"""


@pytest.mark.parametrize("how", ["xdg", "home", "env"])
def test_installed_copy_builds_outside_a_checkout(tmp_path, how):
    """A copy of the package under site-packages-like directories, no
    checkout around it: the build goes to the cache directory (or where the
    environment says), and the C++ library builds and loads from there."""
    site = tmp_path / "lib" / "site-packages"
    shutil.copytree(REPO / "src" / "mp3tpu_torch", site / "mp3tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XDG_CACHE_HOME", build.BUILD_DIR_ENV)}
    env.update(PYTHONPATH=str(site), HOME=str(tmp_path / "home"))
    want = tmp_path / "home" / ".cache" / "mp3tpu_torch"
    if how == "xdg":
        env["XDG_CACHE_HOME"] = str(tmp_path / "xdg")
        want = tmp_path / "xdg" / "mp3tpu_torch"
    elif how == "env":
        env[build.BUILD_DIR_ENV] = str(tmp_path / "chosen")
        want = tmp_path / "chosen"
    out = subprocess.run([sys.executable, "-c", CODE], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines() if " " in ln)
    assert Path(lines["DIR"]) == want
    if "LIB" in lines:
        assert Path(lines["LIB"]).parent == want and Path(lines["LIB"]).exists()
    assert not (tmp_path / "build").exists()
