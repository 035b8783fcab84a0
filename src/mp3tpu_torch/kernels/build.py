"""Build a native source of this package at first use: a CUDA source with
nvcc (the kernels, loaded with ctypes by their wrappers) or the C++ host
library with g++ (the unpacker and the encoder's stream mux in one library,
loaded by bitstream/native.py). Beside them, for
mp3tpu_torch/sanitize.py only: the same host library under AddressSanitizer
and UndefinedBehaviorSanitizer (build_sanitized), and the executables of the
harnesses csrc/fuzz_main.cpp and csrc/prof_main.cpp, each linked with
unpack.cpp (build_tool); each has a hash of its own, and the production
library's flags and name do not change for them.

Each source in csrc/ has a plain C interface and includes no PyTorch header,
so it compiles in seconds. The sources are package data: csrc/ lies beside the
package's modules, in a checkout and in an installed copy alike. The library
goes to the build directory (build_dir(): the environment variable
MP3TPU_TORCH_BUILD_DIR if set; build/mp3tpu_torch/ at the root of the checkout
when the package runs from one; else a per-user cache directory,
$XDG_CACHE_HOME or ~/.cache, /mp3tpu_torch), named by a hash of the source,
the headers beside it and the flags (for g++, also the host CPU's features,
since -march=native follows them): an edited source is rebuilt at its first
use, an unchanged one is loaded as it is. A lock file per library serialises its builds across
processes. The compiler's messages (with ptxas's register and shared-memory
report) are kept beside the library in a .log file.
"""
from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR_ENV = "MP3TPU_TORCH_BUILD_DIR"
# no --use_fast_math: it would change cbrtf, exp2f and division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# src/mp3tpu/native/Makefile's flags less -flto, whose linker plugin not
# every host has
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-std=c++17", "-fPIC",
             "-Wall", "-Wextra", "-fno-exceptions", "-shared")
# sources compiled into the library of the source that names it, as the
# Makefile links them into one
COMPANIONS = {"unpack.cpp": ("mux_stream.cpp",)}
# src/mp3tpu/native/Makefile's asan target: the host library under
# AddressSanitizer and UndefinedBehaviorSanitizer
SANITIZE_FLAGS = ("-O1", "-g", "-std=c++17", "-fPIC",
                  "-fsanitize=address,undefined")
# the harnesses of csrc/, each linked with unpack.cpp into an executable: the
# fuzz harness under the sanitizers (the Makefile's fuzz_driver target), the
# section profiler at the production optimisation with its cycle counters
# compiled in
TOOL_FLAGS = {
    "fuzz_main.cpp": SANITIZE_FLAGS,
    "prof_main.cpp": ("-O3", "-march=native", "-funroll-loops", "-std=c++17",
                      "-DMP3TPU_PROF_SECTIONS"),
}


def build_dir() -> Path:
    """Where the libraries go, read at each build: $MP3TPU_TORCH_BUILD_DIR;
    else build/mp3tpu_torch/ of the checkout the package runs from (the
    package lies in its src/, beside a pyproject.toml); else the per-user
    cache directory."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    if CSRC.parents[1].name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "mp3tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "mp3tpu_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH nor under CUDA_HOME; "
                       "the CUDA kernels of mp3tpu_torch cannot be built")


def cxx_path() -> str | None:
    """g++, or None where the host has none."""
    return shutil.which("g++")


def _cpu_features() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


@contextlib.contextmanager
def build_lock(name: str):
    """Hold the build directory's lock of library `name` (one build of it at
    a time, across processes; other libraries build meanwhile)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{name}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(source: str, defines: tuple = ()) -> Path:
    """Compile csrc/`source` (.cu with nvcc, .cpp with g++), with the macros
    `defines` ("NAME=VALUE") set and its COMPANIONS beside it, unless its
    library exists; return the path. Raises with the compiler's messages
    when the build fails."""
    src = CSRC / source
    cuda = src.suffix == ".cu"
    flags = (NVCC_FLAGS if cuda else CXX_FLAGS) + tuple(f"-D{d}" for d in defines)
    srcs = [src] + [CSRC / c for c in COMPANIONS.get(source, ())]
    return _compile(src.stem, srcs, flags, cuda=cuda, cpu=not cuda, suffix=".so")


def build_sanitized() -> Path:
    """The host library (csrc/unpack.cpp and its COMPANIONS) under
    AddressSanitizer and UndefinedBehaviorSanitizer (SANITIZE_FLAGS), named
    unpack-asan-<hash>.so. A process that loads it must have the sanitizer's
    runtime loaded first (LD_PRELOAD, as sanitize.py's children do)."""
    srcs = [CSRC / "unpack.cpp"] + [CSRC / c for c in COMPANIONS["unpack.cpp"]]
    return _compile("unpack-asan", srcs, SANITIZE_FLAGS + ("-shared",),
                    cuda=False, cpu=False, suffix=".so")


def build_tool(source: str) -> Path:
    """The executable of csrc/`source` (a key of TOOL_FLAGS) linked with
    csrc/unpack.cpp, built with its TOOL_FLAGS; return its path."""
    flags = TOOL_FLAGS[source]
    srcs = [CSRC / source, CSRC / "unpack.cpp"]
    return _compile(Path(source).stem, srcs, flags, cuda=False,
                    cpu="-march=native" in flags, suffix="")


def _compile(stem: str, srcs: list, flags: tuple, cuda: bool, cpu: bool,
             suffix: str) -> Path:
    """Compile `srcs` with `flags` into build_dir()/<stem>-<hash><suffix>,
    unless it exists; the hash covers the flags, the sources, every header
    of csrc/ and, where `cpu`, the host CPU's features."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in srcs:
        digest.update(f.read_bytes())
    for h in sorted(CSRC.glob("*.h")):
        digest.update(h.read_bytes())
    if cpu:
        digest.update(_cpu_features())
    name = f"{stem}-{digest.hexdigest()[:16]}"
    out = build_dir() / f"{name}{suffix}"
    if out.exists():
        return out
    with build_lock(name):
        if out.exists():  # built by another process while this one waited
            return out
        if cuda:
            compiler = nvcc_path()
        elif (compiler := cxx_path()) is None:
            raise RuntimeError(f"no g++ to build {srcs[0]}")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), *map(str, srcs)],
                              capture_output=True, text=True)
        (build_dir() / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed to build {srcs[0]}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out
