"""Build a native source of this package at first use: a CUDA source with
nvcc (the kernels, loaded with ctypes by their wrappers) or the C++ host
library with g++ (the unpacker, the encoder's row emitter and the stream mux
in one library, loaded by bitstream/native.py).

Each source in csrc/ has a plain C interface and includes no PyTorch header,
so it compiles in seconds. The library goes to build/mp3tpu_torch/ at the root
of the checkout, named by a hash of the source, the headers beside it and the
flags (for g++, also the host CPU's features, since -march=native follows
them): an edited source is rebuilt at its first use, an unchanged one is
loaded as it is. A lock file per library serialises its builds across
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "mp3tpu_torch"
# no --use_fast_math: it would change cbrtf, exp2f and division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# src/mp3tpu/native/Makefile's flags less -flto, whose linker plugin not
# every host has
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-std=c++17", "-fPIC",
             "-Wall", "-Wextra", "-fno-exceptions", "-shared")
# sources compiled into the library of the source that names it, as the
# Makefile links them into one
COMPANIONS = {"unpack.cpp": ("encode_rows.cpp", "mux_stream.cpp")}


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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as f:
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
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in srcs:
        digest.update(f.read_bytes())
    for h in sorted(CSRC.glob("*.h")):
        digest.update(h.read_bytes())
    if not cuda:
        digest.update(_cpu_features())
    out = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    with build_lock(out.stem):
        if out.exists():  # built by another process while this one waited
            return out
        if cuda:
            compiler = nvcc_path()
        elif (compiler := cxx_path()) is None:
            raise RuntimeError(f"no g++ to build {src}")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), *map(str, srcs)],
                              capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed to build {src}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out
