"""Sanitizer runs over the port's native code, and the section profile of its
C++ unpacker: the counterpart of the JAX package's native hardening
(src/mp3tpu/native/fuzz_main.cpp and prof_main.cpp with the Makefile's
asan, fuzz_driver and profiling builds, tests/test_fuzz_native.py and
tools/mux_asan_fuzz.py), which stays the JAX package's.

Three parts:

* host, on the CPU, under AddressSanitizer and UndefinedBehaviorSanitizer:
  the fuzz harness csrc/fuzz_main.cpp (random byte strings salted with sync
  words, then copies of a real stream with 64 bytes mutated each, through
  mp3tpu_probe / mp3tpu_unpack in all four plane modes); and 300 trials of
  mp3tpu_mux_stream with tools/mux_asan_fuzz.py's randomised, walk-valid
  inputs and edge shapes. The mux runs through the sanitized library
  (kernels/build.build_sanitized) and is held to the production library
  byte for byte. Each part runs in a child
  process with the sanitizer's runtime preloaded (this Python was not built
  with it); any report fails the run with its last 2,000 characters.
* device, on a CUDA card: the kernel cases (fused_cases, synth_cases: every plane
  family csrc/fused_z.cu reads at 1 x 1, 8 x 32, 64 x 32 and 36 x 130
  pairs, pair counts around the persistent grid times its ring's stages,
  symbols and exponents at the extremes csrc/unpack.cpp can write, stereo
  bytes at and beyond the palette; csrc/synth.cu at S = 1, 8, 64, 256,
  36 x 130, granule counts around its tile and a window split that carries
  the state; csrc/huffman_dfa.cu at 1, 31, 33, 4,096 and 131,072 rows
  and around its persistent grid's width, at 8 to 2,048 bits a row, some
  not a multiple of 32, through every kind of automaton, on random bits
  and on real codewords; csrc/rate_bisect.cu's bisection, full range and
  windowed, and its count, at every sample rate of the encoder's tables and
  both region splits, on random rows and edge rows, at 1, 7 and 33 rows and
  around its persistent grid's rows), each held to its plain version, and
  decode_batch of clean,
  corrupted (soak.py's three kinds) and junk streams. On the card each
  kernel case launches RERUNS times, bit-identical, into outputs between
  guard bands: a write outside its output or a value left unwritten fails
  the case (what memcheck and initcheck would report of the outputs,
  without them; reads out of bounds show only as wrong values). The part
  then runs the cases in a child process under compute-sanitizer once per tool
  (memcheck, racecheck, synccheck, initcheck; the decode path under
  memcheck and initcheck), checking only the port's kernels where they
  are the case, and fails on any error a tool reports, or where the tool
  cannot run.
* profile, on the CPU: csrc/prof_main.cpp built with the unpacker's cycle
  counters (kernels/build.build_tool), run on the bench's CBR clip in the
  bench's plane mode (4-bit plane + byte exponents, 4 | 0x10): cycles and
  share per section of the unpacker, and the fast-LUT hit rate per
  Huffman table.

    python -m mp3tpu_torch.sanitize [--host] [--device] [--profile] [--out PATH]

runs the parts named (host and profile when none is), prints one JSON line
per part, writes the whole report to --out when given, and exits non-zero
when a part fails. Importing this module imports no torch: the host part's
children load only numpy and the sanitized library.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .kernels import build

SRC = Path(__file__).resolve().parents[1]   # the directory holding the package
CLIPS = SRC.parent / "tests" / "torch_clips"
BENCH_CLIP = CLIPS / "bench_cbr128.mp3"
# what a sanitizer prints when it reports
REPORT = re.compile(r"ERROR: AddressSanitizer|ERROR: LeakSanitizer|"
                    r"runtime error:|UndefinedBehaviorSanitizer")
# the bench's plane mode: 4-bit plane, position-free escape sideband, byte
# exponents (the fuzz harness rotates through it and 12, 8, 4)
BENCH_PLANES = 4 | 0x10
FUZZ_SEED = 0  # of the mux trials


class SanitizerError(AssertionError):
    """A sanitizer reported an error, or a sanitized run failed."""


class SanitizerUnavailable(RuntimeError):
    """The sanitizer cannot run here; the message holds its own words."""


# ---------------------------------------------------------------- host

def sanitizer_env() -> dict:
    """The environment of a sanitized child: the ASan runtime preloaded
    (g++ -print-file-name=libasan.so), leak checks off (the Python runtime's
    own allocations would be reported), UBSan halting on its first report,
    and this package importable."""
    cxx = build.cxx_path()
    if cxx is None:
        raise RuntimeError("no g++: the sanitized builds need it")
    lib = subprocess.run([cxx, "-print-file-name=libasan.so"], check=True,
                         capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(lib):
        raise RuntimeError(f"g++ has no libasan.so (it answered {lib!r})")
    env = dict(os.environ, LD_PRELOAD=lib, ASAN_OPTIONS="detect_leaks=0",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
    return _importable(env)


def _importable(env: dict) -> dict:
    """`env` with this package's directory first on PYTHONPATH."""
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def build_host() -> None:
    """The host part's three builds (the fuzz harness, the sanitized library
    and the production library), at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(build.build_tool, "fuzz_main.cpp"),
                  ex.submit(build.build_sanitized),
                  ex.submit(build.build, "unpack.cpp")]:
            f.result()


def run_sanitized(argv: list, what: str, stdin: bytes | None = None) -> str:
    """Run argv under sanitizer_env(); its standard output. Raises
    SanitizerError when it exits non-zero or a sanitizer reported."""
    proc = subprocess.run(argv, input=stdin, env=sanitizer_env(),
                          capture_output=True, timeout=900)
    out = proc.stdout.decode(errors="replace")
    err = proc.stderr.decode(errors="replace")
    if proc.returncode != 0 or REPORT.search(err) or REPORT.search(out):
        heads = [ln for ln in err.splitlines()
                 if REPORT.search(ln) or ln.startswith("SUMMARY:")]
        raise SanitizerError(f"{what}: exit code {proc.returncode}; "
                             + "\n".join(heads[:4]) + "\nthe last 2,000 "
                             f"characters of its errors:\n{err[-2000:]}")
    return out


def fuzz_unpacker(stream: bytes, iters: int = 200) -> dict:
    """csrc/fuzz_main.cpp under the sanitizers: `iters` random byte strings,
    then `iters` mutated copies of `stream`. Raises unless it prints
    "fuzz ok" with no report."""
    exe = build.build_tool("fuzz_main.cpp")
    t0 = time.perf_counter()
    out = run_sanitized([str(exe), str(iters)], "fuzz harness", stdin=stream)
    if "fuzz ok" not in out:
        raise SanitizerError(f"fuzz harness: no 'fuzz ok' in {out[-500:]!r}")
    return {"iters": iters, "stream_bytes": len(stream),
            "seconds": time.perf_counter() - t0}


def fuzz_mux(trials: int = 300) -> dict:
    """mp3tpu_mux_stream under the sanitizers (tools/mux_asan_fuzz.py's
    scheme), `trials` of them through the sanitized library in a child
    process: every result within out_cap, and equal to the production
    library's, bytes included. Returns the child's summary."""
    asan = build.build_sanitized()
    prod = build.build("unpack.cpp")
    t0 = time.perf_counter()
    out = run_sanitized([sys.executable, "-m", "mp3tpu_torch.sanitize",
                         "--child", str(asan), str(prod), str(trials)],
                        "mux fuzz")
    summary = json.loads(out.strip().splitlines()[-1])
    summary["seconds"] = time.perf_counter() - t0
    return summary


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I32 = ctypes.c_void_p, ctypes.c_int32
    lib.mp3tpu_mux_stream.restype = ctypes.c_int64
    lib.mp3tpu_mux_stream.argtypes = (
        [P, ctypes.c_int64, ctypes.c_int64] + [P] * 11 + [I32] * 6
        + [P, ctypes.c_int64])
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def mux_trials(libs: list, trials: int, seed: int) -> dict:
    """tools/mux_asan_fuzz.py's trials, through each library of `libs`;
    every fifth gives an output of the stream's own size or 1-8 bytes
    short of it. Raises unless each result is within out_cap and all
    libraries agree."""
    rng = np.random.default_rng(seed)
    results = {"ok": 0, "refused": 0}
    for trial in range(trials):
        nch = int(rng.integers(1, 3))
        n_frames = int(rng.integers(1, 40))
        n_gc = n_frames * 2 * nch
        cap = int(rng.integers(1, 521))
        sr = [44100, 48000, 32000][int(rng.integers(3))]
        br = [32, 128, 320][int(rng.integers(3))]
        cap_bits = (144 * br * 1000 // sr - 36) * 8 // (2 * nch)
        p23 = rng.integers(0, min(cap_bits, min(cap * 8, 4095)) + 1,
                           n_gc).astype(np.int32)
        if trial % 7 == 0:
            p23[:] = 0
        if trial % 11 == 0:
            p23[:] = min(cap * 8, 4095)  # may overdraft: must return -3 cleanly
        bits = rng.integers(0, 256, (n_gc, cap), dtype=np.uint8)

        def i32(hi, shape=n_gc):
            return rng.integers(0, hi, shape).astype(np.int32)

        tsel, sbg = i32(32, (n_gc, 3)), i32(8, (n_gc, 3))
        ms = rng.integers(0, 2, n_frames).astype(np.uint8)
        out_cap = n_frames * (144 * br * 1000 // sr + 1)
        fields = [p23, i32(512), i32(256), i32(16), i32(4), tsel, sbg,
                  i32(16), i32(8), i32(2), ms]
        pad = int(rng.integers(16))

        def mux(lib, room):
            out = np.zeros(room, np.uint8)
            r = lib.mp3tpu_mux_stream(
                _ptr(bits), n_gc, cap, *map(_ptr, fields), nch, 0, pad, sr,
                br * 1000, 400, _ptr(out), room)
            if r > room:
                raise AssertionError(f"mux trial {trial}: {r} bytes > "
                                     f"out_cap {room}")
            return r, out[:max(r, 0)].tobytes()

        if trial % 5 == 3:  # the stream's own size, or 1-8 bytes short of it
            need = mux(libs[-1], out_cap)[0]
            if need > 0:
                out_cap = need - int(rng.integers(0, min(9, need + 1)))
        got = [mux(lib, out_cap) for lib in libs]
        if any(g != got[0] for g in got[1:]):
            raise AssertionError(f"mux trial {trial}: the libraries differ")
        results["ok" if got[0][0] >= 0 else "refused"] += 1
    return results


def child_main(argv: list) -> int:
    """The sanitized child: `asan_lib prod_lib trials` of the mux fuzz;
    prints its summary as the last line."""
    asan, prod, trials = argv
    libs = [_declare(ctypes.CDLL(p)) for p in (asan, prod)]
    summary = {"kind": "mux", "trials": int(trials),
               **mux_trials(libs, int(trials), FUZZ_SEED)}
    print(json.dumps(summary), flush=True)
    return 0


def host() -> dict:
    """The host part: the fuzz harness and the mux fuzz under the
    sanitizers."""
    build_host()
    return {"fuzz_driver": fuzz_unpacker(BENCH_CLIP.read_bytes()),
            "mux": fuzz_mux()}


# ---------------------------------------------------------------- profile

# the unpacker's sections, in prof_main.cpp's order
SECTIONS = ("scan_frames", "sideinfo+crc+resv", "granulebits_init",
            "scalefactors", "huff_big_values", "huff_count1", "plane_pack",
            "exponents", "stereo_modes", "spec_total(outer)")
_SECTION = re.compile(r"^(\S+)\s+(\d+) cyc\s+([\d.]+)%$")
_TABLE = re.compile(r"^\s+t(\d+)\s+(\d+)\s+fast\s+([\d.]+)%$")


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it: model name, family and
    model (where a hypervisor hides the name), logical CPUs."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                if not line.strip():
                    break
                info[key.strip()] = val.strip()
    except OSError:
        pass
    return (f"{info.get('model name', 'unknown')} (family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}), "
            f"{os.cpu_count()} logical CPUs")


def parse_profile(text: str) -> dict:
    """prof_main's table -> {"granules", "iters", "sections": [{name,
    cycles, share}], "total_cycles", "tables": [{table, pairs,
    fast_hit}]}; shares in percent of the total of sections 0-14
    (spec_total(outer) overlaps sections 4-5, as prof_main.cpp prints it)."""
    rep = {"sections": [], "tables": []}
    for line in text.splitlines():
        if m := re.match(r"done (\d+) granules x (\d+) iters", line):
            rep["granules"], rep["iters"] = int(m.group(1)), int(m.group(2))
        elif m := re.match(r"total\(0-14\)\s+(\d+) cyc", line):
            rep["total_cycles"] = int(m.group(1))
        elif m := _SECTION.match(line):
            rep["sections"].append({"name": m.group(1),
                                    "cycles": int(m.group(2)),
                                    "share": float(m.group(3))})
        elif m := _TABLE.match(line):
            rep["tables"].append({"table": int(m.group(1)),
                                  "pairs": int(m.group(2)),
                                  "fast_hit": float(m.group(3))})
    missing = set(SECTIONS) - {s["name"] for s in rep["sections"]}
    if missing or "total_cycles" not in rep or not rep["tables"]:
        raise RuntimeError(f"prof_main printed no {sorted(missing) or 'table'}:"
                           f"\n{text[-2000:]}")
    return rep


def profile(iters: int = 200) -> dict:
    """csrc/prof_main.cpp on BENCH_CLIP, `iters` unpacks in the bench's
    plane mode: the section table (parse_profile) with the host's CPU."""
    exe = build.build_tool("prof_main.cpp")
    t0 = time.perf_counter()
    proc = subprocess.run([str(exe), str(iters)], input=BENCH_CLIP.read_bytes(),
                          capture_output=True, timeout=600)
    wall = time.perf_counter() - t0
    text = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"prof_main exited {proc.returncode}: {text[-500:]}"
                           f"{proc.stderr.decode(errors='replace')[-1500:]}")
    return {"cpu": cpu_model(), "stream": BENCH_CLIP.name, "planes": BENCH_PLANES,
            "wall_s": wall, **parse_profile(text)}


# ---------------------------------------------------------------- device

# The extremes of what csrc/unpack.cpp writes, read off its writes:
# |is| <= 15 + 2^13 - 1 (big values with 13 linbits); an exponent is
# global_gain - 210 - 8 * subblock_gain - shift * scalefactor: at most
# 255 - 210, at least -210 - 8 * 7 - 4 * 31 (scalefac_scale 1, a 5-bit LSF
# intensity scalefactor); stereo bytes index the palette's 144 rows
# (idx_lsf(31, 1, ms) = 143 is the largest).
IS_MAX = 15 + (1 << 13) - 1
EXP_MIN = -210 - 8 * 7 - 4 * 31
EXP_MAX = 255 - 210
N_PALETTE = 144
# H100 SXM: SMs, and the persistent grid's blocks a SM of each fused kernel
# with int32 symbols; read from the card where there is one
H100_SMS = 132
H100_BLOCKS = {"fused_z": 6, "fused_frontend": 8}
FZ_STAGES = 2      # csrc/fused_z.cu kStages
SYNTH_TILE = 4     # csrc/synth.cu kGran: granules a tile owns
FUSED_SHAPES = ((1, 1), (8, 32), (64, 32), (36, 130))
SYNTH_SHAPES = ((1, 32), (8, 32), (64, 32), (256, 32), (36, 130),
                (3, SYNTH_TILE - 1), (3, SYNTH_TILE), (3, SYNTH_TILE + 1))
# a guarded output (guarded()): GUARD words before and after it, each the
# bits of a NaN with a payload that no kernel output takes (every output of
# the cases is finite); each kernel case launches RERUNS times
GUARD = 4096
GUARD_BITS = 0x7FC0DEAD
# the guard of a one-byte output (bool): neither 0 nor 1
GUARD_BYTE = 0xAD
RERUNS = 3
SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# the child's groups of cases, the kernel compute-sanitizer checks in each
# (None: everything the group launches) and the tools that run it
GROUPS = {"fused_z": ("fused_z_kernel", SANITIZER_TOOLS),
          "synth": ("synth_kernel", SANITIZER_TOOLS),
          "huffman_dfa": ("dfa_count_kernel", SANITIZER_TOOLS),
          "rate_bisect": ("rate_bisect_kernel", SANITIZER_TOOLS),
          "decode": (None, ("memcheck", "initcheck"))}
ERROR_EXIT = 86
# the chain's cases: every pairing of DFA_ROWS rows (and the persistent
# grid's width, one less and one more), DFA_BITS bits a row (8 and 264 not
# multiples of 32, 259 not even of 8) and the automata of every kind (count1
# table A; big-values tables 13, 24 with linbits, 31 with the most chain
# states); then CODEWORD_ROWS rows of CODEWORD_BITS bits of real codewords
# of each automaton
DFA_ROWS = (1, 31, 33, 4096, 131072)
DFA_BITS = (8, 256, 259, 264, 2048)
DFA_TABLES = ("count1a", 13, 24, 31)
CODEWORD_ROWS, CODEWORD_BITS = 33, 2048


def persistent_grid(name: str, device) -> int:
    """Blocks of kernel `name`'s persistent grid with int32 symbols: read
    from the card, or H100's where `device` is the CPU."""
    import torch
    if torch.device(device).type != "cuda":
        return H100_SMS * H100_BLOCKS[name]
    from .kernels import selfcheck as sc
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * sc.blocks_per_sm(name)


def extreme_symbols(S: int, G: int, seed: int, types, bt_dtype, device,
                    beyond_palette: bool = False) -> list:
    """Symbols [S, G, ...] at the extremes of csrc/unpack.cpp's writes:
    |is| = IS_MAX on about half the lines (stream 0 all zeros), exponents
    EXP_MIN and EXP_MAX, block types 0-3 with mixed flags of any byte
    value (uint8), stereo bytes N_PALETTE - 2 and N_PALETTE - 1, or, with
    `beyond_palette`, from N_PALETTE - 1 up to 255."""
    import torch
    rng = np.random.default_rng(seed)
    shape = (S, G, 2)
    is_ = np.where(rng.random(shape + (576,)) < 0.5, IS_MAX, 0)
    is_ = (is_ * rng.choice((-1, 1), shape + (576,))).astype(np.int32)
    is_[0] = 0
    exp = rng.choice((EXP_MIN, EXP_MAX), shape + (64,)).astype(np.int32)
    bt = (np.arange(S * G * 2) % 4).reshape(shape)
    mixed = rng.integers(0, 256, shape).astype(np.uint8)
    hi = 256 if beyond_palette else N_PALETTE
    smode = rng.integers(N_PALETTE - (1 if beyond_palette else 2), hi,
                         (S, G, 64)).astype(np.uint8)
    t = lambda a, dt: torch.from_numpy(a).to(device=device, dtype=dt)
    return [t(is_, types[0]), t(exp, types[1]), t(bt, bt_dtype),
            t(mixed, torch.uint8), t(smode, torch.uint8)]


def padded_palette(tables):
    """A copy of `tables` whose palette has 256 rows, rows N_PALETTE on
    zero: the plain version then computes what the kernel does with a
    stereo byte beyond the palette (fused_z.cu gives the band zeros)."""
    import copy
    import torch
    t = copy.copy(tables)
    t._buffers = dict(tables._buffers)
    pal = tables.palette4
    t.palette4 = torch.cat([pal, pal.new_zeros((256 - pal.shape[0], 4))])
    return t


def fused_cases(device) -> list:
    """(kernel name, label, args, beyond_palette) of the fused kernels'
    cases."""
    import torch
    from .kernels import fused_z as fz
    from .kernels import selfcheck as sc
    cases = []
    for name in ("fused_z", "fused_frontend"):
        for types in fz._SYMBOL_TYPES:
            for bt in (torch.int8, torch.int32):
                fam = f"{types[0]}/{types[1]} block_type {bt}".replace(
                    "torch.", "")
                for S, G in FUSED_SHAPES:
                    cases.append((name, f"{fam} {S}x{G}", sc.random_symbols(
                        S, G, seed=S * 1000 + G, sym_types=types,
                        bt_dtype=bt, device=device), False))
                cases.append((name, f"{fam} extremes 4x32", extreme_symbols(
                    4, 32, 4, types, bt, device), False))
                cases.append((name, f"{fam} stereo bytes beyond the palette",
                              extreme_symbols(2, 32, 5, types, bt, device,
                                              beyond_palette=True), True))
        ring = FZ_STAGES * persistent_grid(name, device)
        for n in (ring - 1, ring, ring + 1):
            cases.append((name, f"int32/int32 {n} pairs (grid x stages "
                          f"{n - ring:+d})", sc.random_symbols(
                              n, 1, seed=n, device=device), False))
    return cases


def synth_cases(device) -> list:
    """(label, z, state) of the synthesis kernel's cases; z at the loudest
    the chain makes comes in the last."""
    from .kernels import selfcheck as sc
    cases = [(f"{S}x{G}", *sc.random_z(S, G, seed=S * 1000 + G, device=device))
             for S, G in SYNTH_SHAPES]
    z, st = sc.random_z(2, 32, seed=9, device=device)
    cases.append(("2x32 at 1e9", z * 1e9, {k: v * 1e9 for k, v in st.items()}))
    return cases


def guarded(shape: tuple, device, dtype=None):
    """(buffer, view): int32 words of GUARD_BITS, GUARD before and after a
    view of `shape` in the middle (16-byte aligned), float32 unless `dtype`
    (a 4-byte type), for a kernel to write into; for a one-byte `dtype`
    (bool), bytes of GUARD_BYTE."""
    import torch
    n = int(np.prod(shape))
    if dtype is not None and dtype.itemsize == 1:
        buf = torch.full((2 * GUARD + n,), GUARD_BYTE, dtype=torch.uint8,
                         device=device)
        return buf, buf[GUARD:GUARD + n].view(dtype).view(shape)
    buf = torch.full((2 * GUARD + n,), GUARD_BITS, dtype=torch.int32,
                     device=device)
    return buf, buf[GUARD:GUARD + n].view(dtype or torch.float32).view(shape)


def check_guards(buf, n: int, what: str) -> None:
    """Raise unless both guard bands of a guarded() buffer of n values are
    untouched (no write outside the output) and no value of the output
    still holds GUARD_BITS (GUARD_BYTE in a one-byte buffer: every value
    written)."""
    import torch
    fill = GUARD_BYTE if buf.dtype == torch.uint8 else GUARD_BITS
    band = torch.cat([buf[:GUARD], buf[GUARD + n:]])
    outside = int((band != fill).sum())
    unwritten = int((buf[GUARD:GUARD + n] == fill).sum())
    if outside or unwritten:
        raise AssertionError(f"{what}: {outside} words written outside the "
                             f"output, {unwritten} of its {n} values never "
                             "written")


def guarded_fused(name: str, args, tables, what: str):
    """Kernel `name` of csrc/fused_z.cu (the production library) into a
    guarded output; raises if it wrote outside it or left a value."""
    import torch
    from .kernels import fused_z as fz
    from .kernels import selfcheck as sc
    entry, tail = sc.ENTRIES[name]
    shape = tuple(args[0].shape[:2]) + (2,) + tail
    buf, out = guarded(shape, args[0].device)
    fz._launch(entry, tail, *args, tables, out=out)
    torch.cuda.synchronize(args[0].device)
    check_guards(buf, out.numel(), f"{name} {what}")
    return out


def guarded_synth(z, state, tables, what: str):
    """csrc/synth.cu (the production library) into guarded PCM and state;
    raises if it wrote outside them or left a value."""
    import torch
    from .kernels import synth as sy
    S, G = z.shape[:2]
    (bp, pcm), (bh, hist) = (guarded((S, 2, G * 576), z.device),
                             guarded((S, 2, 15, 32), z.device))
    got = sy._launch(z, state, tables, out=(pcm, hist))
    torch.cuda.synchronize(z.device)
    check_guards(bp, pcm.numel(), f"synth {what}: pcm")
    check_guards(bh, hist.numel(), f"synth {what}: new hist")
    return got


def run_fused(device) -> list:
    """Every fused case: on a card the kernel, launched RERUNS times into
    guarded outputs, bit-identical each time and held to its plain version
    by selfcheck.compare; on the CPU the plain version alone. Records."""
    import torch
    from .kernels import selfcheck as sc
    from .kernels.tables import build_tables
    tables = build_tables(44100, device)
    padded = padded_palette(tables)
    on_card = torch.device(device).type == "cuda"
    recs = []
    for name, label, args, beyond in fused_cases(device):
        plain = sc.KERNELS[name][1]
        want = plain(*args, padded if beyond else tables)
        got = want
        if on_card:
            runs = [guarded_fused(name, args, tables, label)
                    for _ in range(RERUNS)]
            got = runs[0]
            if not all(torch.equal(got, r) for r in runs[1:]):
                raise AssertionError(f"{name} {label}: launches differ")
        err, scale, worst = sc.compare(name, got, want, label)
        recs.append({"kernel": name, "case": label, "max_abs_err": err,
                     "max_abs_out": scale, "worst_over_tol": worst})
    return recs


def run_synth(device) -> list:
    """Every synthesis case held to the plain version by
    selfcheck.compare_synth (on a card the kernel, launched RERUNS times
    into guarded outputs, bit-identical each time), and one call at [5, 32]
    against two at [5, 16] carrying the state: bit for bit on a card.
    Records."""
    import torch
    from .kernels import selfcheck as sc
    from .kernels import synth as sy
    from .kernels.tables import build_tables
    tables = build_tables(44100, device)
    on_card = torch.device(device).type == "cuda"
    recs = []
    for label, z, st in synth_cases(device):
        want = sy.synth_backend_reference(z, st, tables)
        got = want
        if on_card:
            runs = [guarded_synth(z, st, tables, label) for _ in range(RERUNS)]
            got = runs[0]
            if not all(sc._equal_out(got, r) for r in runs[1:]):
                raise AssertionError(f"synth {label}: launches differ")
        err, scale, worst = sc.compare_synth(got, want, label)
        recs.append({"kernel": "synth", "case": label, "max_abs_err": err,
                     "max_abs_out": scale, "worst_over_tol": worst})
    z, st = sc.random_z(5, 32, seed=11, device=device)
    whole = sy.synth_backend(z, st, tables)
    a, mid = sy.synth_backend(z[:, :16], st, tables)
    b, end = sy.synth_backend(z[:, 16:], mid, tables)
    split = (torch.cat([a, b], dim=1), end)
    if torch.device(device).type == "cuda":
        if not sc._equal_out(whole, split):
            raise AssertionError("synth: one call at [5, 32] differs from two "
                                 "at [5, 16] carrying the state")
    else:
        sc.compare_synth(split, whole, "window split 16 + 16")
    recs.append({"kernel": "synth", "case": "5x32 split 16 + 16 carrying the "
                 "state", "max_abs_err": float((split[0] - whole[0]).abs().max()),
                 "max_abs_out": float(whole[0].abs().max()),
                 "worst_over_tol": 0.0})
    return recs


def dfa_shapes(width: int) -> list:
    """(rows, nbits) of the chain's random cases around a persistent grid
    `width` rows wide."""
    rows = sorted(set(DFA_ROWS) | {width - 1, width, width + 1})
    return [(r, b) for r in rows for b in DFA_BITS]


def dfa_cases(device, width: int):
    """Yields (label, packed, trans, nbits, codewords or None) of the chain's
    cases: random bytes at every dfa_shapes(width) through every automaton
    of DFA_TABLES, then rows of real codewords of each, whose counts must be
    their codewords'."""
    import torch
    from .kernels import huffman_dfa as hd
    t = lambda a: torch.from_numpy(a).to(device)
    tabs = {table: t(hd.automaton(table)[0]) for table in DFA_TABLES}
    rng = np.random.default_rng(13)
    for rows, nbits in dfa_shapes(width):
        packed = t(rng.integers(0, 256, (rows, -(-nbits // 8)), np.uint8))
        for table, tab in tabs.items():
            yield (f"{table} {rows} rows x {nbits} bits", packed, tab, nbits,
                   None)
    for table, tab in tabs.items():
        packed, counts, _ = hd.codeword_rows(table, CODEWORD_ROWS,
                                             CODEWORD_BITS, seed=7)
        yield (f"{table} {CODEWORD_ROWS} rows of codewords x {CODEWORD_BITS} "
               "bits", t(packed), tab, CODEWORD_BITS, counts)


def guarded_dfa(packed, trans, nbits: int, what: str):
    """csrc/huffman_dfa.cu into guarded counts; raises if it wrote outside
    them or left a count unwritten."""
    import torch
    from .kernels import huffman_dfa as hd
    buf, out = guarded((packed.shape[0],), packed.device, torch.int32)
    hd._launch(packed, trans, nbits, out=out)
    torch.cuda.synchronize(packed.device)
    check_guards(buf, out.numel(), f"huffman_dfa {what}")
    return out


def run_dfa(device, width: int | None = None) -> list:
    """Every chain case (dfa_cases around `width`, by default the card's
    persistent grid) equal to the plain version's counts (on a card the
    kernel, launched RERUNS times into guarded counts, bit-identical each
    time), and the codeword rows' counts equal to their codewords. Records."""
    import torch
    from .kernels import huffman_dfa as hd
    on_card = torch.device(device).type == "cuda"
    width = hd.persistent_width(device) if width is None else width
    recs = []
    for label, packed, trans, nbits, codewords in dfa_cases(device, width):
        want = hd.dfa_count_reference(packed, trans, nbits)
        got = want
        if on_card:
            runs = [guarded_dfa(packed, trans, nbits, label)
                    for _ in range(RERUNS)]
            got = runs[0]
            if not all(torch.equal(got, r) for r in runs[1:]):
                raise AssertionError(f"huffman_dfa {label}: launches differ")
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"huffman_dfa {label}: counts differ from "
                                 f"the plain version's by up to {err}")
        if codewords is not None and not np.array_equal(got.cpu().numpy(),
                                                        codewords):
            raise AssertionError(f"huffman_dfa {label}: counts differ from "
                                 "the rows' codewords")
        recs.append({"kernel": "huffman_dfa", "case": label, "max_abs_err": err,
                     "max_abs_out": int(want.max()), "worst_over_tol": 0.0})
    return recs


def rate_rates() -> list:
    """Every sample rate of the encoder's tables (tables.sfb.LONG)."""
    from .tables.sfb import LONG
    return sorted(LONG)


def rate_ix_rows(rng, n: int):
    """int32 [n + 166, 576] quantized rows for the count: n random rows
    (decaying magnitudes, some with escapes, a count1 stretch, a zero tail),
    then edge rows: all zero; all ones; one line at IX_MAX and one just over
    it; the deepest escape at the first pair, the middle pair and the last
    pair; one line 15 + 2^L - 1 and one 15 + 2^L for every linbits L; rows
    whose big values end at every even pair 0 .. 288 (bv: every region empty
    in turn), each with a count1 stretch where there is room."""
    from .encoder.quantize import IX_MAX
    rows = np.zeros((n, 576), np.int64)
    for i in range(n):
        live = int(rng.integers(8, 577))
        scale = float(rng.choice([1, 2, 8, 30, 120, 900, 6000]))
        mag = rng.standard_normal(live) * scale * np.exp(
            -3.0 * np.arange(live) / live)
        rows[i, :live] = np.rint(mag)
        c1 = int(rng.integers(0, 60)) * 4
        lo = max(live - c1, 0)
        rows[i, lo:live] = rng.integers(-1, 2, live - lo)
    edge = [np.zeros(576, np.int64), np.ones(576, np.int64)]
    for v in (IX_MAX, IX_MAX + 1):
        r = np.zeros(576, np.int64)
        r[3] = -v
        edge.append(r)
    for line in (0, 288, 575):
        r = np.zeros(576, np.int64)
        r[line] = IX_MAX
        edge.append(r)
    for L in range(14):
        r = np.zeros(576, np.int64)
        r[10], r[41] = 15 + (1 << L) - 1, -(15 + (1 << L))
        edge.append(r)
    for bv in range(0, 289, 2):
        r = np.zeros(576, np.int64)
        r[:2 * bv] = np.where(np.arange(2 * bv) % 3, 2, -3)
        r[2 * bv:2 * bv + 16] = np.resize([1, 0, -1, 1], 16)[:576 - 2 * bv]
        edge.append(r)
    return np.concatenate([rows, np.stack(edge)]).astype(np.int32)


def ix_max_edge(g: int, device="cpu") -> tuple:
    """(at, over): the neighbouring float32 p34 values that quantize at
    global gain g to IX_MAX and to IX_MAX + 1, by _quantize's float32 ops on
    `device` with its gain scale there (kernels/rate_bisect.gain_scale)."""
    import torch
    from .encoder.quantize import IX_MAX, MAGIC
    from .kernels.rate_bisect import gain_scale
    s = gain_scale(torch.device(device))[g]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=s.device)
    q = lambda v: int(torch.floor(v * s + MAGIC))
    x = f32((IX_MAX + 1 - MAGIC) / float(s))
    up = lambda v: torch.nextafter(v, f32(float("inf")))
    while q(x) > IX_MAX:
        x = torch.nextafter(x, f32(0.0))
    while q(up(x)) <= IX_MAX:
        x = up(x)
    return float(x), float(up(x))


def rate_spectra(rng, n: int) -> tuple:
    """(p34 float32, sign int32 [n + 23, 576], budgets, lo0 int32) for the
    bisection: n random spectra (decaying, zero tails; p34 = |xr|^0.75),
    budgets from -50 to 4,000 and starts from 0 to 120; then edge rows: all
    zero; a count1-only row; one line at IX_MAX and one just over it
    (ix_max_edge) at each of five gains, at the first and at the last line,
    searched from that gain under a budget no row exceeds; a row under a
    budget of -1."""
    xr = (rng.standard_normal((n + 1, 576))
          * np.exp(-np.arange(576)[None] / rng.uniform(40, 200, (n + 1, 1)))
          * rng.uniform(1e-3, 4.0, (n + 1, 1)))
    for i in range(n):
        xr[i, int(rng.integers(16, 577)):] = 0.0
    p34 = [np.abs(xr[:n]) ** 0.75, np.zeros((1, 576)), np.full((1, 576), 0.5)]
    sign = [np.sign(xr[:n]), np.zeros((1, 576)), np.ones((1, 576))]
    budgets = list(rng.integers(-50, 4000, n)) + [4000, 4000]
    lo0 = list(rng.integers(0, 121, n)) + [0, 0]
    for g in (0, 60, 150, 210, 255):
        for v in ix_max_edge(g):
            for line in (0, 575):
                r = np.zeros((1, 576))
                r[0, line] = v
                p34.append(r)
                sign.append(np.where(r > 0, -1.0, 0.0))
                budgets.append(100000)
                lo0.append(g)
    p34.append(np.abs(xr[n:]) ** 0.75)
    sign.append(np.sign(xr[n:]))
    budgets.append(-1)
    lo0.append(0)
    return (np.concatenate(p34).astype(np.float32),
            np.concatenate(sign).astype(np.int32),
            np.asarray(budgets, np.int32), np.asarray(lo0, np.int32))


def rate_cases(device, width: int):
    """Yields (label, sample_rate, mode, args) of the rate bisection's cases:
    mode "count" with args (ix, short_split), or "full" / "window" with
    args (p34, sign, budgets, lo0, short_split); at every rate_rates() rate
    and both splits on rate_ix_rows(64) and rate_spectra(64), then at 1, 7,
    33 and a persistent grid of `width` rows, one less and one more (44.1
    kHz, the long split) on random rows."""
    import torch
    rng = np.random.default_rng(17)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ix = t(rate_ix_rows(rng, 64))
    sp = tuple(t(a) for a in rate_spectra(rng, 64))
    for sr in rate_rates():
        for short in (False, True):
            at = f"{sr} Hz {'short' if short else 'long'} split"
            yield f"count {at} {ix.shape[0]} rows", sr, "count", (ix, short)
            for mode in ("full", "window"):
                yield (f"bisect {mode} {at} {sp[0].shape[0]} rows", sr, mode,
                       sp + (short,))
    for rows in sorted({1, 7, 33, width - 1, width, width + 1}):
        rix = t(rate_ix_rows(rng, rows)[:rows])
        yield (f"count 44100 Hz long split {rows} rows", 44100, "count",
               (rix, False))
        args = tuple(t(a[:rows]) for a in rate_spectra(rng, rows)) + (False,)
        for mode in ("full", "window"):
            yield (f"bisect {mode} 44100 Hz long split {rows} rows", 44100,
                   mode, args)


def guarded_rate(t, mode: str, args, what: str) -> tuple:
    """csrc/rate_bisect.cu into guarded outputs; raises if it wrote outside
    them or left a value unwritten."""
    import torch
    from .encoder import vloop_device as vd
    from .encoder.quantize import GG_WINDOW
    from .kernels import rate_bisect as rb
    dev = args[0].device
    R = args[0].shape[0]
    if mode == "count":
        ix, short = args
        bufs = [guarded(s, dev, torch.int32)
                for s in ((R,), (R, 3), (R,), (R,), (R,))]
        rb.launch_count(t, ix, short, out=tuple(o for _, o in bufs))
    else:
        p34, sign, budgets, lo0, short = args
        full = mode == "full"
        bufs = [guarded((R,), dev, dt) for dt in
                (torch.int32, torch.bool, torch.bool, torch.int32)]
        rb.launch_bisect(t, p34, sign, budgets, vd._bisect_lo(p34, lo0),
                         vd._FULL_STEPS if full else vd._WINDOW_STEPS,
                         0 if full else GG_WINDOW, short,
                         out=tuple(o for _, o in bufs))
    torch.cuda.synchronize(dev)
    for i, (buf, out) in enumerate(bufs):
        check_guards(buf, out.numel(), f"rate_bisect {what}: output {i}")
    return tuple(out for _, out in bufs)


def run_rate(device, width: int | None = None) -> list:
    """Every rate bisection case (rate_cases around `width`, by default the
    card's persistent grid) equal, output for output, to the plain version's
    (vloop_device._count_rows, _inner_bisect); on a card the kernel,
    launched RERUNS times into guarded outputs, bit-identical each time.
    Records."""
    import torch
    from .encoder import vloop_device as vd
    from .encoder.quantize import GG_WINDOW
    from .encoder.tables import encoder_tables
    from .kernels import rate_bisect as rb
    on_card = torch.device(device).type == "cuda"
    if width is None:
        width = rb.persistent_rows(device) if on_card else 4224
    recs = []
    for label, sr, mode, args in rate_cases(device, width):
        t = encoder_tables(sr, device)
        if mode == "count":
            want = vd._count_rows(t, *args)
        else:
            p34, sign, budgets, lo0, short = args
            want = vd._inner_bisect(t, p34, sign, budgets, lo0, short,
                                    None if mode == "full" else GG_WINDOW)
        got = want
        if on_card:
            runs = [guarded_rate(t, mode, args, label) for _ in range(RERUNS)]
            got = runs[0]
            if not all(torch.equal(a, b) for r in runs[1:]
                       for a, b in zip(got, r)):
                raise AssertionError(f"rate_bisect {label}: launches differ")
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                n = int((a != b).reshape(a.shape[0], -1).any(1).sum())
                raise AssertionError(f"rate_bisect {label}: output {i} differs "
                                     f"from the plain version's in {n} rows")
        recs.append({"kernel": "rate_bisect", "case": label, "max_abs_err": 0,
                     "rows": int(args[0].shape[0]), "worst_over_tol": 0.0})
    return recs


def junk_stream(clip: bytes, n_frames: int, seed: int) -> bytes:
    """Random bytes with a real frame header of `clip` planted at every
    frame's start: the container scan finds `n_frames` frames whose side
    info and main data are noise."""
    from .container import frames as fr
    idx = fr.scan_frames(np.frombuffer(clip, np.uint8))
    off, fb = int(idx.offsets[1]), idx.headers[1].frame_bytes
    rng = np.random.default_rng(seed)
    junk = bytearray(rng.integers(0, 256, fb * n_frames, dtype=np.uint8).tobytes())
    for k in range(0, len(junk), fb):
        junk[k:k + 4] = clip[off:off + 4]
    return bytes(junk)


def salted_bytes(n: int, seed: int) -> bytes:
    """fuzz_main.cpp's random bytes: sync words 0xFF 0xFB every 97 bytes."""
    rng = np.random.default_rng(seed)
    b = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    for k in range(0, n - 4, 97):
        b[k:k + 2] = b"\xff\xfb"
    return bytes(b)


def decode_streams() -> list:
    """(label, bytes) of the whole-path case: the three 10 s clips of
    tests/torch_clips, each corrupted by one of soak.py's kinds, and a junk
    stream of 60 frames."""
    from .soak import _CORRUPTIONS
    clips = [(n, (CLIPS / f"{n}.mp3").read_bytes())
             for n in ("sweep", "transients", "tonal")]
    out = list(clips)
    for i, (kind, corrupt) in enumerate(_CORRUPTIONS):
        name, clip = clips[i]
        out.append((f"{name} {kind}", corrupt(clip, np.random.default_rng(i))))
    out.append(("junk 60 frames", junk_stream(clips[0][1], 60, seed=3)))
    return out


def run_decode(device) -> list:
    """decode_batch of decode_streams() on `device`: every stream routes the
    sample count its own container scan implies, int16, and the clean clips
    equal decode_batch of them alone; salted_bytes alone is refused
    ("no MPEG audio frames found") before any device work. Records."""
    from . import api
    from .soak import _expected_samples
    streams = decode_streams()
    out = api.decode_batch([b for _, b in streams], device=device)
    clean = api.decode_batch([b for _, b in streams[:3]], device=device)
    recs = []
    for i, ((label, data), (pcm, sr)) in enumerate(zip(streams, out)):
        want = _expected_samples(data)
        if pcm.dtype != np.int16 or pcm.shape[0] != want:
            raise AssertionError(f"decode_batch {label}: {pcm.dtype} "
                                 f"{pcm.shape}, expected {want} samples")
        if i < 3 and not np.array_equal(pcm, clean[i][0]):
            raise AssertionError(f"decode_batch {label}: differs beside the "
                                 "corrupted streams")
        recs.append({"case": f"decode_batch {label}", "samples": int(want)})
    try:
        api.decode_batch([salted_bytes(20000, seed=4)], device=device)
    except ValueError as e:
        recs.append({"case": "decode_batch salted random bytes",
                     "refused": str(e)})
    else:
        raise AssertionError("decode_batch took random bytes salted with "
                             "sync words")
    return recs


RUNNERS = {"fused_z": run_fused, "synth": run_synth, "huffman_dfa": run_dfa,
           "rate_bisect": run_rate, "decode": run_decode}


def run_device_cases(device="cuda", groups=tuple(GROUPS)) -> list:
    """The device cases of `groups` on `device`, each checked; their
    records. On the CPU the wrappers run their plain versions."""
    import torch
    recs = []
    for g in groups:
        recs += RUNNERS[g](device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return recs


def compute_sanitizer() -> str:
    """compute-sanitizer of the CUDA toolkit: on PATH, else under
    CUDA_HOME (/usr/local/cuda)."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "compute-sanitizer"
    if cand.exists():
        return str(cand)
    raise SanitizerUnavailable("compute-sanitizer not found on PATH nor "
                               "under CUDA_HOME")


_SUMMARY = re.compile(r"(?:ERROR SUMMARY: (\d+) error|"
                      r"RACECHECK SUMMARY: .*?\((\d+) error)")
_UNSUPPORTED = re.compile(r"=+ Error: (Device not supported.*|"
                          r"Target application .*not supported.*)")


def parse_sanitizer(tool: str, group: str, rc: int, text: str) -> int:
    """The error count of one compute-sanitizer run, from its summary line.
    Raises SanitizerUnavailable with the tool's own words where it could not
    check the device, and SanitizerError where it reported errors, printed
    no summary, or the run failed."""
    if m := _UNSUPPORTED.search(text):
        raise SanitizerUnavailable(f"compute-sanitizer --tool {tool} "
                                   f"({group}): {m.group(1).strip()}")
    found = [int(a or b) for a, b in _SUMMARY.findall(text)]
    if not found:
        raise SanitizerError(f"compute-sanitizer --tool {tool} ({group}): no "
                             f"summary (exit code {rc}):\n{text[-2000:]}")
    errors = sum(found)
    if errors or rc != 0:
        raise SanitizerError(f"compute-sanitizer --tool {tool} ({group}): "
                             f"{errors} errors, exit code {rc}:\n{text[-2000:]}")
    return errors


def sanitize_group(tool: str, group: str) -> dict:
    """The device cases of `group` in a child process under
    compute-sanitizer --tool `tool`; the run's record."""
    kernel, _ = GROUPS[group]
    argv = [compute_sanitizer(), "--tool", tool, "--error-exitcode",
            str(ERROR_EXIT), "--print-limit", "20"]
    if kernel:
        argv += ["--kernel-name", f"kns={kernel}"]
    argv += [sys.executable, "-m", "mp3tpu_torch.sanitize", "--device-child",
             group]
    env = _importable(dict(os.environ))
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=1800)
    text = proc.stdout + proc.stderr
    errors = parse_sanitizer(tool, group, proc.returncode, text)
    cases = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith('{"case"')]
    return {"tool": tool, "group": group, "kernel": kernel, "errors": errors,
            "cases": len(cases), "seconds": time.perf_counter() - t0}


def device() -> dict:
    """The device part: the cases run once and checked, then each group
    under each of its tools. Raises on the first failure."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("--device needs a CUDA card; none here")
    from .bench import card_line
    t0 = time.perf_counter()
    cases = run_device_cases("cuda")
    rep = {"card": card_line(), "toolkit": toolkit_version(),
           "sanitizer": sanitizer_version(),
           "cases": cases, "cases_seconds": time.perf_counter() - t0,
           "runs": []}
    try:
        for group, (_, tools) in GROUPS.items():
            for tool in tools:
                rep["runs"].append(sanitize_group(tool, group))
    except (SanitizerError, SanitizerUnavailable) as e:
        rep["failed"] = f"{type(e).__name__}: {e}"
    return rep


def toolkit_version() -> str:
    from .kernels.build import nvcc_path
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def sanitizer_version() -> str:
    out = subprocess.run([compute_sanitizer(), "--version"],
                         capture_output=True, text=True).stdout
    return next((ln for ln in out.splitlines() if "Version" in ln), out.strip())


def device_child(group: str) -> int:
    """The cases of `group` on the card, one JSON line each (the process
    compute-sanitizer watches)."""
    for rec in run_device_cases("cuda", (group,)):
        print(json.dumps(rec), flush=True)
    return 0


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        return child_main(argv[1:])
    if argv[:1] == ["--device-child"]:
        return device_child(argv[1])
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.sanitize",
        description="Sanitizer runs over the port's native code and the "
                    "unpacker's section profile.")
    ap.add_argument("--host", action="store_true",
                    help="the C++ under ASan/UBSan: fuzz harness and mux "
                         "(CPU)")
    ap.add_argument("--device", action="store_true",
                    help="the CUDA kernels and the decode path under "
                         "compute-sanitizer (needs a card)")
    ap.add_argument("--profile", action="store_true",
                    help="the unpacker's cycles by section (CPU)")
    ap.add_argument("--out", help="write the whole report here as JSON")
    args = ap.parse_args(argv)
    parts = [p for p in ("host", "device", "profile") if getattr(args, p)]
    report, failed = {}, False
    for part in parts or ["host", "profile"]:
        fn = {"host": host, "device": device, "profile": profile}[part]
        t0 = time.perf_counter()
        try:
            report[part] = fn()
        except (RuntimeError, AssertionError) as e:  # the sanitizers' too
            report[part] = {"failed": f"{type(e).__name__}: {e}"}
            failed = True
        failed = failed or "failed" in report[part]
        report[part]["part_seconds"] = time.perf_counter() - t0
        brief = {k: v for k, v in report[part].items() if k != "cases"}
        print(json.dumps({part: brief}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
