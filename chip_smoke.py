#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/mp3tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing its numbers and its seconds on lines of its own; any
failure raises and the script exits non-zero:
  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: the port's C++ host library (csrc/unpack.cpp and
     mux_stream.cpp, g++), the unpacker's section profiler
     (csrc/prof_main.cpp, g++, for the tools phase) and the CUDA kernels
     (csrc/fused_z.cu, csrc/synth.cu, csrc/huffman_dfa.cu and
     csrc/rate_bisect.cu, one nvcc each),
     all at once; the run fails if any does not build or load;
  3. kernel vs plain: fused_pipeline_z (C1-C5) and fused_frontend (C1-C4)
     through kernels/selfcheck.py's checks (odd pair counts, every input
     type, bit-identity across launches and batch sizes, zero pairs), then
     against their plain versions at the shapes and types each path hands
     them (KERNEL_CASES: the player's S=1, decode_batch's and the
     scheduler's S=64, the soak's S=8, config 3's S=256, windows of 32
     granules; the chunked single-file decode's 36 and 18 rows of 130
     granules), with the
     times (warm, and with a cold L2 from 2,048 pairs up), the bytes moved,
     the least time the card could take for them and the share of it
     reached; then the synthesis kernel (C6-C7, synth_backend) through
     selfcheck.check_synth (within tolerance of its plain version at odd
     shapes; bit-identical PCM and state across launches, batch sizes,
     window splits and the chunked decode's shape; zero granules) and
     against both plain versions (the FIR as one matmul; the factored
     matrixing + window) at SYNTH_CASES, with its registers, spills, shared
     memory and blocks per SM, its times (warm and with a cold L2), the
     plain version's, one conv1d call's and its bound; then the Huffman
     chain (csrc/huffman_dfa.cu, dfa_count) timed with its bound and its
     plain version at the spike's two shapes (its default case and the
     bench's shape); then the encoder's rate bisection
     (csrc/rate_bisect.cu, kernels/rate_bisect.py) on the calls
     encode_batch makes for 64 streams x 10 s (the largest full-range and
     windowed bisection and final count of each region split), held to the
     plain versions and timed (the kernel alone, the wrapper with its torch
     closed-form start, the plain version) beside its bound, with its
     registers, shared memory and blocks per SM; then the device cases
     of mp3tpu_torch.sanitize (every plane family at 1 x 1, 8 x 32, 64 x 32
     and 36 x 130, pair counts around the persistent grid times its ring's
     stages, symbols and exponents at the extremes csrc/unpack.cpp writes,
     stereo bytes beyond the palette; the synthesis around its tile, loud,
     and split across windows; the chain count for count at every pairing
     of 1, 31, 33, 4,096 and 131,072 rows and its grid's width -1/0/+1 with
     8, 256, 259, 264 and 2,048 bits through count1-A and tables 13, 24 and
     31, and on rows of real codewords against their number; the rate
     bisection and count at every sample rate of the encoder's tables and
     both splits, on random and edge rows, at 1, 7, 33 rows and around its
     grid; decode_batch of corrupted and junk streams),
     each held to its plain version: the cases that `python -m
     mp3tpu_torch.sanitize --device` runs under compute-sanitizer, where
     that tool supports the card (PERF.md: on the H100 measured it answers
     "Device not supported", so no phase here runs it);
  4. decode_batch: 64 streams of the three 10 s clips of tests/torch_clips
     (made by mp3tpu's own encoder and committed), through
     mp3tpu_torch.decode_batch: lengths, kernel launches (one per live
     window: 24, no power-of-two pad), the window loop timed with and
     without the pad, the float64 oracle, a bit-identical rerun, and
     mp3tpu_torch.decode;
  5. device_batch: the same 64 streams through decode_batch(...,
     output="device"): one CUDA tensor per chunk, .numpy() bit-identical to
     output="pcm", .levels() and .segments() against levels() and
     segment() of each clip, levels_batch and segment_batch timed beside 64
     single levels() calls, the bytes they bring to the host, the peak
     device memory; once more at 256 streams (four chunks); and
     decode.d2h_segments 1 against 4, bit-identical, several times;
  6. config 3: 256 streams x 10 s of the bench's CBR clip
     (tests/torch_clips/bench_cbr128.mp3) decoded and resampled to 48 kHz
     through mp3tpu_torch.bench's config-3 code, timed by layer (3 runs),
     reruns bit-identical, streams 0 and 255 held against the same code on
     the CPU; the device phase with the synthesis kernel beside the same
     phase with its plain version;
  7. player: the 60 s stereo track of tests/torch_clips through
     mp3tpu_torch.play: play == decode,
     seek into a later group == the slice, loop, snapshot/restore, the EQ
     against its CPU run, speed 0.75; time to first audio and realtime
     factors;
  8. chunked: the 60 s track through decode_symbols_chunked (rows of 128 + 2
     granules, int16 out) against decode() (at most 1 LSB, CHUNKED_EXACT
     exact; whether the two are equal sample for sample is printed) and both
     against the float64 oracle; its wall and launches
     with decode.d2h_segments_single 1 and 2, beside decode_symbols_device
     and decode() of the same track (medians of 5);
  9. scheduler: decode_batch_streams of the 64 streams at 64 slots against
     decode_batch, and decode_batch with decode.use_native=False, which
     goes through the scheduler;
 10. soak: mp3tpu_torch.soak's session on the card (SOAK_S seconds of
     audio, about 480 streams of the six pool signals encoded by
     encode_batch on the card, in waves of 24 over 8 slots; every 7th
     stream corrupted by byte flips, a cut or a broken header; ring
     consumer threads on every 13th), held by soak.check_report: exact
     accounting of every stream, the fault counters, every clean stream
     that no ring drains within 1 LSB of decode_file as it arrives, no
     underrun, no decay, host RSS and device memory bounded after the
     first wave; fused_z and synth each launched once a step;
 11. encode: on the card, with no fallback: the bit count against vcount and
     the device emitter against encode_granule, the Python reference, on
     CUDA tensors (random rows of every layout and a fixed sample of the
     rows the loops produced); encode_batch of 64,
     16 and 1 streams x 10 s of int16-origin PCM (the port's decode of the
     clips, scaled per stream) at 128 kbps with noise shaping on: every
     stream parses, decodes to its input's length, SNR over its floor,
     reruns byte-identical, first call and median of 5 reruns, the phase
     walls, the outer loops' iteration counts, peak device memory; 4
     streams x 4 s against the port on the CPU (sizes equal, SNR within 0.5
     dB, share of identical rows); transcode_batch of the 64 clips to 96
     kbps == encode_batch of the handle's .numpy(), without the PCM's copy
     to the host, beside the same through the host; encode() of the 60 s
     track, and 2 s of it with device_loops on and off;
 12. cli: mp3tpu_torch.cli.main in this process, on the card by default:
     info, decode (the WAV equals decode()), loudness, segments, split (WAV
     and MP3 clips), transcode, play --loop to a WAV;
 13. bench: `mp3tpu-torch bench --configs --reps 1` in this process (the
     headline, config 3 with the decode_files figures, and one line for each
     of configs 1, 2, 3, 4 and the three of 5), every line parsed and held
     to its names, its checks and this card;
 14. tools: each of mp3tpu_torch.tools' six measurement tools once, at a
     reduced size (TOOL_RUNS: the spike's default case, bench_repeat twice,
     bench_segment of 16 streams, d2h_overlap_timing at K 1 and 2,
     encode_single_profile once, rate_loop_hist of 4 x 2 s), each line held
     to its tool's KEYS and this card, the tools' own checks raising;
 15. multichip: 8 streams of about 1 s, sharded over a mesh of every GPU
     present and over a mesh of two shards on cuda:0: one window of the
     granule chain (float32 PCM and state bit for bit the unsharded call's),
     the packed 4-bit arenas -> window loop -> resample to 48 kHz step
     against the unsharded step, a peak reduced over the shards, one sharded
     encode_batch byte for byte the unsharded one; then torch.distributed:
     a group of one rank under NCCL (gather and all-reduce as identities),
     and two ranks under gloo, spawned as child processes of this script
     that meet on a loopback port and share cuda:0, each decoding and
     encoding its rank_slice, their gathers held to the single-process
     results.
The kernels' JSON record gives each kernel's launches in the runs of
decode_batch, the device-resident batch, the full play, the chunked decode,
the scheduler, the soak session, the transcode, the bench, the tools and
the sharded steps, each counted from 0 just before the run, and apart from
them the calls of the kernel phase. Only the tools path launches the
Huffman chain (huffman_dfa: the spike measures it; no decode runs it); no
path launches fused_frontend; the encoder's paths launch rate_bisect (a
bisection) and rate_count (a final count). The line before the last is the card's; the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX and
nothing of mp3tpu (the JAX package); needs no LAME.

    python3 chip_smoke.py --profile

instead profiles the player (plain, EQ, speed 0.75), the scheduler and
levels() under cProfile and torch.profiler, after the build, and prints the
tables; then the encoder: encode_batch and transcode_batch of 16 streams
under the profilers, the loops with and without the early exit, three
row-block sizes, and device_loops on against off by stream length.

    python3 chip_smoke.py --encode

instead runs only the encode phase (11), after the build.

    python3 chip_smoke.py --kernel

instead runs only the kernel phase (3), after the build: the quickest check
that every kernel builds, launches and agrees with its plain version.

    python3 chip_smoke.py --variants

instead times csrc/synth.cu's measurement variants (SYNTH_VARIANTS: the
arithmetic of seq, the matrixing or the window left out) and
csrc/fused_z.cu's (VARIANTS: a deeper input ring, fewer blocks per SM, C5's
arithmetic left out) against each kernel as built.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WIN = 32
CLIP_S = 10.0
TRACK_S = 60.0
SR = 44100
CLIPS = os.path.join(ROOT, "tests", "torch_clips")


def log(*a):
    print(*a, flush=True)


def _wrappers() -> dict:
    from mp3tpu_torch.kernels import fused_z as fz
    from mp3tpu_torch.kernels import huffman_dfa as hd
    from mp3tpu_torch.kernels import rate_bisect as rb
    from mp3tpu_torch.kernels import synth as sy
    return {"fused_z": fz.fused_pipeline_z, "fused_frontend": fz.fused_frontend,
            "synth": sy.synth_backend, "huffman_dfa": hd.dfa_count,
            "rate_bisect": rb.inner_bisect, "rate_count": rb.count_rows}


def zero_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def quantize_np(x: np.ndarray) -> np.ndarray:
    """float64 PCM -> int16, half away from zero (quantize_i16's rule)."""
    s = x * 32768.0
    r = np.where(s >= 0, np.floor(s + 0.5), np.ceil(s - 0.5))
    return np.clip(r, -32768, 32767).astype(np.int16)


def compare_i16(a: np.ndarray, b: np.ndarray, what: str) -> None:
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {a.shape} vs {b.shape}")
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    exact = float((d == 0).mean())
    log(f"{what}: max |d| {int(d.max())} LSB, exact {exact:.6f}")
    if d.max() > 1 or exact < 0.98:
        raise AssertionError(f"{what}: outside 1 LSB / 98% exact")


# ---------------------------------------------------------------- phases

def phase_environment() -> str:
    from mp3tpu_torch.bench import card_line
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = card_line()
    log(f"card: {card}")
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is on: "
                             "the float32 matmuls would run in TF32")
    return card


def phase_build() -> None:
    """The C++ unpacker, the section profiler and the three CUDA libraries,
    built at once; raises if any does not build or load."""
    from concurrent.futures import ThreadPoolExecutor
    from mp3tpu_torch.bitstream import native
    from mp3tpu_torch.kernels import (build, fused_z, huffman_dfa, rate_bisect,
                                      synth)

    def timed_build(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"build: {nvcc[-1]}")
    with ThreadPoolExecutor(6) as ex:
        unpacker = ex.submit(timed_build, native._load)
        profiler = ex.submit(timed_build,
                             lambda: build.build_tool("prof_main.cpp"))
        kernels = ex.submit(timed_build, fused_z._library)
        synthesis = ex.submit(timed_build, synth._library)
        chain = ex.submit(timed_build, huffman_dfa._library)
        rate = ex.submit(timed_build, rate_bisect._library)
        lib, s_unpack = unpacker.result()
        prof, s_prof = profiler.result()
        _, s_cuda = kernels.result()
        _, s_synth = synthesis.result()
        _, s_chain = chain.result()
        _, s_rate = rate.result()
    if lib is None:
        raise RuntimeError("the C++ unpacker did not load (MP3TPU_NO_NATIVE "
                           "set, or no g++)")
    log(f"build: prof_main.cpp {s_prof:.2f} s -> {os.path.relpath(prof, ROOT)}")
    for src, s in (("unpack.cpp", s_unpack), ("fused_z.cu", s_cuda),
                   ("synth.cu", s_synth), ("huffman_dfa.cu", s_chain),
                   ("rate_bisect.cu", s_rate)):
        path = build.build(src)
        log(f"build: {src} {s:.2f} s -> {os.path.relpath(path, ROOT)}")
        for line in path.with_suffix(".log").read_text().splitlines():
            log(f"  {src}: {line}")


def read_clips() -> dict:
    """The three 10 s clips of tests/torch_clips (made by mp3tpu's encoder:
    tests/test_torch_host.py holds the recipe and re-encodes them)."""
    clips = {}
    for name in ("sweep", "transients", "tonal"):
        with open(os.path.join(CLIPS, f"{name}.mp3"), "rb") as f:
            clips[name] = f.read()
        log(f"clip {name}: {len(clips[name])} bytes")
    return clips


# the kernel phase's shapes: (S rows of G granules, spectrum and exponent
# types, the path that hands the kernel these)
CHUNK_G = 128 + 2   # decode_symbols_chunked's rows: 128 granules and a halo
KERNEL_CASES = (
    (1, WIN, ("int16", "int16"), "player"),
    (64, WIN, ("int32", "int32"), "decode_batch, 4-bit arenas"),
    (64, WIN, ("int32", "int16"), "decode_batch, widened planes"),
    (64, WIN, ("int16", "int16"), "scheduler"),
    (8, WIN, ("int16", "int16"), "soak: the scheduler at 8 slots"),
    (256, WIN, ("int32", "int32"), "config 3"),
    (36, CHUNK_G, ("int16", "int16"), "chunked single-file decode"),
    (18, CHUNK_G, ("int16", "int16"), "chunked single-file decode, 2 segments"),
)


def cuda_ms_cold(fn, args: list, nbytes: int, reps: int = 7) -> float:
    """Milliseconds per call of fn(*inputs) with a cold L2: each timing
    (CUDA events, behind a 20 ms spin as in cuda_ms) runs back to back over
    copies of `args` whose inputs and kept outputs (`nbytes` a call) fill
    the L2 four times over, so no call finds the last one's data there. The
    median of `reps` timings, after one untimed pass."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    n = min(64, max(2, -(-4 * l2 // nbytes)))
    sets = [[a.clone() for a in args] for _ in range(n)]
    outs = [fn(*x) for x in sets]
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        del outs
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        a.record()
        outs = [fn(*x) for x in sets]
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def phase_kernel(clips: dict, card: str):
    """Each kernel through selfcheck's checks, then against its plain
    version at the shapes and types each path hands it (KERNEL_CASES),
    with its times (warm and with a cold L2) and its bound: the records of
    the kernel by case, and the kernels' calls made here, which no path's
    count includes."""
    from mp3tpu_torch.tools import cuda_ms
    from mp3tpu_torch.kernels import selfcheck as sc
    from mp3tpu_torch.kernels.tables import build_tables
    from mp3tpu_torch.pipeline import load_symbols
    tables = build_tables(SR, "cuda")
    real = [load_symbols(c)[0] for c in clips.values()]
    rec = {name: [] for name in sc.KERNELS}
    zero_counts()
    for name in sc.KERNELS:
        t0 = time.perf_counter()
        sc.check_kernel(name, tables, log=log)
        log(f"check {name}: passed in {time.perf_counter() - t0:.2f} s; "
            f"persistent grid {torch.cuda.get_device_properties(0).multi_processor_count}"
            f" SMs x {sc.blocks_per_sm(name)} blocks (int32 symbols)")
    for S, G, types, path in KERNEL_CASES:
        args = sc.random_symbols(S, G, seed=S, real=real,
                                 sym_types=tuple(getattr(torch, t) for t in types))
        at = f"S={S} G={G} is_/exp {types[0]}/{types[1]} ({path})"
        for name, (kernel, plain) in sc.KERNELS.items():
            err, scale, worst = sc.compare(name, kernel(*args, tables),
                                           plain(*args, tables), at)
            torch.cuda.synchronize()
            log(f"kernel {name} {at}: max |d| {err:.6g}, max |out| {scale:.6g}; "
                f"worst subband at {worst:.3g} of its tol (REL_TOL {sc.REL_TOL:g} "
                f"of the subband's max |out|)")
            b = sc.bound(name, args)
            ms = cuda_ms(lambda: kernel(*args, tables))
            cold = (cuda_ms_cold(lambda *x: kernel(*x, tables), args, b["bytes"])
                    if S * G >= 64 * WIN else None)
            plain_ms = cuda_ms(lambda: plain(*args, tables))
            share = b["bound_us"] / (1e3 * ms)
            share_cold = b["bound_us"] / (1e3 * cold) if cold else None
            cold_s = (f"cold L2 {cold:.4f} ms ({100 * share_cold:.1f}% of the "
                      "bound)" if cold else "cold L2 not timed (launch-bound)")
            log(f"kernel {name} {at}: {ms:.4f} ms warm L2 ({100 * share:.1f}% "
                f"of the bound), {cold_s}, plain {plain_ms:.4f} ms (medians of "
                f"7 x 10 calls); {b['bytes']} bytes, {b['flops']} float32 "
                f"operations, bound {b['bound_us']:.2f} us by {b['bound_by']} "
                f"({card})")
            rec[name].append({
                "S": S, "G": G, "types": "/".join(types), "used_by": path,
                "max_abs_err": err, "worst_over_tol": worst, "ms": ms,
                "ms_cold_l2": cold, "plain_ms": plain_ms,
                "bound_ms": b["bound_us"] / 1e3, "bound_by": b["bound_by"],
                "library_ms": None, "library_covers": None,
                "library_whole_ms": None, "bytes": b["bytes"],
                "bound_us": b["bound_us"],
                "bound_share": share_cold if cold else share,
                "bound_share_warm_l2": share})
    rec["synth"] = synth_cases(tables, card)
    rec["huffman_dfa"] = dfa_timings(card)
    rec["rate_bisect"], rec["rate_count"] = rate_timings(clips, card)
    device_cases()
    return rec, read_counts()


def device_cases() -> None:
    """mp3tpu_torch.sanitize's device cases on the card, each held to its
    plain version (sanitize.run_device_cases raises on the first that is
    not); one JSON line: the cases, the worst over its tolerance and the
    seconds."""
    from mp3tpu_torch import sanitize
    t0 = time.perf_counter()
    recs = sanitize.run_device_cases("cuda")
    by_group = {}
    for r in recs:
        key = r.get("kernel", "decode_batch")
        by_group[key] = max(by_group.get(key, 0.0), r.get("worst_over_tol", 0.0))
    log(json.dumps({"device_cases": len(recs), "worst_over_tol": by_group,
                    "seconds": round(time.perf_counter() - t0, 2)}))


# the synthesis kernel's shapes: (S rows of G granules, the path)
SYNTH_CASES = (
    (1, WIN, "player"),
    (64, WIN, "decode_batch, scheduler, transcode"),
    (8, WIN, "soak: the scheduler at 8 slots"),
    (256, WIN, "config 3"),
    (36, CHUNK_G, "chunked single-file decode"),
)


def ptxas_report(source: str, kernel: str) -> dict:
    """Registers, spill stores and spill loads (bytes) of `kernel` in the
    ptxas report (nvcc -Xptxas -v) of csrc/`source`'s build log."""
    import re
    from mp3tpu_torch.kernels import build
    text = build.build(source).with_suffix(".log").read_text()
    parts = text.split("Compiling entry function")
    part = next((p for p in parts[1:] if kernel in p.splitlines()[0]), None)
    if part is None:
        raise AssertionError(f"{source}: no ptxas report of {kernel}")
    regs = re.search(r"Used (\d+) registers", part)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
    return {"registers": int(regs.group(1)), "spill_stores": int(spill.group(1)),
            "spill_loads": int(spill.group(2))}


def synth_cases(tables, card: str) -> list:
    """The synthesis kernel (csrc/synth.cu) through selfcheck.check_synth,
    then against both plain versions (unfold + one matmul over the 512 FIR
    taps; the factored matrixing + window in torch ops) at SYNTH_CASES, with
    its time (warm, and with a cold L2), the plain version's time (the FIR
    as one matmul), the time of one conv1d call that computes the FIR alone
    from the overlap-added sequence, and the time of the whole function
    through torch ops around that conv1d (yardsticks timed here and used
    nowhere in the port), beside its bound. Logs the kernel's registers and spills (ptxas), shared memory
    a block and blocks per SM first."""
    from mp3tpu_torch.tools import cuda_ms
    from mp3tpu_torch.kernels import selfcheck as sc
    from mp3tpu_torch.kernels import synth as sy
    ptx, cfg = ptxas_report("synth.cu", "synth_kernel"), sy.kernel_config()
    log(f"synth kernel: {ptx['registers']} registers, {ptx['spill_stores']} / "
        f"{ptx['spill_loads']} bytes of spill stores / loads (ptxas), "
        f"{cfg['threads']} threads and {cfg['smem_bytes']} bytes of shared memory "
        f"a block, {cfg['blocks_per_sm']} blocks per SM (occupancy query)")
    t0 = time.perf_counter()
    sc.check_synth(tables, log=log)
    log(f"check synth: passed in {time.perf_counter() - t0:.2f} s")
    weight = tables.synth_w.reshape(32, 16, 32).permute(2, 0, 1).contiguous()
    out = []
    for S, G, path in SYNTH_CASES:
        z, st = sc.random_z(S, G, seed=S)
        at = f"S={S} G={G} ({path})"
        want = sy.synth_backend_reference(z, st, tables)
        got = sy.synth_backend(z, st, tables)
        err, scale, worst = sc.compare_synth(got, want, at)
        err_f, _, worst_f = sc.compare_synth(
            got, sy.synth_backend_factored_reference(z, st, tables),
            at + ", against the factored plain version")
        torch.cuda.synchronize()
        log(f"kernel synth {at}: max |d| {err:.6g} from plain (unfold + matmul), "
            f"{err_f:.6g} from the factored plain version, max |pcm| {scale:.6g}; "
            f"worst row at {worst:.3g} / {worst_f:.3g} of its tol (REL_TOL "
            f"{sc.REL_TOL:g} of the row's max |pcm|); new state bit-identical to both")
        del got
        # the library call: conv1d over full = hist ++ seq, made beforehand
        tails = torch.cat([st["overlap"][:, None], z[:, :-1, :, :, 18:]], dim=1)
        seq = ((z[..., :18] + tails) * tables.inv_mask).permute(0, 2, 1, 4, 3)
        full = torch.cat([st["hist"], seq.reshape(S, 2, G * 18, 32)], dim=2)
        x = full.reshape(S * 2, 15 + G * 18, 32).transpose(1, 2).contiguous()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib = torch.nn.functional.conv1d(x, weight)
            lib_err = float((lib.transpose(1, 2).reshape(S, 2, -1).transpose(1, 2)
                             - want[0]).abs().max())
            library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(x, weight))

            def whole():
                """The whole function through torch ops around the conv1d:
                overlap-add, mask, hist, layouts, PCM and the new state."""
                ta = torch.cat([st["overlap"][:, None], z[:, :-1, :, :, 18:]], dim=1)
                sq = ((z[..., :18] + ta) * tables.inv_mask).permute(0, 2, 1, 4, 3)
                fu = torch.cat([st["hist"], sq.reshape(S, 2, G * 18, 32)], dim=2)
                y = torch.nn.functional.conv1d(
                    fu.reshape(S * 2, 15 + G * 18, 32).transpose(1, 2), weight)
                pcm = y.transpose(1, 2).reshape(S, 2, -1).transpose(1, 2).contiguous()
                return pcm, {"overlap": z[:, -1, :, :, 18:].contiguous(),
                             "hist": fu[:, :, -15:].contiguous()}

            got = whole()
            sc.compare_synth(got, want, at + ", the conv1d route")
            library_whole_ms = cuda_ms(whole)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        del tails, seq, full, x, lib, got
        b = sc.synth_bound(z)
        ms = cuda_ms(lambda: sy.synth_backend(z, st, tables))
        cold = cuda_ms_cold(
            lambda z_, o_, h_: sy.synth_backend(z_, {"overlap": o_, "hist": h_}, tables),
            [z, st["overlap"], st["hist"]], b["bytes"])
        plain_ms = cuda_ms(lambda: sy.synth_backend_reference(z, st, tables))
        share, share_cold = b["bound_us"] / (1e3 * ms), b["bound_us"] / (1e3 * cold)
        log(f"kernel synth {at}: {ms:.4f} ms warm L2 ({100 * share:.1f}% of the "
            f"bound), cold L2 {cold:.4f} ms ({100 * share_cold:.1f}%), plain "
            f"(unfold + matmul) {plain_ms:.4f} ms, one conv1d call on the "
            f"overlap-added sequence {library_ms:.4f} ms (max |d| {lib_err:.3g} "
            f"from plain; TF32 off; the FIR alone), the whole function through "
            f"torch ops around that conv1d {library_whole_ms:.4f} ms "
            f"(medians of 7 x 10 calls); {b['bytes']} "
            f"bytes, {b['flops']} float32 operations, bound {b['bound_us']:.2f} "
            f"us by {b['bound_by']} ({card})")
        out.append({
            "S": S, "G": G, "types": "float32", "used_by": path,
            "max_abs_err": err, "max_abs_err_factored": err_f,
            "worst_over_tol": max(worst, worst_f), "ms": ms,
            "ms_cold_l2": cold, "plain_ms": plain_ms,
            "bound_ms": b["bound_us"] / 1e3, "bound_by": b["bound_by"],
            "library_ms": library_ms,
            "library_covers": "the FIR only: conv1d on hist ++ seq made beforehand",
            "library_whole_ms": library_whole_ms, "bytes": b["bytes"],
            "bound_us": b["bound_us"], "bound_share": share_cold,
            "bound_share_warm_l2": share, **ptx, **cfg})
    return out


def dfa_timings(card: str) -> list:
    """The Huffman chain (csrc/huffman_dfa.cu, dfa_count) timed (CUDA
    events) beside its plain version and its bound at the spike's cases
    (mp3tpu_torch.tools.device_huffman_spike.cases(): the default case and
    the bench's shape), each first held to the plain version count for
    count (device_cases holds it at every case of sanitize.dfa_cases). Logs
    its registers and spills (ptxas) and its grid first. The records of the
    timed cases."""
    from mp3tpu_torch.bench import max_sm_clock_mhz
    from mp3tpu_torch.kernels import huffman_dfa as hd
    from mp3tpu_torch.tools import cuda_ms
    from mp3tpu_torch.tools import device_huffman_spike as spike
    ptx, cfg = ptxas_report("huffman_dfa.cu", "dfa_count_kernel"), hd.kernel_config()
    log(f"huffman_dfa kernel: {ptx['registers']} registers, {ptx['spill_stores']}"
        f" / {ptx['spill_loads']} bytes of spill stores / loads (ptxas), "
        f"{cfg['threads']} threads a block, {cfg['blocks_per_sm']} blocks per SM "
        f"(occupancy query): a persistent grid {hd.persistent_width('cuda')} "
        "rows wide")
    clock = max_sm_clock_mhz()
    out = []
    for case, table, rows, bits, streams in spike.cases():
        trans, n_states = hd.automaton(table)
        rb = -(-bits // 8)
        packed = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (rows, rb), np.uint8)).cuda()
        tab = torch.from_numpy(trans).cuda()
        got = hd.dfa_count(packed, tab, bits)
        if not torch.equal(got, hd.dfa_count_reference(packed, tab, bits)):
            raise AssertionError(f"huffman_dfa {case} {table}: counts differ")
        ms = cuda_ms(lambda: hd.dfa_count(packed, tab, bits))
        plain_ms = cuda_ms(lambda: hd.dfa_count_reference(packed, tab, bits),
                           reps=3, inner=1)
        b = hd.bound(rows, bits, rb, n_states, clock)
        share = b["bound_us"] / (1e3 * ms)
        log(f"kernel huffman_dfa {case} {table} {rows} rows x {bits} bits: "
            f"{ms:.4f} ms ({100 * share:.1f}% of the bound; median of 7 x 10 "
            f"calls), plain {plain_ms:.4f} ms (median of 3 calls); {b['bytes']} "
            f"bytes, {b['lookups']} lookups of {b['table_bits']} bits, bound "
            f"{b['bound_us']:.2f} us by {b['bound_by']} at {clock:g} MHz; at "
            f"one bit a lookup {b['bit_serial_us']:.2f} us "
            f"({100 * b['bit_serial_us'] / (1e3 * ms):.1f}%) ({card})")
        out.append({
            "case": case, "table": table, "rows": rows, "bits": bits,
            "used_by": "mp3tpu_torch.tools.device_huffman_spike (tools)",
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_us"] / 1e3, "bound_by": b["bound_by"],
            "library_ms": None, "bytes": b["bytes"],
            "table_bits": b["table_bits"], "lookups": b["lookups"],
            "sm_clock_mhz": clock, "bound_us": b["bound_us"],
            "bound_share": share, "bit_serial_bound_us": b["bit_serial_us"],
            "bit_serial_bound_share": b["bit_serial_us"] / (1e3 * ms),
            **ptx, **cfg})
    return out


def rate_calls(clips: dict) -> dict:
    """The largest call of each kind that encode_batch makes for 64 streams
    x 10 s of the clips (the encode phase's shape: the port's decode, scaled
    per stream, at 128 kbps): {kind: (tables, args)}, kinds "<split> full"
    and "<split> window" (a bisection) and "<split> count" (a final count),
    split "long" or "switched/short"."""
    import mp3tpu_torch
    from mp3tpu_torch.kernels import rate_bisect as rb
    dec = mp3tpu_torch.decode_batch(list(clips.values()), device="cuda")
    pcm64 = [q16(dec[i % len(dec)][0].astype(np.float64) / 32768.0
                 * (0.4 + 0.6 * i / 63)) for i in range(64)]
    got = {}
    bisect, count = rb.inner_bisect, rb.count_rows

    def keep(kind, t, args):
        if kind not in got or args[0].shape[0] > got[kind][1][0].shape[0]:
            got[kind] = (t, args)

    def spy_bisect(t, p34, sign, budgets, lo0, short, window=None):
        split = "switched/short" if short else "long"
        keep(f"{split} {'full' if window is None else 'window'}", t,
             (p34, sign, budgets, lo0, short, window))
        return bisect(t, p34, sign, budgets, lo0, short, window)

    def spy_count(t, ix, short):
        keep(f"{'switched/short' if short else 'long'} count", t, (ix, short))
        return count(t, ix, short)

    rb.inner_bisect, rb.count_rows = spy_bisect, spy_count
    try:
        mp3tpu_torch.encode_batch(pcm64, SR, bitrate=128, device="cuda")
    finally:
        rb.inner_bisect, rb.count_rows = bisect, count
    return got


def walked_pairs(t, p34, sign, budgets, lo0, short, window) -> tuple:
    """(the sum of bv over the steps in which the kernel counts a row: active
    and not over IX_MAX, the row-steps counted): the plain bisection
    replayed."""
    from mp3tpu_torch.encoder import vloop_device as vd
    from mp3tpu_torch.encoder.quantize import IX_MAX
    lo = vd._bisect_lo(p34, lo0)
    if window is None:
        hi, steps = torch.full_like(lo, 255), vd._FULL_STEPS
    else:
        hi, steps = torch.clamp(lo + (window - 1), max=255), vd._WINDOW_STEPS
    walked = counted = 0
    for _ in range(steps):
        act = lo <= hi
        mid = (lo + hi) // 2
        ix = vd._quantize(p34, sign, mid)
        live = act & ~(ix.abs().amax(dim=1) > IX_MAX)
        bits, _sel, bv, _k, _c1 = vd._count_rows(t, ix, short)
        walked += int(bv[live].sum())
        counted += int(live.sum())
        fits = live & (bits <= budgets)
        hi = torch.where(fits, mid - 1, hi)
        lo = torch.where(act & ~fits, mid + 1, lo)
    return walked, counted


def rate_timings(clips: dict, card: str) -> tuple:
    """The rate bisection (csrc/rate_bisect.cu) on the calls of rate_calls:
    each held to its plain version output for output, then timed (CUDA
    events): the kernel alone, the wrapper (with the bisection's torch
    closed-form start), the plain version, beside the bound at the pairs
    the count walks (walked_pairs). Logs its registers and spills (ptxas),
    threads, shared memory and blocks per SM first. (bisection records,
    count records)."""
    from mp3tpu_torch.bench import max_sm_clock_mhz
    from mp3tpu_torch.encoder import vloop_device as vd
    from mp3tpu_torch.kernels import rate_bisect as rb
    from mp3tpu_torch.tools import cuda_ms
    ptx = ptxas_report("rate_bisect.cu", "rate_bisect_kernel")
    cfg = rb.kernel_config()
    log(f"rate_bisect kernel: {ptx['registers']} registers, "
        f"{ptx['spill_stores']} / {ptx['spill_loads']} bytes of spill stores / "
        f"loads (ptxas), {cfg['threads']} threads and {cfg['smem_bytes']} bytes "
        f"of shared memory a block, {cfg['blocks_per_sm']} blocks per SM "
        f"(occupancy query): {rb.persistent_rows('cuda')} rows in flight")
    clock = max_sm_clock_mhz()
    bis, cnt = [], []
    for kind, (t, args) in sorted(rate_calls(clips).items()):
        rows = int(args[0].shape[0])
        if kind.endswith("count"):
            ix, short = args
            kernel = lambda: rb.launch_count(t, ix, short)
            whole = lambda: rb.count_rows(t, ix, short)
            plain = lambda: vd._count_rows(t, ix, short)
            want = plain()
            walked, counted = int(want[2].sum()), rows
        else:
            p34, sign, budgets, lo0, short, window = args
            lo = vd._bisect_lo(p34, lo0)
            steps = vd._FULL_STEPS if window is None else vd._WINDOW_STEPS
            kernel = lambda: rb.launch_bisect(t, p34, sign, budgets, lo, steps,
                                              window or 0, short)
            whole = lambda: rb.inner_bisect(t, *args)
            plain = lambda: vd._inner_bisect(t, *args)
            want = plain()
            walked, counted = walked_pairs(t, *args)
        got = kernel()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"rate_bisect {kind} {rows} rows: the kernel "
                                 "differs from the plain version")
        ms, whole_ms = cuda_ms(kernel), cuda_ms(whole)
        plain_ms = cuda_ms(plain, reps=3, inner=1)
        b = rb.bound(rows, walked, clock, count_only=kind.endswith("count"))
        share = b["bound_us"] / (1e3 * ms)
        log(f"kernel rate_bisect {kind} {rows} rows: {ms:.4f} ms ({100 * share:.1f}%"
            f" of the bound), with the wrapper's torch start {whole_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (medians of 7 x 10 calls; plain of 3); "
            f"{counted} row-steps counted walking {walked} pairs, "
            f"{b['bytes']} bytes, {b['lookups']} lookups, bound "
            f"{b['bound_us']:.2f} us by {b['bound_by']} at {clock:g} MHz "
            f"({card})")
        (cnt if kind.endswith("count") else bis).append({
            "kind": kind, "rows": rows, "used_by": "encode_batch, transcode_batch",
            "max_abs_err": 0, "ms": ms, "wrapper_ms": whole_ms,
            "plain_ms": plain_ms, "bound_ms": b["bound_us"] / 1e3,
            "bound_by": b["bound_by"], "library_ms": None, "bytes": b["bytes"],
            "lookups": b["lookups"], "row_steps": counted, "walked_pairs": walked,
            "sm_clock_mhz": clock, "bound_us": b["bound_us"],
            "bound_share": share, **ptx, **cfg})
    return bis, cnt


# csrc/fused_z.cu's measurement variants: (name, macros)
VARIANTS = (("as built", ()),
            ("3 stages", ("MP3TPU_FZ_STAGES=3",)),
            ("4 stages", ("MP3TPU_FZ_STAGES=4",)),
            ("3 blocks per SM", ("MP3TPU_FZ_BLOCKS_PER_SM=3",)),
            ("no C5 arithmetic", ("MP3TPU_FZ_NO_C5=1",)))


# csrc/synth.cu's measurement variants: (name, macros)
SYNTH_VARIANTS = (("as built", ()),
                  ("no seq arithmetic", ("MP3TPU_SY_SKIP=1",)),
                  ("no matrixing arithmetic", ("MP3TPU_SY_SKIP=2",)),
                  ("no window arithmetic", ("MP3TPU_SY_SKIP=4",)),
                  ("loads and stores only", ("MP3TPU_SY_SKIP=7",)))


def variants_main(card: str) -> None:
    """Each measurement variant of csrc/synth.cu and csrc/fused_z.cu (all
    built at once), timed against the kernel as built, warm and with a cold
    L2: the synthesis at its four path shapes, C1-C5 and C1-C4 at S=64 and
    S=256 (int32 symbols). Only the variants as built must give the
    kernel's bits, and for fused_z every variant but the one without C5."""
    from mp3tpu_torch.tools import cuda_ms
    from concurrent.futures import ThreadPoolExecutor
    from mp3tpu_torch.kernels import fused_z as fz
    from mp3tpu_torch.kernels import selfcheck as sc
    from mp3tpu_torch.kernels import synth as sy
    from mp3tpu_torch.kernels.tables import build_tables
    with ThreadPoolExecutor(len(VARIANTS) + len(SYNTH_VARIANTS)) as ex:
        builds = ([ex.submit(fz._library, d) for _, d in VARIANTS]
                  + [ex.submit(sy._library, d) for _, d in SYNTH_VARIANTS])
        for b in builds:
            b.result()
    tables = build_tables(SR, "cuda")
    for S, G in ((1, WIN), (64, WIN), (256, WIN), (36, CHUNK_G)):
        z, st = sc.random_z(S, G, seed=S)
        ref = sy._launch(z, st, tables)
        nbytes = sc.synth_bound(z)["bytes"]
        for what, defines in SYNTH_VARIANTS:
            lib = sy._library(defines)
            same = sc._equal_out(sy._launch(z, st, tables, lib=lib), ref)
            if not same and not defines:
                raise AssertionError("synth: the variant as built changes the bits")
            ms = cuda_ms(lambda: sy._launch(z, st, tables, lib=lib))
            cold = cuda_ms_cold(
                lambda z_, o_, h_: sy._launch(z_, {"overlap": o_, "hist": h_},
                                              tables, lib=lib),
                [z, st["overlap"], st["hist"]], nbytes)
            log(f"variant synth S={S} G={G} {what}: {ms:.4f} ms warm L2, "
                f"{cold:.4f} ms cold L2, bits as built: {same} ({card})")
    for S in (64, 256):
        args = sc.random_symbols(S, WIN, seed=S)
        for name in sc.KERNELS:
            ref = sc.variant(name)(*args, tables)
            nbytes = sc.bound(name, args)["bytes"]
            for what, defines in VARIANTS:
                if name == "fused_frontend" and "MP3TPU_FZ_NO_C5=1" in defines:
                    continue  # C1-C4 has no C5
                fn = sc.variant(name, defines)
                same = torch.equal(fn(*args, tables), ref)
                if not same and "MP3TPU_FZ_NO_C5=1" not in defines:
                    raise AssertionError(f"variant {what} of {name} changes the bits")
                ms = cuda_ms(lambda: fn(*args, tables))
                cold = cuda_ms_cold(lambda *x: fn(*x, tables), args, nbytes)
                log(f"variant {name} S={S} {what}: {sc.blocks_per_sm(name, defines)} "
                    f"blocks per SM, {ms:.4f} ms warm L2, {cold:.4f} ms cold L2, "
                    f"bits as built: {same} ({card})")


def phase_decode_batch(clips: dict):
    """decode_batch of 64 streams: (the kernels' launches in it, the batch,
    its results)."""
    import mp3tpu_torch
    from mp3tpu_torch.dsp.gapless import gapless_bounds
    from mp3tpu_torch.oracle.decoder import decode_symbols
    from mp3tpu_torch.pipeline import load_symbols
    names = list(clips)
    batch = [clips[names[i % len(names)]] for i in range(64)]
    syms = {}
    for name, c in clips.items():
        st, info, _ = load_symbols(c)
        syms[name] = (st, info)
        bt = np.bincount(st.block_type.ravel(), minlength=4)
        log(f"clip {name}: {st.n_granules} granules, block types {bt.tolist()}, "
            f"mixed {int(st.mixed.sum())}, MS bands {int((st.smode == 1).sum())}, "
            f"intensity bands {int((st.smode >= 2).sum())}")

    zero_counts()
    t0 = time.perf_counter()
    out = mp3tpu_torch.decode_batch(batch, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"decode_batch: 64 streams x {CLIP_S:g} s in {wall:.3f} s "
        f"(first call, builds included), launches {launches}")
    if min(launches["fused_z"], launches["synth"]) <= 0:
        raise AssertionError("decode_batch did not go through the kernel")
    n_win = -(-max(st.n_granules for st, _ in syms.values()) // WIN)
    bucket = 1 << (n_win - 1).bit_length()
    log(f"decode_batch: windows decoded per chunk {launches['fused_z']} "
        f"(live windows {n_win}; a power-of-two bucket would hold {bucket})")
    if launches["fused_z"] != n_win:
        raise AssertionError("decode_batch decoded pad windows")

    for i, (pcm, rate) in enumerate(out):
        st, info = syms[names[i % len(names)]]
        n = st.n_granules * 576
        a, b = gapless_bounds(n, info.encoder_delay, info.encoder_padding)
        want = (min(n, b) - a, st.channels)
        if rate != SR or pcm.shape != want or pcm.dtype != np.int16:
            raise AssertionError(f"stream {i}: {pcm.shape} {pcm.dtype} at {rate}, "
                                 f"expected {want} int16 at {SR}")
    log(f"decode_batch: all 64 lengths equal the container scan's, "
        f"trimmed ({out[0][0].shape[0]} samples)")

    n2 = int(2 * SR)
    for k, name in enumerate(names):
        st, info = syms[name]
        a, _ = gapless_bounds(st.n_granules * 576, info.encoder_delay,
                              info.encoder_padding)
        g = -(-(a + n2) // 576)
        ref = quantize_np(decode_symbols(st.slice_granules(0, g))[a:a + n2])
        compare_i16(out[k][0][:n2], ref, f"oracle {name} first 2 s")

    t0 = time.perf_counter()
    again = mp3tpu_torch.decode_batch(batch, device="cuda")
    log(f"decode_batch: rerun {time.perf_counter() - t0:.3f} s")
    for i, ((p, _), (q, _)) in enumerate(zip(out, again)):
        if not np.array_equal(p, q):
            raise AssertionError(f"stream {i}: rerun not bit-identical")
    log("decode_batch: rerun bit-identical")

    # the clips other than the sweep fit the 4-bit planes, which stage as
    # one arena per window; the mixed batch above took the widened planes
    narrow = [k for k, n in enumerate(names) if n != "sweep"]
    rows = [narrow[i % len(narrow)] for i in range(64)]
    arena_out = mp3tpu_torch.decode_batch([batch[k] for k in rows], device="cuda")
    for i, k in enumerate(rows):
        if not np.array_equal(arena_out[i][0], out[k][0]):
            raise AssertionError(f"stream {i}: arena path differs from widened path")
    log("decode_batch: 4-bit arena path bit-identical to the widened path")

    for k, name in enumerate(names):
        pcm, rate = mp3tpu_torch.decode(clips[name], device="cuda")
        compare_i16(pcm, out[k][0], f"decode vs decode_batch {name}")
    return launches, batch, out


def window_loop_ms(batch: list, card: str) -> None:
    """The device phase of decode_batch's chunk of 64 streams: its window
    loop over the live windows, and over the power-of-two bucket of windows
    (the rest silent) that the loop decoded before; CUDA events around the
    whole loop, medians of 7 after a warm-up, in turns."""
    from mp3tpu_torch.tools import cuda_ms
    from mp3tpu_torch.kernels import pipeline as kp
    from mp3tpu_torch.pipeline import probe_granules, stream_meta, unpack_planes
    bodies = [stream_meta(d)[0] for d in batch]
    Gs = [probe_granules(b) for b in bodies]
    planes, _errs, bits, _exp_bytes = unpack_planes(bodies, Gs, 64, WIN, 4)
    keys = ("is12", "esc", "exp", "bt", "mx", "smode")
    dev = {k: torch.from_numpy(planes[k]).cuda() for k in keys}
    n_win = dev["bt"].shape[0]
    bucket = 1 << (n_win - 1).bit_length()

    def loop(n):
        per_win = [[dev[k][w] if w < n_win else torch.zeros_like(dev[k][0])
                    for w in range(n)] for k in keys]
        return kp.decode_windows_scan_i16(
            *per_win, kp.init_state(64, device="cuda"), SR, plane_bits=bits)[0]

    ms = {n_win: [], bucket: []}
    for n in (bucket, n_win):                  # the allocator's blocks for both
        loop(n)
    for n in (n_win, bucket, bucket, n_win):   # in turns, within one call
        ms[n].append(cuda_ms(lambda: loop(n), reps=7, inner=1))
    if not torch.equal(loop(n_win), loop(bucket)[:, : n_win * WIN * 576]):
        raise AssertionError("the live windows' PCM depends on the pad windows")
    live, pad = (sum(ms[n]) / 2 for n in (n_win, bucket))
    log(f"decode_batch: window loop of the 64-stream chunk ({bits}-bit planes) "
        f"{ms[n_win][0]:.3f} / {ms[n_win][1]:.3f} ms for {n_win} live windows, "
        f"{ms[bucket][0]:.3f} / {ms[bucket][1]:.3f} ms for the bucket of "
        f"{bucket} (live, bucket, bucket, live; {live / pad:.3f} of it); the "
        f"live windows' PCM bit-identical ({card})")


def timed_s(fn):
    """(fn(), its wall in seconds, the card's queue drained)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_device_batch(clips: dict, batch: list, fast: list, card: str) -> dict:
    """decode_batch(..., output="device") of the 64 streams, and what rides
    the handle. Returns the kernels' launches in the run that makes it."""
    import mp3tpu_torch
    from mp3tpu_torch import pipeline as pl
    from mp3tpu_torch.config import resolve, set_active
    names = list(clips)
    audio_s = sum(len(pcm) for pcm, _ in fast) / SR
    mib = 1 << 20

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    handle, wall = timed_s(lambda: mp3tpu_torch.decode_batch(
        batch, device="cuda", output="device"))
    launches = read_counts()
    peak_decode = torch.cuda.max_memory_allocated()
    if min(launches["fused_z"], launches["synth"]) <= 0:
        raise AssertionError('output="device" did not go through the kernel')
    if not isinstance(handle, mp3tpu_torch.DecodedBatch) or len(handle) != 64:
        raise AssertionError("no DecodedBatch of 64 streams")
    chunks = {id(handle.device_pcm(i)[0]) for i in range(64)}
    chunk = handle.device_pcm(0)[0]
    if len(chunks) != 1 or not chunk.is_cuda or chunk.dtype != torch.int16:
        raise AssertionError("the 64 streams do not share one CUDA tensor")
    log(f"device_batch: 64 streams x {CLIP_S:g} s to the device in {wall:.4f} s "
        f"({audio_s / wall:.1f}x realtime), one int16 chunk "
        f"{tuple(chunk.shape)} on {chunk.device}, launches {launches}, peak "
        f"device memory {peak_decode / mib:.1f} MiB ({card})")

    got, wall = timed_s(handle.numpy)
    for i, ((p, r), (q, rq)) in enumerate(zip(got, fast)):
        if r != rq or not np.array_equal(p, q):
            raise AssertionError(f'stream {i}: .numpy() differs from output="pcm"')
    _, wall2 = timed_s(handle.numpy)
    log(f"device_batch: .numpy() bit-identical to output=\"pcm\" for all 64; "
        f"{wall:.4f} s with the chunk's one copy to the host, {wall2:.4f} s "
        f"again from the kept copy ({card})")

    singles, wall_single = timed_s(
        lambda: [mp3tpu_torch.levels(d, device="cuda") for d in batch])
    torch.cuda.reset_peak_memory_stats()
    lv, wall_lv = timed_s(handle.levels)
    peak_levels = torch.cuda.max_memory_allocated()
    for i, ((ld, pk), (ld1, pk1)) in enumerate(zip(lv, singles)):
        if abs(ld - ld1) >= 0.6 or abs(min(pk, 0.0) - min(pk1, 0.0)) >= 0.3:
            raise AssertionError(f"stream {i}: levels {ld, pk} vs single {ld1, pk1}")
    log(f"device_batch: .levels() within 0.6 dB / 0.3 dB of levels() for all "
        f"64 (clips: {[tuple(round(v, 2) for v in lv[k]) for k in range(3)]}) "
        f"in {wall_lv:.4f} s; peak device memory with the handle resident "
        f"{peak_levels / mib:.1f} MiB ({card})")
    sg, wall_sg = timed_s(handle.segments)
    for k, name in enumerate(names):
        ref = mp3tpu_torch.segment(clips[name], device="cuda")
        if len(sg[k]) != len(ref) or any(
                abs(a - a1) >= 0.02 or abs(b - b1) >= 0.02
                for (a, b), (a1, b1) in zip(sg[k], ref)):
            raise AssertionError(f"segments of {name}: {sg[k]} vs {ref}")
        if sg[k] != sg[k + 3]:
            raise AssertionError(f"segments of {name} differ between rows")
    log(f"device_batch: .segments() equal to segment() in count and within "
        f"0.02 s ({[len(x) for x in sg[:3]]} segments) in {wall_sg:.4f} s ({card})")

    # what levels_batch brings to the host: the envelope and the peaks
    crossed = []
    real = pl._env_batch

    def spy(*a):
        out = real(*a)
        crossed.extend(t.numel() * t.element_size() for t in out)
        return out

    pl._env_batch = spy
    try:
        lvb, wall_lvb = timed_s(
            lambda: mp3tpu_torch.levels_batch(batch, device="cuda"))
    finally:
        pl._env_batch = real
    if lvb != lv:
        raise AssertionError("levels_batch differs from the handle's levels()")
    pcm_bytes = chunk.numel() * chunk.element_size()
    log(f"device_batch: levels_batch equals the handle's levels(); it copies "
        f"{sum(crossed)} bytes to the host (envelope and peaks, by their "
        f"shapes) where the PCM is {pcm_bytes} bytes; first call {wall_lvb:.4f} s")
    entry = {"levels_batch": mp3tpu_torch.levels_batch,
             "segment_batch": mp3tpu_torch.segment_batch,
             "decode_batch": mp3tpu_torch.decode_batch}
    walls = {name: [] for name in entry}
    for _ in range(5):                          # in turns, within one call
        for name, fn in entry.items():
            walls[name].append(timed_s(lambda: fn(batch, device="cuda"))[1])
    med = {name: float(np.median(w)) for name, w in walls.items()}
    log("device_batch: 64 streams, medians of 5 in turns: " + ", ".join(
        f"{name} {med[name]:.4f} s ({audio_s / med[name]:.1f}x realtime; "
        f"{min(w):.4f}-{max(w):.4f})" for name, w in walls.items())
        + f"; levels_batch at {med['levels_batch'] / med['decode_batch']:.3f} "
        f"of decode_batch; 64 single levels() calls {wall_single:.4f} s "
        f"({audio_s / wall_single:.1f}x) ({card})")

    # four chunks
    big = batch * 4
    del handle, got, chunk
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    h4, wall = timed_s(lambda: mp3tpu_torch.decode_batch(
        big, device="cuda", output="device"))
    lv4, wall_lv4 = timed_s(h4.levels)
    peak4 = torch.cuda.max_memory_allocated()
    held = sum(t.numel() * t.element_size() for t in
               {id(h4.device_pcm(i)[0]): h4.device_pcm(i)[0]
                for i in range(256)}.values())
    if np.abs(np.array(lv4) - np.array(lv * 4)).max() > 1e-3:
        raise AssertionError("levels of the 256 streams differ from the 64's")
    for i, (p, _) in enumerate(h4.numpy()):
        if not np.array_equal(p, fast[i % 64][0]):
            raise AssertionError(f"stream {i} of 256 differs from output=\"pcm\"")
    log(f"device_batch: 256 streams in {wall:.4f} s ({4 * audio_s / wall:.1f}x "
        f"realtime), {held / mib:.1f} MiB of PCM in four chunks on the device, "
        f".levels() {wall_lv4:.4f} s, peak device memory {peak4 / mib:.1f} MiB; "
        f".numpy() bit-identical for all 256 ({card})")
    del h4

    # decode.d2h_segments: the window loop in K segments, each copied to the
    # host on the copy stream while the next decodes
    walls = {1: [], 4: []}
    try:
        for _ in range(4):
            for k in (1, 4, 4, 1):
                set_active(resolve(decode={"d2h_segments": k}))
                out, wall = timed_s(lambda: mp3tpu_torch.decode_batch(
                    batch, device="cuda"))
                walls[k].append(wall)
                for i, ((p, _), (q, _)) in enumerate(zip(out, fast)):
                    if not np.array_equal(p, q):
                        raise AssertionError(
                            f"d2h_segments={k}: stream {i} not bit-identical")
    finally:
        set_active(resolve())
    log(f"device_batch: decode_batch with d2h_segments 1 / 4, 8 runs each in "
        f"turns, all bit-identical: median {np.median(walls[1]):.4f} / "
        f"{np.median(walls[4]):.4f} s, range {min(walls[1]):.4f}-"
        f"{max(walls[1]):.4f} / {min(walls[4]):.4f}-{max(walls[4]):.4f} s ({card})")
    return launches


# The chunked decode against decode(): the reference's contract
# (tests/test_faults.py: at most 1 LSB, over 99.9% exact). Both routes go
# through the same two kernels, whose sums have one order whatever the call's
# shape (rows of 130 granules here, windows of 32 in decode()), and a row's
# 2-granule halo gives its first kept sample the inputs it has in the whole
# stream: so the two are expected to be equal sample for sample, which is
# printed, and held to the contract.
CHUNKED_EXACT = 0.999


def phase_chunked(track: bytes, card: str) -> dict:
    """The 60 s track as one batch of rows (decode_symbols_chunked) against
    decode(). Returns the kernels' launches in one chunked decode at the
    default config."""
    import mp3tpu_torch
    from mp3tpu_torch import pipeline as pl
    from mp3tpu_torch.config import get_active, resolve, set_active
    from mp3tpu_torch.oracle.decoder import decode_symbols
    st, _info, _ = pl.load_symbols(track)
    rows = -(-st.n_granules // 128)
    ref, _ = mp3tpu_torch.decode(track, gapless=False, device="cuda")
    g_or = 5 * 128                   # the oracle on five rows' granules
    oracle = quantize_np(decode_symbols(st.slice_granules(0, g_or)))
    n_or = g_or * 576
    compare_i16(ref[:n_or], oracle[:n_or],
                f"chunked: decode() vs the float64 oracle, first {n_or / SR:.1f} s")

    def median_s(fn, n=5):
        fn()
        return float(np.median([timed_s(fn)[1] for _ in range(n)]))

    def chunked():
        return pl.decode_symbols_chunked(st, output="int16", device="cuda")

    launches, walls = {}, {}
    try:
        for k in (1, get_active().decode.d2h_segments_single):
            set_active(resolve(decode={"d2h_segments_single": k}))
            zero_counts()
            got = chunked()
            launches[k] = read_counts()
            d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            exact = float((d == 0).mean())
            log(f"chunked: {st.n_granules} granules as {rows} rows of {CHUNK_G}, "
                f"d2h_segments_single={k}: launches {launches[k]}, max |d| "
                f"{int(d.max())} LSB, exact {exact:.6f} against decode() "
                f"(held to over {CHUNKED_EXACT}); equal sample for sample, "
                f"each row's halo granules dropped: {bool((d == 0).all())} "
                f"({int((d != 0).sum())} of {d.size} samples differ)")
            if got.shape != ref.shape or d.max() > 1 or exact <= CHUNKED_EXACT:
                raise AssertionError("chunked decode outside 1 LSB / "
                                     f"{CHUNKED_EXACT} exact")
            compare_i16(got[:n_or], oracle[:n_or],
                        f"chunked (K={k}) vs the float64 oracle, first "
                        f"{n_or / SR:.1f} s")
            calls = k if rows >= 2 * k and rows % k == 0 else 1
            if (launches[k]["fused_z"], launches[k]["synth"]) != (calls, calls):
                raise AssertionError(f"chunked decode: {launches[k]} launches, "
                                     f"expected {calls} of each kernel")
            walls[k] = median_s(chunked)
    finally:
        set_active(resolve())
    k = get_active().decode.d2h_segments_single
    w_dev = median_s(lambda: pl.decode_symbols_device(st, output="int16",
                                                      device="cuda"))
    w_all = median_s(lambda: mp3tpu_torch.decode(track, device="cuda"))
    audio_s = len(ref) / SR
    log(f"chunked: decode_symbols_chunked {walls[1]:.4f} s in one launch, "
        f"{walls[k]:.4f} s in {k} (the default); decode_symbols_device of the "
        f"same symbols {w_dev:.4f} s (144 launches); decode() whole "
        f"{w_all:.4f} s, {audio_s / w_all:.1f}x realtime (medians of 5 warm "
        f"runs; {card})")
    return launches[k]


def phase_cli(clips: dict, track: bytes, card: str) -> None:
    """mp3tpu_torch.cli.main in this process, on the default device."""
    import contextlib
    import io
    import tempfile
    import mp3tpu_torch
    from mp3tpu_torch import cli

    def run(argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return buf.getvalue().strip()

    def wav(path):
        with open(path, "rb") as f:
            return np.frombuffer(f.read()[44:], "<i2").reshape(-1, 2)

    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for name, data in list(clips.items()) + [("track60", track)]:
            paths[name] = os.path.join(d, f"{name}.mp3")
            with open(paths[name], "wb") as f:
                f.write(data)
        zero_counts()
        info = json.loads(run(["info", paths["track60"]]))
        log(f"cli info: {info}")
        if info["sample_rate"] != SR or info["channels"] != 2 \
                or info["decode_errors"] != 0:
            raise AssertionError("cli info: wrong stream facts")
        log("cli decode: " + run(["decode", paths["tonal"], "-o",
                                  os.path.join(d, "tonal.wav")]))
        pcm, _ = mp3tpu_torch.decode(clips["tonal"], device="cuda")
        if not np.array_equal(wav(os.path.join(d, "tonal.wav")), pcm):
            raise AssertionError("cli decode: the WAV is not decode()'s PCM")
        loud = json.loads(run(["loudness"] + [paths[n] for n in clips]))
        want = mp3tpu_torch.levels_batch(list(clips.values()), device="cuda")
        for name, (ld, pk) in zip(clips, want):
            got = loud["tracks"][paths[name]]
            if (got["loudness_db"], got["peak_db"]) != (round(ld, 2), round(pk, 2)):
                raise AssertionError(f"cli loudness {name}: {got}")
        log(f"cli loudness: {list(loud['tracks'].values())}")
        segs = json.loads(run(["segments", paths["transients"], paths["track60"]]))
        log(f"cli segments: {[len(v) for v in segs.values()]} segments")
        if not segs[paths["track60"]]:
            raise AssertionError("cli segments: none found in the track")
        out = json.loads(run(["split", paths["track60"], "-d",
                              os.path.join(d, "clips")]))["clips"]
        n_seg = len(mp3tpu_torch.segment(track, device="cuda"))
        if len(out) != n_seg or not all(os.path.getsize(p) > 44 for p in out):
            raise AssertionError("cli split: clips missing or empty")
        log(f"cli split: {len(out)} WAV clips")
        mp3s = json.loads(run(["split", paths["track60"], "-f", "mp3", "-b", "96",
                               "-d", os.path.join(d, "mp3")]))["clips"]
        for m, w in zip(mp3s, out):
            got, _ = mp3tpu_torch.decode(m, device="cuda")
            if got.shape != wav(w).shape:
                raise AssertionError("cli split -f mp3: a clip's length differs "
                                     "from its WAV clip's")
        log(f"cli split -f mp3: {len(mp3s)} MP3 clips of the WAV clips' lengths")
        os.makedirs(os.path.join(d, "tc"))
        tc = json.loads(run(["transcode", paths["tonal"], paths["sweep"], "-b",
                             "96", "-d", os.path.join(d, "tc")]))
        for src, o in zip(("tonal", "sweep"), tc["outputs"]):
            got, _ = mp3tpu_torch.decode(o, device="cuda")
            if got.shape != mp3tpu_torch.decode(clips[src], device="cuda")[0].shape:
                raise AssertionError(f"cli transcode {src}: another length")
        log(f"cli transcode: {[os.path.basename(o) for o in tc['outputs']]} in "
            f"{tc['wall_s']} s, each of its input's length")
        played = json.loads(run(["play", paths["track60"], "--loop", "21.3:23.8",
                                 "--times", "2", "-o", os.path.join(d, "loop.wav")]))
        got = wav(os.path.join(d, "loop.wav"))
        n = int(round(23.8 * SR)) - int(round(21.3 * SR))
        if len(got) != 2 * n or not np.array_equal(got[:n], got[n:]) \
                or played["metrics"]["samples_out"] != 2 * n \
                or int(np.abs(got).max()) == 0:
            raise AssertionError("cli play --loop: not two equal copies")
        launches = read_counts()
        log(f"cli play --loop 21.3:23.8 --times 2: two equal copies of {n} "
            f"samples; the phase's launches {launches} ({card})")
        if min(launches["fused_z"], launches["synth"]) <= 0:
            raise AssertionError("the cli did not go through the kernel")


# ---------------------------------------------------------------- encoder

def q16(a: np.ndarray) -> np.ndarray:
    """float PCM rounded to int16-origin values k/32768: what a WAV holds."""
    return np.clip(np.rint(a * 32768.0), -32768, 32767) / 32768.0


def quant_rows(rng, n: int) -> np.ndarray:
    """Quantized spectra shaped like rate-loop output: decaying magnitudes
    (some with escapes), a count1 stretch, a zero tail; degenerate rows
    first."""
    rows = np.zeros((n, 576), np.int32)
    for i in range(n):
        live = int(rng.integers(8, 560))
        scale = float(rng.choice([2, 8, 30, 120, 900]))
        mag = rng.standard_normal(live) * scale * np.exp(-3.0 * np.arange(live) / live)
        rows[i, :live] = np.rint(mag)
        c1 = int(rng.integers(0, 60)) * 4
        lo = max(live - c1, 0)
        rows[i, lo:live] = rng.integers(-1, 2, live - lo)
    rows[0] = 0
    rows[1] = 0
    rows[1, :8] = [1, -1, 0, 1, -1, 0, 0, 1]
    rows[2] = 0
    rows[2, :2] = (8191 + 15, -(8191 + 15))
    rows[3] = 1
    return rows


# rows of each loop held to encode_granule, a fixed seeded sample of the
# loop's 2,048 (the Python reference takes about 0.5 ms a row)
LOOP_SAMPLE = 512


def granule_refs(ix, bt: int, tsel, c1, gg=None, lsf=None, ssf=None,
                 sbg=None):
    """huffcode.encode_granule, the Python reference, row by row: the byte
    rows [n, 520], zero-padded as the device emitter's, and meta [n, 5]
    (part2_3_length, big_values, scalefac_compress, region0_count,
    region1_count). tsel holds table ids; lsf / ssf (and sbg) the
    scalefactors of rows coded with them."""
    from mp3tpu_torch.encoder import emit_device
    from mp3tpu_torch.encoder.huffcode import encode_granule
    n = len(ix)
    rows = np.zeros((n, emit_device.CAP_WORDS * 4), np.uint8)
    meta = np.zeros((n, 5), np.int64)
    for i in range(n):
        kw = {}
        if lsf is not None:
            kw["long_sf"] = lsf[i]
        if ssf is not None:
            kw["short_sf"] = ssf[i]
        if sbg is not None:
            kw["subblock_gain"] = tuple(int(x) for x in sbg[i])
        g = encode_granule(np.asarray(ix[i], np.int32),
                           210 if gg is None else int(gg[i]), SR, bt,
                           tsel=tuple(int(t) for t in tsel[i]),
                           c1table=int(c1[i]), **kw)
        b = np.packbits(np.asarray(g.bits.bits, np.uint8))
        rows[i, : len(b)] = b
        meta[i] = (g.part2_3_length, g.big_values, g.scalefac_compress,
                   g.region0_count, g.region1_count)
    return rows, meta


def encoder_exact_tier(card: str, device: str = "cuda") -> None:
    """On CUDA tensors, integer for integer: the bit count against vcount,
    and the device emitter against encode_granule, the Python reference, on
    random rows of every layout and on rows the loops produced."""
    from mp3tpu_torch.encoder import emit_device, vloop
    from mp3tpu_torch.encoder import vloop_device as vd
    from mp3tpu_torch.encoder.tables import encoder_tables
    from mp3tpu_torch.encoder.vcount import count_bits_rows_full
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    t = encoder_tables(SR, device)
    ix = quant_rows(rng, 640)
    # rows that fit part2_3_length's 12 bits under every layout, with the
    # scalefactors' bits: the others cannot be coded at all
    fits = np.all([count_bits_rows_full(ix, SR, bt)[0] <= 3900
                   for bt in (0, 1, 2)], axis=0)
    ix = ix[fits][:512]
    ix_dev = torch.from_numpy(ix).to(device)
    n_random = n_loop = 0
    for bt, layout in ((0, "long"), (1, "switched"), (2, "short")):
        ref, sel = count_bits_rows_full(ix, SR, bt)
        bits, selr, _bv, _k, c1 = vd._count_rows(t, ix_dev, bt != 0)
        tsel = np.stack([sel["t0"], sel["t1"], sel["t2"]], 1)
        if not (np.array_equal(bits.cpu().numpy(), ref)
                and np.array_equal(vd._TID[selr.cpu().numpy()], tsel)
                and np.array_equal(c1.cpu().numpy(), sel["c1table"])):
            raise AssertionError(f"_count_rows differs from vcount ({layout})")
        n = len(ix)
        if layout == "short":
            sf = np.concatenate([rng.integers(0, 16, (n, 3, 6)),
                                 rng.integers(0, 8, (n, 3, 6))], axis=2)
        else:
            sf = np.concatenate([rng.integers(0, 16, (n, 11)),
                                 rng.integers(0, 8, (n, 10))], axis=1)
        sf[::7] = 0
        for use_sf in (False, True):
            words, meta = emit_device.emit_rows_device(
                ix_dev, torch.from_numpy(sf).to(device), selr, c1, SR, layout,
                use_sf)
            got = emit_device.words_to_bytes(words).cpu().numpy()
            kw = {}
            if use_sf:
                kw = {"ssf" if layout == "short" else "lsf": sf}
            want, wmeta = granule_refs(ix, bt, tsel, sel["c1table"], **kw)
            if not (np.array_equal(got, want)
                    and np.array_equal(meta.cpu().numpy(), wmeta)):
                raise AssertionError(f"device emitter differs from "
                                     f"encode_granule ({layout}, "
                                     f"use_sf={use_sf})")
            n_random += n
    # rows the loops produced: count == emit on the card for every row, and
    # a fixed sample of each loop's rows against encode_granule
    xr = (rng.standard_normal((2048, 576)) * np.exp(-np.arange(576) / 120)[None]
          * rng.uniform(0.01, 2.0, (2048, 1))).astype(np.float32)
    en = (xr.astype(np.float64) ** 2).sum(1) / 576
    budgets = rng.integers(500, 3000, 2048)
    xr_dev = torch.from_numpy(xr).to(device)
    idx = np.arange(2048)
    for kind, layout, shape in (("long", "long", (21,)), ("long", "switched", (21,)),
                                ("short", "short", (3, 12)), ("rate", "long", None)):
        bt = {"long": 0, "switched": 1, "short": 2}[layout]
        if shape is not None:
            xmin = torch.from_numpy((en.reshape((-1,) + (1,) * len(shape)) * rng.uniform(
                0.002, 0.5, (2048,) + shape)).astype(np.float32)).to(device)
        if kind == "long":
            pend = vd.outer_rows_gathered_pending(xr_dev, xmin, idx, budgets, SR,
                                                  block_type=bt)
        elif kind == "short":
            pend = vd.outer_rows_short_gathered_pending(xr_dev, xmin, idx, budgets, SR)
        else:
            pend = vd.rate_rows_gathered_pending(xr_dev, idx, budgets, SR, bt)
        by, m5, gg, tcols, c1, hb, sbg = pend.emit_and_take(layout, kind != "rate", idx)
        raw = pend.fetch_rows()
        sfc = m5[:, 2].astype(np.int64)
        sfb = (18 * (vloop._SLEN1[sfc] + vloop._SLEN2[sfc]) if layout == "short"
               else 11 * vloop._SLEN1[sfc] + 10 * vloop._SLEN2[sfc])
        if not np.array_equal(m5[:, 0], hb + sfb) or (m5[:, 0] > budgets).any():
            raise AssertionError(f"{kind}/{layout}: emitted bits differ from the "
                                 "count or exceed the budget")
        pick = np.sort(rng.choice(len(idx), LOOP_SAMPLE, replace=False))
        kw = {}
        if kind == "long":
            kw = dict(lsf=raw["sf"][pick])
        elif kind == "short":
            kw = dict(ssf=raw["sf"][pick], sbg=sbg[pick])
        want, wmeta = granule_refs(raw["ix"][pick], bt, vd._TID[tcols[pick]],
                                   c1[pick], gg=gg[pick], **kw)
        if not (np.array_equal(by[pick], want) and np.array_equal(m5[pick], wmeta)):
            raise AssertionError(f"{kind}/{layout}: loop rows emit differently "
                                 "on the device and in encode_granule")
        n_loop += LOOP_SAMPLE
    log(f"encode exact tier: _count_rows == vcount on {len(ix)} rows x 3 layouts; "
        f"device emitter == encode_granule on {n_random + n_loop} rows (random "
        f"rows of every layout with and without scalefactors: {n_random}; "
        f"{LOOP_SAMPLE} rows each of the long, switched, short and rate loops, "
        f"all 2048 of each with bits == count <= budget) in "
        f"{time.perf_counter() - t0:.1f} s ({card})")


def stream_snr_db(mp3s: list, refs: list) -> list:
    """Each stream decoded through the port on the card: its gapless length
    must be its input's; the SNR against the input in dB."""
    import mp3tpu_torch
    out = []
    dec = mp3tpu_torch.decode_batch(mp3s, device="cuda")
    for i, ((pcm, rate), ref) in enumerate(zip(dec, refs)):
        if rate != SR or pcm.shape != ref.shape:
            raise AssertionError(f"stream {i}: decodes to {pcm.shape} at {rate}, "
                                 f"its input is {ref.shape}")
        a = ref.astype(np.float64)
        err = pcm.astype(np.float64) - a
        out.append(10 * np.log10((a ** 2).mean() / max((err ** 2).mean(), 1e-30)))
    return out


def granule_rows(mp3: bytes):
    """The stream's coded granule-channel rows: (spectrum, exponents)."""
    from mp3tpu_torch.pipeline import load_symbols
    st, _info, _index = load_symbols(mp3)
    return st.is_.reshape(-1, 576), st.exp.reshape(-1, 64)


# SNR floors of the three clips' re-encodes at 128 kbps with noise shaping on,
# dB: the port on the CPU gives 45.74 / 41.14 (sweep), 8.68 / 8.72
# (transients, whose noise is shaped under the masking threshold of loud
# bursts) and 43.53 / 42.67 (tonal) at the least / the largest scale of the
# batch; the floors lie 1.5 dB under the lesser
ENCODE_SNR_FLOOR = {"sweep": 39.5, "transients": 7.0, "tonal": 41.0}


def phase_encode(clips: dict, track: bytes, batch: list, fast: list,
                 card: str) -> dict:
    """The encoder on the card (none of its failures is caught: no CPU
    fallback, no Python fallback for the C++ mux). Returns the
    kernels' launches in the transcode run."""
    import mp3tpu_torch
    from mp3tpu_torch.container import frames as fr
    from mp3tpu_torch.encoder import batch as eb
    from mp3tpu_torch.encoder import vloop_device as vd
    from mp3tpu_torch.transfer import HostCopy
    names = list(clips)
    mib = 1 << 20
    encoder_exact_tier(card)

    # BASELINE config 5's shape: 64 x 10 s stereo int16-origin PCM at 44.1
    # kHz (the port's own decode of the clips, scaled per stream), 128 kbps
    pcm64 = [q16(pcm.astype(np.float64) / 32768.0 * (0.4 + 0.6 * i / 63))
             for i, (pcm, _) in enumerate(fast)]
    ref64 = [np.rint(p * 32768.0).astype(np.int16) for p in pcm64]
    results = {}
    for B in (64, 16, 1):
        pcms = pcm64[:B]
        audio_s = sum(len(p) for p in pcms) / SR
        torch.cuda.reset_peak_memory_stats()
        first, wall0 = timed_s(lambda: mp3tpu_torch.encode_batch(
            pcms, SR, bitrate=128, device="cuda"))
        peak = torch.cuda.max_memory_allocated()
        walls = []
        for _ in range(5):
            again, w = timed_s(lambda: mp3tpu_torch.encode_batch(
                pcms, SR, bitrate=128, device="cuda"))
            walls.append(w)
            if again != first:
                raise AssertionError(f"encode_batch B={B}: a rerun gives other bytes")
        med = float(np.median(walls))
        log(f"encode_batch: {B} x {CLIP_S:g} s stereo, 128 kbps, noise shaping "
            f"on: first call {wall0:.4f} s ({audio_s / wall0:.1f}x realtime), "
            f"median of 5 reruns {med:.4f} s ({audio_s / med:.1f}x; "
            f"{min(walls):.4f}-{max(walls):.4f}), reruns byte-identical, "
            f"{sum(len(o) for o in first)} bytes, peak device memory "
            f"{peak / mib:.1f} MiB ({card})")
        for i, o in enumerate(first):
            idx = fr.scan_frames(np.frombuffer(o, np.uint8))
            want = -(-(len(pcms[i]) + 528 + 529) // 1152) + 1   # and the tag frame
            if idx.n_frames != want:
                raise AssertionError(f"B={B} stream {i}: {idx.n_frames} frames, "
                                     f"expected {want}")
        snr = stream_snr_db(first, ref64[:B])
        by_clip = {n: [s for i, s in enumerate(snr) if names[i % 3] == n]
                   for n in names}
        log(f"encode_batch: B={B}: every stream parses and decodes to its "
            f"input's length; SNR dB by clip (min-max over the scales): "
            + ", ".join(f"{n} {min(v):.2f}-{max(v):.2f}"
                        for n, v in by_clip.items() if v))
        for n, v in by_clip.items():
            if v and min(v) < ENCODE_SNR_FLOOR[n]:
                raise AssertionError(f"B={B}: {n} at {min(v):.2f} dB, under "
                                     f"its floor {ENCODE_SNR_FLOOR[n]}")
        results[B] = first
    # a stream's bytes in another batch: cuBLAS and cuFFT pick by shape
    same16 = sum(a == b for a, b in zip(results[16], results[64]))
    same_rows = float((granule_rows(results[1][0])[0]
                       == granule_rows(results[64][0])[0]).all(1).mean())
    log(f"encode_batch: batch dependence: {same16} of 16 streams of B=16 have "
        f"their bytes of B=64; stream 0 alone (B=1) "
        f"{'equals' if results[1][0] == results[64][0] else 'differs from'} "
        f"its bytes in B=64 ({100 * same_rows:.2f}% of its rows' spectra equal)")

    # the phase walls and the loop telemetry of one more 64-stream run
    os.environ["MP3TPU_ENCODE_PROFILE"] = "1"
    os.environ["MP3TPU_ITER_HIST"] = "1"
    vd.ITER_STATS.clear()
    try:
        _, wall = timed_s(lambda: mp3tpu_torch.encode_batch(
            pcm64, SR, bitrate=128, device="cuda"))
    finally:
        del os.environ["MP3TPU_ENCODE_PROFILE"], os.environ["MP3TPU_ITER_HIST"]
    prof = dict(eb.LAST_PROFILE)
    log(f"encode_batch: 64 streams with a sync after each phase {wall:.4f} s: "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in prof.items()) + f" ({card})")
    log(f"encode_batch: upgraded rows {prof.get('upgraded_rows', 0)} of "
        f"{prof['total_rows']} "
        f"({100 * prof.get('upgraded_rows', 0) / prof['total_rows']:.1f}%); "
        "outer-loop iterations per row (count by iterations): "
        + "; ".join(f"{k} {v.tolist()}" for k, v in sorted(vd.ITER_STATS.items())))

    # the card against the port on the CPU: 4 streams, their first 4 s
    sub = [p[: 4 * SR] for p in pcm64[:4]]
    on_card = mp3tpu_torch.encode_batch(sub, SR, bitrate=128, device="cuda")
    t0 = time.perf_counter()
    on_cpu = mp3tpu_torch.encode_batch(sub, SR, bitrate=128, device="cpu")
    wall_cpu = time.perf_counter() - t0
    refs = [np.rint(p * 32768.0).astype(np.int16) for p in sub]
    snr_a, snr_b = stream_snr_db(on_card, refs), stream_snr_db(on_cpu, refs)
    shares = []
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        na = fr.scan_frames(np.frombuffer(a, np.uint8)).n_frames
        nb = fr.scan_frames(np.frombuffer(b, np.uint8)).n_frames
        if len(a) != len(b) or na != nb:
            raise AssertionError(f"card vs CPU, stream {i}: {len(a)} bytes in "
                                 f"{na} frames against {len(b)} in {nb}")
        if abs(snr_a[i] - snr_b[i]) > 0.5:
            raise AssertionError(f"card vs CPU, stream {i}: SNR {snr_a[i]:.2f} "
                                 f"against {snr_b[i]:.2f} dB")
        (xa, ea), (xb, eb_) = granule_rows(a), granule_rows(b)
        shares.append(float(((xa == xb).all(1) & (ea == eb_).all(1)).mean()))
    log(f"encode_batch: card against the port on the CPU, 4 streams x 4 s: "
        f"frames and bytes equal in number; rows with identical spectrum and "
        f"exponents {[f'{100 * s:.2f}%' for s in shares]}; SNR dB "
        f"{[f'{x:.2f}' for x in snr_a]} against {[f'{x:.2f}' for x in snr_b]} "
        f"(within 0.5); the CPU run took {wall_cpu:.2f} s ({card})")

    # transcode: the 64 clips to 96 kbps, the PCM staying on the card
    pcm_bytes = sum(p.size * 2 for p, _ in fast)
    mp3tpu_torch.transcode_batch(batch[:3], bitrate=96, device="cuda")  # warm-up
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    calls0, bytes0 = HostCopy.calls, HostCopy.nbytes
    tc, wall_tc = timed_s(lambda: mp3tpu_torch.transcode_batch(
        batch, bitrate=96, device="cuda"))
    launches = read_counts()
    crossed = HostCopy.nbytes - bytes0
    peak_tc = torch.cuda.max_memory_allocated()
    if min(launches["fused_z"], launches["synth"]) <= 0:
        raise AssertionError("transcode_batch did not go through the kernel")
    if crossed >= pcm_bytes // 4:
        raise AssertionError(f"transcode_batch copied {crossed} bytes to the "
                             f"host: the PCM ({pcm_bytes} bytes) did not stay")

    def through_host():
        handle = mp3tpu_torch.decode_batch(batch, device="cuda", output="device")
        return mp3tpu_torch.encode_batch(
            [p.astype(np.float64) / 32768.0 for p, _ in handle.numpy()], SR,
            bitrate=96, device="cuda")

    ref, wall_host = timed_s(through_host)
    if tc != ref:
        bad = [i for i, (a, b) in enumerate(zip(tc, ref)) if a != b]
        raise AssertionError(f"transcode_batch differs from encode_batch of the "
                             f"handle's PCM in streams {bad}")
    walls = {"device": [wall_tc], "host": [wall_host]}
    for _ in range(2):                           # in turns, within one call
        walls["host"].append(timed_s(through_host)[1])
        walls["device"].append(timed_s(lambda: mp3tpu_torch.transcode_batch(
            batch, bitrate=96, device="cuda"))[1])
    audio_s = sum(len(p) for p, _ in fast) / SR
    md, mh = (float(np.median(walls[k])) for k in ("device", "host"))
    log(f"transcode_batch: 64 clips to 96 kbps byte-identical to encode_batch of "
        f"the handle's .numpy(); {HostCopy.calls - calls0} copies of {crossed} "
        f"bytes to the host where the PCM is {pcm_bytes}; launches {launches}; "
        f"medians of 3 in turns: {md:.4f} s ({audio_s / md:.1f}x realtime; "
        f"{min(walls['device']):.4f}-{max(walls['device']):.4f}) against "
        f"{mh:.4f} s through the host ({min(walls['host']):.4f}-"
        f"{max(walls['host']):.4f}); peak device memory {peak_tc / mib:.1f} "
        f"MiB ({card})")
    snr = stream_snr_db(tc[:3], [p for p, _ in fast[:3]])
    log(f"transcode_batch: the outputs decode to the inputs' lengths; SNR dB "
        f"against the inputs' PCM {dict(zip(names, (round(s, 2) for s in snr)))}")

    # single stream (BASELINE config 5 single): the 60 s track through the
    # batched device encoder at B=1, and 2 s of it through the float64 host
    # path beside the device path
    pcm_t, _ = mp3tpu_torch.decode(track, device="cuda")
    sig = pcm_t.astype(np.float64) / 32768.0
    mp3tpu_torch.encode(sig[: 2 * SR], SR, bitrate=128, device="cuda",
                        device_loops=True)  # warm-up at B=1 shapes
    one, wall_on = timed_s(lambda: mp3tpu_torch.encode(
        sig, SR, bitrate=128, device="cuda"))
    if one != mp3tpu_torch.encode_batch([sig], SR, bitrate=128, device="cuda")[0]:
        raise AssertionError("encode() of the track differs from encode_batch([pcm])")
    [s_on] = stream_snr_db([one], [pcm_t])
    cut = sig[20 * SR: 22 * SR]                  # the transients' first 2 s
    a, w_dev = timed_s(lambda: mp3tpu_torch.encode(
        cut, SR, bitrate=128, device="cuda", device_loops=True))
    b, w_host = timed_s(lambda: mp3tpu_torch.encode(
        cut, SR, bitrate=128, device="cuda", device_loops=False,
        device_transform=False))
    if len(a) != len(b):
        raise AssertionError("device_loops on and off give other sizes")
    cut16 = [np.rint(cut * 32768.0).astype(np.int16)] * 2
    s_dev, s_host = stream_snr_db([a, b], cut16)
    if abs(s_dev - s_host) > 3.0:
        raise AssertionError(f"device_loops on {s_dev:.2f} dB, off {s_host:.2f} dB")
    log(f"encode: the {TRACK_S:g} s track (device_loops by default: on) in "
        f"{wall_on:.4f} s ({TRACK_S / wall_on:.1f}x realtime), == "
        f"encode_batch([pcm])[0], SNR {s_on:.2f} dB; 2 s of it with "
        f"device_loops on {w_dev:.4f} s / off (float64 host path) {w_host:.4f} "
        f"s, equal sizes, SNR {s_dev:.2f} / {s_host:.2f} dB ({card})")
    return launches


def phase_config3(card: str) -> None:
    """BASELINE config 3 through mp3tpu_torch.bench, the one code that
    measures it: 256 streams x 10 s of the bench's CBR clip, timed by layer
    (the median of 3 runs after a warm-up), each run's PCM bit-identical to
    the first's, streams 0 and 255 held against the same code on the CPU;
    then the device phase with the synthesis kernel beside the same phase
    with its plain version."""
    from mp3tpu_torch import bench
    from mp3tpu_torch.kernels import pipeline as kp
    from mp3tpu_torch.kernels import synth as sy
    c3, runs, pcm16, dev, checks = bench.measure_config3(
        bench.fixture("cbr"), 256, WIN, 3, "cuda")
    log(f"config3: {c3.S} streams x {c3.G * 576 / c3.sr:.3f} s -> 48 kHz int16 "
        f"{tuple(pcm16.shape)}; {c3.bits}-bit planes, byte exponents "
        f"{c3.exp_bytes}, {c3.staged_bytes / 1e6:.1f} MB staged")
    for r in runs:
        wall = r["host_unpack_s"] + r["stage_s"] + r["device_s"]
        log(f"config3: host unpack {r['host_unpack_s']:.4f} s, H2D "
            f"{r['stage_s']:.4f} s, device {r['device_s']:.4f} s, wall "
            f"{wall:.4f} s: {c3.audio_s / wall:.1f}x realtime, device-only "
            f"{c3.audio_s / r['device_compute_only_s']:.1f}x ({card})")
    log(f"config3: reruns bit-identical; against the CPU {checks['against_cpu']}")

    # the device phase with the synthesis kernel against the same phase with
    # its plain version (unfold + one matmul), in turns within this call
    routes = {"kernel": sy.synth_backend, "plain": sy.synth_backend_reference}
    walls = {name: [] for name in routes}
    try:
        for name in ("plain", "kernel", "plain", "plain", "kernel"):
            kp.synth_backend = routes[name]
            other, wall = bench.timed(lambda: c3.decode(dev), "cuda")
            walls[name].append(wall)
            d = (other.int() - pcm16.int()).abs()
            if d.max() > 1 or float((d == 0).float().mean()) < 0.98:
                raise AssertionError(f"config3: the {name} synthesis differs "
                                     "beyond 1 LSB / 98% exact")
    finally:
        kp.synth_backend = sy.synth_backend
    log(f"config3: device phase with the synthesis kernel "
        f"{walls['kernel'][0]:.4f} / {walls['kernel'][1]:.4f} s, with its plain "
        f"version (unfold + matmul) {walls['plain'][1]:.4f} / "
        f"{walls['plain'][2]:.4f} s (after one untimed plain run; kernel, "
        f"plain, plain, kernel) ({card})")


BENCH_LINES = ("1_single_file_cbr_decode", "2_vbr_joint_stereo_decode",
               "3_batched_256_resample48k", "4_player_seek_gapless_dsp",
               "5_encode_path_single", "5_encode_batch_aggregate",
               "5_encode_batch_64")


def phase_bench(card: str) -> dict:
    """`mp3tpu-torch bench --configs --reps 1` through mp3tpu_torch.cli.main
    in this process: the headline and one line a configuration, each parsed
    and held to its keys, its checks and this card. Returns the kernels'
    launches in the run."""
    import contextlib
    import io
    from mp3tpu_torch import cli
    buf = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(buf):
        cli.main(["bench", "--configs", "--reps", "1"])
    launches = read_counts()
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    head, rest = lines[0], lines[1:]
    d = head["detail"]
    if (head["metric"] != "aggregate_decode_realtime_factor"
            or [x["config"] for x in rest] != list(BENCH_LINES)
            or not all(x["checked"] is True for x in lines)
            or {d["card"]} | {x["card"] for x in rest} != {card}):
        raise AssertionError(f"bench: unexpected lines {lines}")
    log(f"bench: headline {head['value']:.1f}x realtime ({d['streams']} "
        f"streams, {d['plane_bits']}-bit planes): host unpack "
        f"{d['host_unpack_s']:.4f} s, H2D {d['stage_s']:.4f} s, device "
        f"{d['device_s']:.4f} s, device-only {d['device_compute_only_x']:.1f}x; "
        f"decode_files of {d['api_streams']} to the device "
        f"{d['api_device_batch_s']:.4f} s ({d['api_device_batch_x']:.1f}x), "
        f"to host PCM {d['api_decode_batch_s']:.4f} s "
        f"({d['api_decode_batch_x']:.1f}x); {d['seconds']:.1f} s ({card})")
    for x in rest:
        log(f"bench: {x['config']} {x['x_realtime']:.1f}x realtime, "
            f"{x['wall_seconds']:.4f} s for {x['audio_seconds']:.1f} s of audio; "
            f"checks {x['checks']}; {x.get('seconds', 0.0):.1f} s")
    if min(launches["fused_z"], launches["synth"]) <= 0 \
            or launches["fused_frontend"] != 0:
        raise AssertionError(f"bench: launches {launches}")
    log(f"bench: launches {launches} ({card})")
    return launches


# mp3tpu_torch.tools' measurement tools at reduced sizes: (tool, keyword
# arguments of its measure())
TOOL_RUNS = (
    ("device_huffman_spike", {"rows": 131072, "bits": 256, "table": "count1a"}),
    ("bench_repeat", {"times": 2}),
    ("bench_segment", {"n_streams": 16}),
    ("d2h_overlap_timing", {"reps": 1, "ks": (1, 2)}),
    ("encode_single_profile", {"reps": 1}),
    ("rate_loop_hist", {"streams": 4, "seconds": 2.0}),
)


def phase_tools(card: str) -> dict:
    """Each of mp3tpu_torch.tools' tools once at TOOL_RUNS' size, on the
    card: its own checks raise, and every line it prints is held to its
    tool's KEYS and to this card; the spike's line carries the kernel's time
    and share of its bound, and config 5's encode took the device encoder.
    Logs each line; returns the kernels' launches in the phase: the tools
    path, the one that launches the Huffman chain."""
    import importlib
    zero_counts()
    for name, kw in TOOL_RUNS:
        mod = importlib.import_module(f"mp3tpu_torch.tools.{name}")
        t0 = time.perf_counter()
        out = mod.measure(device="cuda", **kw)
        lines = out if isinstance(out, list) else [out]
        for line in lines:
            if set(line) != set(mod.KEYS) or line["card"] != card:
                raise AssertionError(f"tools {name}: keys {sorted(line)} or "
                                     f"card {line['card']!r}, expected "
                                     f"{sorted(mod.KEYS)} on {card!r}")
            log(f"tools {name}: {json.dumps(line)}")
        if name == "device_huffman_spike" and not all(
                ln["kernel_ms"] > 0 and ln["bound_share"] > 0 for ln in lines):
            raise AssertionError(f"tools {name}: no time on the card: {lines}")
        if name == "encode_single_profile" and lines[0]["route"] != "device_loops":
            raise AssertionError(f"tools {name}: encode took the host path")
        log(f"tools {name}: {len(lines)} lines in "
            f"{time.perf_counter() - t0:.2f} s")
    launches = read_counts()
    if min(launches["fused_z"], launches["synth"], launches["huffman_dfa"]) <= 0:
        raise AssertionError(f"tools: a kernel was not launched: {launches}")
    log(f"tools: launches {launches} ({card})")
    return launches


def read_track() -> bytes:
    """The 60 s stereo 44.1 kHz track of tests/torch_clips: 20 s each of the
    sweep, the transients and the tonal stereo signal, by mp3tpu's
    encoder."""
    with open(os.path.join(CLIPS, "track60.mp3"), "rb") as f:
        data = f.read()
    log(f"track: {TRACK_S:g} s stereo, {len(data)} bytes")
    return data


def phase_player(track: bytes, card: str) -> dict:
    """mp3tpu_torch.play on the card: the Player's bit-identity contracts,
    the EQ against its CPU run, speed 0.75, and times. Returns the
    kernels' launches in the plain full play."""
    import mp3tpu_torch
    from mp3tpu_torch.dsp.timestretch import N_FFT
    from mp3tpu_torch.player import CallbackSink
    from mp3tpu_torch.player.engine import GROUP_WINDOWS, WINDOW_GRANULES
    eq = [6.0, 3.0, 0.0, -3.0, -6.0, 0.0, 3.0, 0.0, -2.0, 1.0]
    ref, _ = mp3tpu_torch.decode(track, device="cuda")
    audio_s = len(ref) / SR

    def first_audio_s() -> float:
        """Open the track and play until the sink's first push."""
        t = {}

        def cb(_pcm):
            t.setdefault("first", time.perf_counter())
            p.stop()

        t0 = time.perf_counter()
        p = mp3tpu_torch.play(track, sink=CallbackSink(cb), device="cuda")
        p.play()
        return t["first"] - t0

    first_audio_s()  # warm-up
    ttfa = [first_audio_s() for _ in range(5)]
    log(f"player: time to first audio {1e3 * float(np.median(ttfa)):.2f} ms "
        f"(median of 5, {1e3 * min(ttfa):.2f}-{1e3 * max(ttfa):.2f}; {card})")

    zero_counts()
    t0 = time.perf_counter()
    p = mp3tpu_torch.play(track, device="cuda")
    p.play()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"player: full play {audio_s:.2f} s in {wall:.4f} s, realtime factor "
        f"{audio_s / wall:.1f}x; launches {launches} ({card})")
    if min(launches["fused_z"], launches["synth"]) <= 0:
        raise AssertionError("play did not go through the kernel")
    if not np.array_equal(p.sink.pcm, ref):
        raise AssertionError("play() is not bit-identical to decode")
    log(f"player: play() bit-identical to decode ({len(ref)} samples)")

    gspan = GROUP_WINDOWS * WINDOW_GRANULES * 576
    t_seek = (2 * gspan + 12345) / SR       # inside group 2
    p = mp3tpu_torch.play(track, device="cuda")
    p.seek(t_seek)
    start = p._pos - p._start
    p.play(until_sample=p._pos + 5 * SR)
    if not np.array_equal(p.sink.pcm, ref[start:start + 5 * SR]):
        raise AssertionError("seek + play is not the slice of decode")
    log(f"player: seek({t_seek:.3f} s, group {(p._start + start) // gspan}) + "
        f"5 s play bit-identical to the slice")

    p = mp3tpu_torch.play(track, device="cuda")
    a = round(0.355 * TRACK_S, 2)            # across a group boundary
    b = round(a + 2.5, 2)
    p.loop(a, b, times=3)
    seg = int(round(b * SR)) - int(round(a * SR))
    got = p.sink.pcm
    if len(got) != 3 * seg or not (np.array_equal(got[:seg], got[seg:2 * seg])
                                   and np.array_equal(got[:seg], got[2 * seg:])):
        raise AssertionError("loop(a, b, 3) is not three equal copies")
    log(f"player: loop({a}, {b}, 3) three equal copies of {seg} samples")

    t1, t2 = int(0.28 * TRACK_S), int(0.52 * TRACK_S)
    p1 = mp3tpu_torch.play(track, device="cuda", eq_gains_db=eq)
    p1.play(until_sample=p1._start + t1 * SR)
    blob = p1.snapshot()
    p1.play(until_sample=p1._start + t2 * SR)
    p2 = mp3tpu_torch.play(track, device="cuda", eq_gains_db=eq)
    p2.restore(blob)
    p2.play(until_sample=p2._start + t2 * SR)
    if not np.array_equal(p1.sink.pcm[t1 * SR:], p2.sink.pcm):
        raise AssertionError("snapshot/restore does not continue bit-identically")
    log(f"player: snapshot at {t1} s, restore, continuation to {t2} s "
        f"bit-identical (EQ on, {len(blob)} byte blob)")

    # the EQ is an unfold and a float32 matmul (no cuDNN op on the path):
    # held against the same emit on the CPU
    n_eq = min(10, t1) * SR
    pc = mp3tpu_torch.play(track, device="cpu", eq_gains_db=eq)
    pc.play(until_sample=pc._start + n_eq)
    compare_i16(p1.sink.pcm[:n_eq], pc.sink.pcm,
                f"player EQ card vs CPU, first {n_eq // SR} s")
    log(f"player: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} (unused: no cuDNN op)")

    t0 = time.perf_counter()
    p = mp3tpu_torch.play(track, device="cuda", eq_gains_db=eq)
    p.play()
    wall = time.perf_counter() - t0
    log(f"player: full play with EQ, realtime factor {audio_s / wall:.1f}x "
        f"({wall:.4f} s; {card})")

    t0 = time.perf_counter()
    p = mp3tpu_torch.play(track, device="cuda", speed=0.75)
    p.play()
    wall = time.perf_counter() - t0
    n_src = p._end - p._start
    got = len(p.sink.pcm)
    log(f"player: speed 0.75, {got} samples out for {n_src} in "
        f"(expected {n_src / 0.75:.0f} +- {N_FFT}); realtime factor "
        f"{audio_s / wall:.1f}x of the source ({wall:.4f} s; {card})")
    if abs(got - n_src / 0.75) > N_FFT:
        raise AssertionError("speed 0.75 misses the duration contract")
    if int(np.abs(p.sink.pcm).max()) == 0:
        raise AssertionError("speed 0.75: silent output")
    return launches


def phase_scheduler(batch: list, fast: list, card: str) -> dict:
    """decode_batch_streams of the 64 streams at 64 slots against the fast
    path's results, and decode_batch with use_native=False through the
    scheduler. Returns the kernels' launches in the 64-stream run."""
    import mp3tpu_torch
    from mp3tpu_torch.config import resolve, set_active
    from mp3tpu_torch.player import scheduler
    audio_s = sum(len(pcm) for pcm, _ in fast) / SR
    scheduler.decode_batch_streams(batch[:2], device="cuda")  # warm-up
    zero_counts()
    t0 = time.perf_counter()
    out = scheduler.decode_batch_streams(batch, n_slots=64, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"scheduler: 64 streams x {CLIP_S:g} s at 64 slots in {wall:.4f} s, "
        f"aggregate realtime factor {audio_s / wall:.1f}x; launches "
        f"{launches} ({card})")
    if min(launches["fused_z"], launches["synth"]) <= 0:
        raise AssertionError("the scheduler did not go through the kernel")
    compare_i16(np.concatenate([p for p, _ in out]),
                np.concatenate([p for p, _ in fast]),
                "scheduler vs decode_batch, 64 streams")

    calls = []
    real = scheduler.decode_batch_streams

    def spy(datas, **kw):
        calls.append(len(datas))
        return real(datas, **kw)

    scheduler.decode_batch_streams = spy
    set_active(resolve(decode={"use_native": False}))
    try:
        t0 = time.perf_counter()
        slow = mp3tpu_torch.decode_batch(batch[:6], device="cuda")
        wall = time.perf_counter() - t0
    finally:
        set_active(resolve())
        scheduler.decode_batch_streams = real
    if calls != [6]:
        raise AssertionError(f"use_native=False did not reach the scheduler: {calls}")
    compare_i16(np.concatenate([p for p, _ in slow]),
                np.concatenate([p for p, _ in fast[:6]]),
                "decode_batch use_native=False (scheduler) vs fast path, 6 streams")
    log(f"scheduler: decode_batch use_native=False, 6 streams in {wall:.3f} s "
        f"(pure-Python unpack; {card})")
    return launches


SOAK_S = 3600.0            # audio seconds of the soak session


def phase_soak(card: str) -> dict:
    """mp3tpu_torch.soak's session on the card, held by check_report.
    Returns the kernels' launches in the session: the set-up (the pool's
    encode, the reference decodes, the warm-up window) runs before the
    counts are set to 0."""
    from mp3tpu_torch import soak
    t0 = time.perf_counter()
    prep = soak.prepare("cuda")
    log(f"soak: pool of {len(prep['pool'])} clips encoded on the card, "
        f"decoded for reference, scheduler warmed in "
        f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    rep = soak.run_soak(total_audio_s=SOAK_S, device="cuda", prepared=prep)
    launches = read_counts()
    log("soak: " + json.dumps({k: v for k, v in rep.items()
                               if k not in ("waves", "accounting")}))
    soak.check_report(rep)
    log(f"soak: {rep['n_streams']} streams, {SOAK_S:g} s of audio in "
        f"{rep['session_wall_s']:.2f} s over {len(rep['waves'])} waves, "
        f"{rep['steps']} steps; waves {rep['min_wave_x']:.1f}x at the least, "
        f"thirds {rep['first_third_x']:.1f}x / {rep['last_third_x']:.1f}x; "
        f"growth after wave 1: RSS {rep['rss_growth_post_warmup_mb']:.1f} MB, "
        f"allocated {rep['device_alloc_growth_post_warmup_mb']:.4f} MiB, "
        f"reserved {rep['device_reserved_growth_post_warmup_mb']:.1f} MiB; "
        f"launches {launches}; check_report held ({card})")
    for name in ("fused_z", "synth"):
        if launches[name] != rep["steps"]:
            raise AssertionError(f"soak: {name} launched {launches[name]} "
                                 f"times in {rep['steps']} steps")
    return launches


# ---------------------------------------------------------------- multichip

MC_STREAMS = 8
MC_WIN = 8
MC_GRANULES = 80            # granules of a cut clip: about 1 s at 44.1 kHz


def mc_batch(clips: dict) -> list:
    names = list(clips)
    return [clips[names[i % len(names)]] for i in range(MC_STREAMS)]


def mc_tones() -> list:
    """8 float32 streams of 1 s: a tone and noise each, from a seed."""
    rng = np.random.default_rng(3)
    t = np.arange(SR) / SR
    return [(0.3 * np.sin(2 * np.pi * (260 + 45 * i) * t)
             + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
            for i in range(MC_STREAMS)]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multichip_rank(rank: int, port: str, work: str) -> int:
    """One of the two gloo ranks (a child process of phase_multichip): joins
    the group, decodes and encodes its rank_slice on cuda:0, gathers; rank 0
    writes what it gathered to `work`."""
    import mp3tpu_torch
    from mp3tpu_torch import parallel as par
    mp3tpu_torch.init(sample_rates=(), distributed_coordinator=f"127.0.0.1:{port}",
                      num_processes=2, process_id=rank, device="cuda",
                      distributed_backend="gloo")
    zero_counts()
    batch = mc_batch(read_clips())
    sl = par.rank_slice(len(batch))
    mine = mp3tpu_torch.decode_batch(batch[sl], device="cuda")
    pcm = par.gather_to_host0(np.concatenate([p for p, _ in mine]))
    lens = par.gather_to_host0([len(p) for p, _ in mine])
    tones = mc_tones()
    blobs = par.gather_to_host0(mp3tpu_torch.encode_batch(
        tones[par.rank_slice(len(tones))], SR, bitrate=128, device="cuda"))
    mean = par.allreduce_metric(float(rank + 1))
    launches = par.gather_to_host0([read_counts()])
    if rank == 0:
        np.save(os.path.join(work, "pcm.npy"), pcm)
        with open(os.path.join(work, "mp3.bin"), "wb") as f:
            f.write(b"".join(blobs))
        with open(os.path.join(work, "out.json"), "w") as f:
            json.dump({"lens": lens, "sizes": [len(b) for b in blobs],
                       "mean": mean, "launches": launches,
                       "slice": [sl.start, sl.stop]}, f)
    par.shutdown_distributed()
    log(f"multichip rank {rank}: streams [{sl.start}, {sl.stop}) on "
        f"{torch.cuda.get_device_name(0)}, launches {read_counts()}")
    return 0


def phase_multichip(clips: dict, card: str) -> dict:
    """The sharded decode and encode steps over a mesh of every GPU present
    and over two shards on cuda:0, and torch.distributed at one rank (NCCL)
    and two (gloo, child processes). Returns the kernels' launches in the
    sharded steps of this process."""
    import tempfile
    import mp3tpu_torch
    from mp3tpu_torch import parallel as par
    from mp3tpu_torch.kernels import pipeline as kp
    from mp3tpu_torch.container import frames as fr
    from mp3tpu_torch.pipeline import (load_symbols, probe_granules, stream_meta,
                                       unpack_planes)
    S, win = MC_STREAMS, MC_WIN
    cuda0 = torch.device("cuda", 0)
    meshes = {"every GPU": par.make_stream_mesh(),
              "two shards on cuda:0": par.StreamMesh((cuda0, cuda0))}
    log(f"multichip: meshes {({k: [str(d) for d in m.devices] for k, m in meshes.items()})}")

    # one window of the granule chain, float32: the kernels' sums do not
    # depend on the rows beside them, so sharded equals unsharded bit for bit
    sts = [load_symbols(c)[0] for c in clips.values()]
    sym = tuple(np.stack([a[7 * (s // 3): 7 * (s // 3) + WIN] for s in range(S)
                          for a in [getattr(sts[s % 3], f)]])
                for f in ("is_", "exp", "block_type", "mixed", "smode"))
    state0 = kp.init_state(S, device="cuda")
    ref_pcm, ref_state = kp.decode_window(
        *(torch.from_numpy(a).cuda() for a in sym), state0, SR)

    # the packed 4-bit arenas -> window loop -> resample to 48 kHz
    def head(data: bytes) -> bytes:
        """The clip cut behind its tag frame and MC_GRANULES // 2 audio
        frames."""
        index = fr.scan_frames(np.frombuffer(data, np.uint8))
        return data[: int(index.offsets[MC_GRANULES // 2 + 1])]

    bodies = [stream_meta(head(clips[n]))[0]
              for n in ("tonal", "transients")] * (S // 2)
    G = probe_granules(bodies[0])
    got = unpack_planes(bodies, [probe_granules(b) for b in bodies], S, win,
                        plane_bits=4)
    if got is None or got[2:] != (4, True):
        raise AssertionError("multichip: the clips leave the 4-bit plane family")
    planes = got[0]
    n_win = planes["bt"].shape[0]

    def step(pl: dict, dev):
        """One shard's arenas (one H2D), split, decoded and resampled."""
        s = pl["bt"].shape[1]
        arenas = torch.from_numpy(kp.pack_window_arenas(pl, s, win)).to(dev)
        parts = [kp._split_window_arena(arenas[w], s, win) for w in range(n_win)]
        x = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        return kp.decode_all_windows_flat_resampled_i16(
            x["is12"], x["exp"], x["esc"], x["bt"], x["mx"], x["smode"],
            kp.init_state(s, device=dev), kp.init_resample_state(s, SR, device=dev),
            SR, 48000, plane_bits=4)

    ref, _, ref_rs = step(planes, cuda0)
    ref_peak = float(ref.int().abs().max())
    if ref_peak == 0 or ref.shape[0] != S or ref.shape[2] != 2:
        raise AssertionError(f"multichip: unsharded step gave {tuple(ref.shape)}, "
                             f"peak {ref_peak}")
    # the unsharded references stand: from here to read_counts() every launch
    # is a sharded step's
    zero_counts()
    for name, mesh in meshes.items():
        pcm, state = par.sharded_decode_step(mesh, kp.decode_window, sym,
                                             (state0,), SR)
        if not (torch.equal(pcm, ref_pcm) and torch.equal(state["hist"], ref_state["hist"])
                and torch.equal(state["overlap"], ref_state["overlap"])):
            raise AssertionError(f"multichip ({name}): the sharded window's "
                                 "float32 PCM or state differs from the unsharded")
    log(f"multichip: decode_window of {S} streams x {WIN} granules, sharded over "
        f"each mesh: float32 PCM and state bit for bit the unsharded call's")
    for name, mesh in meshes.items():
        outs = [step({k: np.ascontiguousarray(v[:, sl]) for k, v in planes.items()}, dev)
                if sl.stop > sl.start else None
                for dev, sl in zip(mesh.devices, par.stream_sharding(mesh).slices(S))]
        pcm16, _state, rs = par.unshard(outs, device=cuda0)
        d = (pcm16.int() - ref.int()).abs()
        exact = float((d == 0).float().mean())
        peak = par.reduce_shards([o[0].int().abs().max() for o in outs if o], "max")
        log(f"multichip ({name}): {S} streams x {G} granules, {n_win} windows of "
            f"{win}, resampled to 48 kHz {tuple(pcm16.shape)}: bit for bit the "
            f"unsharded step: {bool((d == 0).all())} (max |d| {int(d.max())} LSB, "
            f"exact {exact:.6f}); resample history equal: "
            f"{torch.equal(rs, ref_rs)}; peak over the shards {peak:.0f} "
            f"(unsharded {ref_peak:.0f})")
        if pcm16.shape != ref.shape or d.max() > 1 or exact <= 0.999:
            raise AssertionError(f"multichip ({name}): sharded step outside 1 LSB "
                                 "/ 99.9% exact of the unsharded")
        if peak != ref_peak:
            raise AssertionError(f"multichip ({name}): peak {peak} != {ref_peak}")
        mean = par.allreduce_metric(1234.5, mesh)
        if abs(mean - 1234.5) > 1e-3:
            raise AssertionError(f"multichip ({name}): allreduce_metric {mean}")
    launches = read_counts()
    # a shard launches each kernel once in the single window and once a
    # window of the arenas step
    shards = sum(sl.stop > sl.start for mesh in meshes.values()
                 for sl in par.stream_sharding(mesh).slices(S))
    if not launches["fused_z"] == launches["synth"] == (1 + n_win) * shards:
        raise AssertionError(f"multichip: {shards} shards of 1 + {n_win} windows "
                             f"launched {launches}")

    # one sharded encode_batch
    tones = mc_tones()
    enc_ref, wall = timed_s(lambda: mp3tpu_torch.encode_batch(
        tones, SR, bitrate=128, device="cuda"))
    for name, mesh in meshes.items():
        enc, w = timed_s(lambda: mp3tpu_torch.encode_batch(
            tones, SR, bitrate=128, mesh=mesh))
        same = [a == b for a, b in zip(enc, enc_ref)]
        log(f"multichip ({name}): sharded encode_batch of {S} x 1 s at 128 kbps: "
            f"{sum(same)} of {S} streams byte-identical to the unsharded call "
            f"({sum(map(len, enc))} bytes; {w:.3f} s against {wall:.3f} s "
            f"unsharded; {card})")
        if len(enc) != S or not all(same):
            raise AssertionError(f"multichip ({name}): a stream's bytes depend on "
                                 f"its shard: {same}")

    # torch.distributed: one rank under NCCL, the collectives as identities
    par.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        import torch.distributed as dist
        backend = dist.get_backend()
        x16 = ref[:, :1000].contiguous()
        ok = (backend == "nccl" and par.rank_slice(S) == slice(0, S)
              and torch.equal(par.gather_to_host0(x16), x16)
              and np.array_equal(par.gather_to_host0(x16.cpu().numpy()),
                                 x16.cpu().numpy())
              and par.gather_to_host0(enc_ref) == enc_ref
              and par.allreduce_metric(2.5) == 2.5
              and par.reduce_shards([torch.tensor(7.0, device="cuda")], "max") == 7.0)
    finally:
        par.shutdown_distributed()
    log(f"multichip: one rank under {backend}: rank_slice, gather_to_host0 (CUDA "
        f"int16 tensor, numpy, bytes) and the reductions are identities: {ok}")
    if not ok:
        raise AssertionError("multichip: a collective of one rank is no identity")

    # two ranks under gloo, both on cuda:0 (NCCL wants a card per rank)
    batch = mc_batch(clips)
    single = mp3tpu_torch.decode_batch(batch, device="cuda")
    with tempfile.TemporaryDirectory() as work:
        port = str(free_port())
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multichip-rank",
             str(r), port, work], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            for line in out.splitlines()[-6:]:
                log(f"  rank {r}: {line}")
            if p.returncode != 0:
                raise AssertionError(f"multichip: rank {r} exited {p.returncode}")
        with open(os.path.join(work, "out.json")) as f:
            res = json.load(f)
        pcm = np.load(os.path.join(work, "pcm.npy"))
        with open(os.path.join(work, "mp3.bin"), "rb") as f:
            mp3 = f.read()
    if not (res["slice"] == [0, S // 2]
            and res["lens"] == [len(p) for p, _ in single]
            and np.array_equal(pcm, np.concatenate([p for p, _ in single]))
            and res["sizes"] == [len(b) for b in enc_ref]
            and mp3 == b"".join(enc_ref) and res["mean"] == 1.5
            and all(min(c["fused_z"], c["synth"]) > 0 for c in res["launches"])):
        raise AssertionError(f"multichip: the two ranks' gathers differ from the "
                             f"single-process results: {res}")
    log(f"multichip: two gloo ranks on cuda:0 in {time.perf_counter() - t0:.2f} s: "
        f"gathered int16 PCM of {S} streams ({pcm.shape[0]} samples) and {S} MP3s "
        f"({len(mp3)} bytes) equal to the single-process results; metric mean "
        f"{res['mean']}; launches per rank {res['launches']} ({card})")
    return launches


def timed(name: str, fn, *args):
    t0 = time.perf_counter()
    r = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return r


def profile_run(what: str, fn, card: str) -> None:
    """fn() once as a warm-up, then under cProfile (the 25 functions of
    most own time) and under torch.profiler: its wall, its device events,
    the device's busy time (the union of the events' intervals) and the
    15 operators of most device time."""
    import cProfile
    import io
    import pstats
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    log(f"==== {what}: wall under cProfile {time.perf_counter() - t0:.4f} s "
        f"({card})")
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(25)
    log(buf.getvalue())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels and copies; the named ranges' device-side spans ("mp3tpu...")
    # cover the idle time between them and are left out
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("mp3tpu"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    busy_s = (f"device busy {busy / 1e3:.3f} ms ({100 * busy / 1e6 / wall:.1f}% "
              f"of wall)" if spans else "device busy not measured (no events)")
    log(f"==== {what}: torch.profiler wall {wall:.4f} s, device events "
        f"{len(spans)}, {busy_s} ({card})")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15))


def profile_main(card: str) -> None:
    """The profiles behind PERF.md's section 5 on the player, the scheduler
    and the envelope scan."""
    import mp3tpu_torch
    from mp3tpu_torch.player import scheduler
    eq = [6.0, 3.0, 0.0, -3.0, -6.0, 0.0, 3.0, 0.0, -2.0, 1.0]
    clips = read_clips()
    names = list(clips)
    batch = [clips[names[i % len(names)]] for i in range(64)]
    track = read_track()
    for what, kw in (("player play 60 s", {}),
                     ("player play 60 s EQ", {"eq_gains_db": eq}),
                     ("player speed 0.75", {"speed": 0.75})):
        profile_run(what, lambda: mp3tpu_torch.play(track, device="cuda",
                                                     **kw).play(), card)
    profile_run("scheduler 64x10s", lambda: scheduler.decode_batch_streams(
        batch, n_slots=64, device="cuda"), card)
    for when in ("cold", "warm"):
        t0 = time.perf_counter()
        lv = mp3tpu_torch.levels(track, device="cuda")
        log(f"levels 60 s {when} {time.perf_counter() - t0:.4f} s {lv} ({card})")
    profile_encoder(batch, track, card)


def profile_encoder(batch: list, track: bytes, card: str) -> None:
    """The encoder's measurements behind PERF.md: one encode_batch under the
    profilers, the loops with and without the early exit, the row-block
    size, and device_loops on against off by stream length."""
    import mp3tpu_torch
    from mp3tpu_torch.encoder import vloop_device as vd
    fast = mp3tpu_torch.decode_batch(batch, device="cuda")
    pcm64 = [q16(pcm.astype(np.float64) / 32768.0 * (0.4 + 0.6 * i / 63))
             for i, (pcm, _) in enumerate(fast)]

    def enc(pcms):
        return mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cuda")

    profile_run("encode_batch 16x10s", lambda: enc(pcm64[:16]), card)
    profile_run("transcode_batch 16x10s", lambda: mp3tpu_torch.transcode_batch(
        batch[:16], bitrate=96, device="cuda"), card)
    ref = enc(pcm64)
    walls = {False: [], True: []}
    try:
        for fixed in (False, True, True, False, False, True):
            vd.FIXED_DEPTH = fixed
            out, w = timed_s(lambda: enc(pcm64))
            walls[fixed].append(w)
            if out != ref:
                raise AssertionError("fixed depth gives other bytes")
    finally:
        vd.FIXED_DEPTH = False
    log(f"encode_batch 64x10s: outer loops with the early exit "
        f"{[round(w, 4) for w in walls[False]]} s, at fixed depth "
        f"{[round(w, 4) for w in walls[True]]} s, the same bytes ({card})")
    block = vd.ROW_BLOCK["cuda"]
    try:
        for rows in (2048, 8192, 32768, 8192, 2048, 32768):
            vd.ROW_BLOCK["cuda"] = rows
            torch.cuda.reset_peak_memory_stats()
            out, w = timed_s(lambda: enc(pcm64))
            log(f"encode_batch 64x10s: row block {rows}: {w:.4f} s, peak device "
                f"memory {torch.cuda.max_memory_allocated() / (1 << 20):.1f} MiB, "
                f"bytes {'equal' if out == ref else 'DIFFER'} ({card})")
            if out != ref:
                raise AssertionError("the row block changes the bytes")
    finally:
        vd.ROW_BLOCK["cuda"] = block
    sig = mp3tpu_torch.decode(track, device="cuda")[0].astype(np.float64) / 32768.0
    for seconds in (0.1, 0.25, 0.5, 1.0, 2.0):
        cut = sig[20 * SR: 20 * SR + int(seconds * SR)]
        G = -(-(len(cut) + 1057) // 576)
        on = [timed_s(lambda: mp3tpu_torch.encode(
            cut, SR, bitrate=128, device="cuda", device_loops=True))[1]
            for _ in range(3)]
        off = timed_s(lambda: mp3tpu_torch.encode(
            cut, SR, bitrate=128, device="cuda", device_loops=False,
            device_transform=False))[1]
        log(f"encode {seconds} s stereo ({G} granules): device_loops on "
            f"{min(on):.4f} s (best of 3), off {off:.4f} s ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # the port imports neither JAX nor the JAX package: make sure of it
    sys.modules["jax"] = None
    sys.modules["mp3tpu"] = None
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import mp3tpu_torch  # noqa: F401  (fails outside the repository)

    if sys.argv[1:2] == ["--multichip-rank"]:
        return multichip_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    card = timed("environment", phase_environment)
    timed("build", phase_build)
    if sys.argv[1:] == ["--profile"]:
        profile_main(card)
        return 0
    if sys.argv[1:] == ["--variants"]:
        variants_main(card)
        return 0
    clips = timed("clips", read_clips)
    if sys.argv[1:] == ["--kernel"]:
        timed("kernel", phase_kernel, clips, card)
        return 0
    if sys.argv[1:] == ["--encode"]:
        import mp3tpu_torch
        names = list(clips)
        batch = [clips[names[i % len(names)]] for i in range(64)]
        fast = mp3tpu_torch.decode_batch(batch, device="cuda")
        timed("encode", phase_encode, clips, read_track(), batch, fast, card)
        return 0
    krec, check_calls = timed("kernel", phase_kernel, clips, card)
    paths = {}
    paths["decode_batch"], batch, fast = timed("decode_batch",
                                               phase_decode_batch, clips)
    timed("window_loop", window_loop_ms, batch, card)
    paths["device_batch"] = timed("device_batch", phase_device_batch, clips,
                                  batch, fast, card)
    timed("config3", phase_config3, card)
    track = timed("track", read_track)
    paths["player"] = timed("player", phase_player, track, card)
    paths["chunked"] = timed("chunked", phase_chunked, track, card)
    paths["scheduler"] = timed("scheduler", phase_scheduler, batch, fast, card)
    paths["soak"] = timed("soak", phase_soak, card)
    paths["transcode"] = timed("encode", phase_encode, clips, track, batch,
                               fast, card)
    timed("cli", phase_cli, clips, track, card)
    paths["bench"] = timed("bench", phase_bench, card)
    paths["tools"] = timed("tools", phase_tools, card)
    paths["multichip"] = timed("multichip", phase_multichip, clips, card)

    # each kernel's launches in the paths' runs, each counted from 0; the
    # kernel phase's calls apart. No path calls fused_frontend (nor its TPU
    # kernel, in the JAX package), so its path launches read 0; only the
    # tools path (the spike) launches the Huffman chain.
    # Times, errors and bounds at the shape and types of the decode_batch
    # run counted above (64 streams x 32 granules; widened planes: int32
    # spectrum, int16 exponents), the chain's at the spike's default case;
    # every timed case of the kernel phase in "cases".
    replaces = {"fused_z": "src/mp3tpu/kernels/pallas_fused.py:237",
                "fused_frontend": "src/mp3tpu/kernels/pallas_fused.py:72",
                "synth": "src/mp3tpu/kernels/pipeline.py:192 (jnp, no Pallas "
                         "kernel)",
                "huffman_dfa": "tools/device_huffman_spike.py:94-109 (jnp, no "
                               "Pallas kernel)",
                "rate_bisect": "none: src/mp3tpu/encoder/vloop_device.py's "
                               "rate loops are jnp",
                "rate_count": "none: src/mp3tpu/encoder/vloop_device.py's "
                              "count is jnp"}
    sources = {"synth": "src/mp3tpu_torch/csrc/synth.cu",
               "huffman_dfa": "src/mp3tpu_torch/csrc/huffman_dfa.cu",
               "rate_bisect": "src/mp3tpu_torch/csrc/rate_bisect.cu",
               "rate_count": "src/mp3tpu_torch/csrc/rate_bisect.cu"}
    rate_keys = ("kind", "rows", "ms", "wrapper_ms", "plain_ms", "bound_us",
                 "bound_share")
    case_keys = {"huffman_dfa": ("case", "table", "rows", "bits", "ms",
                                 "plain_ms", "bound_us", "bound_share",
                                 "bit_serial_bound_share"),
                 "rate_bisect": rate_keys, "rate_count": rate_keys}
    kernels = []
    for name, rep in replaces.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        if check_calls[name] <= 0:
            raise AssertionError(f"{name}: the kernel phase did not launch it")
        head = (krec[name][0] if name in case_keys else next(
            c for c in krec[name]
            if c["S"] == 64 and c["types"] in ("int32/int16", "float32")))
        keys = case_keys.get(name, ("S", "G", "types", "used_by", "ms",
                                    "ms_cold_l2", "bound_us", "bound_share"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources.get(name, "src/mp3tpu_torch/csrc/fused_z.cu"),
            "replaces": rep,
            "launches": sum(by_path.values()), "paths": by_path,
            "check_calls": check_calls[name], **head,
            "cases": [{k: c[k] for k in keys} for c in krec[name]]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
