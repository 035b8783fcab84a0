#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/mp3tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing its numbers and its seconds on lines of its own; any
failure raises and the script exits non-zero:
  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: the port's C++ host unpacker (csrc/unpack.cpp, g++) and the
     CUDA kernels (csrc/fused_z.cu, nvcc), both at once; the run fails if
     either does not build or load;
  3. kernel vs plain: fused_pipeline_z (C1-C5) and fused_frontend (C1-C4)
     through kernels/selfcheck.py's checks (odd pair counts, every input
     type, bit-identity across launches and batch sizes, zero pairs), then
     against their plain versions at the shapes and types each path hands
     them (KERNEL_CASES: the player's S=1, decode_batch's and the
     scheduler's S=64, config 3's S=256, windows of 32 granules; the
     chunked single-file decode's 36 and 18 rows of 130 granules), with the
     times (warm, and with a cold L2 from 2,048 pairs up), the bytes moved,
     the least time the card could take for them and the share of it
     reached;
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
  6. config 3: 256 streams x 10 s decoded and resampled to 48 kHz, timed by
     layer, stream 0 held against the same code on the CPU;
  7. player: the 60 s stereo track of tests/torch_clips through
     mp3tpu_torch.play: play == decode,
     seek into a later group == the slice, loop, snapshot/restore, the EQ
     against its CPU run, speed 0.75; time to first audio and realtime
     factors;
  8. chunked: the 60 s track through decode_symbols_chunked (rows of 128 + 2
     granules, int16 out) against decode() (at most 1 LSB, CHUNKED_EXACT
     exact) and both against the float64 oracle; its wall and launches
     with decode.d2h_segments_single 1 and 2, beside decode_symbols_device
     and decode() of the same track (medians of 5);
  9. scheduler: decode_batch_streams of the 64 streams at 64 slots against
     decode_batch, and decode_batch with decode.use_native=False, which
     goes through the scheduler;
 10. cli: mp3tpu_torch.cli.main in this process, on the card by default:
     info, decode (the WAV equals decode()), loudness, segments, split,
     play --loop to a WAV; split -f mp3 must raise.
The kernels' JSON record gives each kernel's launches in the runs of
decode_batch, the device-resident batch, the full play, the chunked decode
and the scheduler, each counted from 0 just before the run, and apart from
them the calls of the kernel phase. The line before the last is the card's;
the last line is {"ok": true, "device": {...}}. Imports nothing of JAX and
nothing of mp3tpu (the JAX package); needs no LAME.

    python3 chip_smoke.py --profile

instead profiles the player (plain, EQ, speed 0.75), the scheduler and
levels() under cProfile and torch.profiler, after the build, and prints the
tables.

    python3 chip_smoke.py --variants

instead times csrc/fused_z.cu's measurement variants (VARIANTS: a deeper
input ring, fewer blocks per SM, C5's arithmetic left out) against the
kernel as built.
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


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Milliseconds per call of fn(): the median over `reps` timings (CUDA
    events) of `inner` back-to-back calls each, after one warm-up. Each
    timing starts behind a 20 ms spin of the card, during which the host
    enqueues the calls: the events then time the device's work, not the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at 1.98 GHz
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def _wrappers() -> dict:
    from mp3tpu_torch.kernels import fused_z as fz
    return {"fused_z": fz.fused_pipeline_z, "fused_frontend": fz.fused_frontend}


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
    """The C++ unpacker and the CUDA library, built at once; raises if
    either does not build or load."""
    from concurrent.futures import ThreadPoolExecutor
    from mp3tpu_torch.bitstream import native
    from mp3tpu_torch.kernels import build, fused_z

    def timed_build(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"build: {nvcc[-1]}")
    with ThreadPoolExecutor(2) as ex:
        unpacker = ex.submit(timed_build, native._load)
        kernels = ex.submit(timed_build, fused_z._library)
        lib, s_unpack = unpacker.result()
        _, s_cuda = kernels.result()
    if lib is None:
        raise RuntimeError("the C++ unpacker did not load (MP3TPU_NO_NATIVE "
                           "set, or no g++)")
    for src, s in (("unpack.cpp", s_unpack), ("fused_z.cu", s_cuda)):
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
                "library_ms": None, "bytes": b["bytes"],
                "bound_us": b["bound_us"],
                "bound_share": share_cold if cold else share,
                "bound_share_warm_l2": share})
    return rec, read_counts()


# csrc/fused_z.cu's measurement variants: (name, macros)
VARIANTS = (("as built", ()),
            ("3 stages", ("MP3TPU_FZ_STAGES=3",)),
            ("4 stages", ("MP3TPU_FZ_STAGES=4",)),
            ("3 blocks per SM", ("MP3TPU_FZ_BLOCKS_PER_SM=3",)),
            ("no C5 arithmetic", ("MP3TPU_FZ_NO_C5=1",)))


def variants_main(card: str) -> None:
    """Each measurement variant of csrc/fused_z.cu (all built at once),
    timed against the kernel as built at S=64 and S=256 (int32 symbols),
    warm and with a cold L2; every variant but the one without C5 must give
    the bits of the kernel as built."""
    from concurrent.futures import ThreadPoolExecutor
    from mp3tpu_torch.kernels import fused_z as fz
    from mp3tpu_torch.kernels import selfcheck as sc
    from mp3tpu_torch.kernels.tables import build_tables
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        list(ex.map(fz._library, [d for _, d in VARIANTS]))
    tables = build_tables(SR, "cuda")
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
    if launches["fused_z"] <= 0:
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
    if launches["fused_z"] <= 0:
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


# The chunked decode against decode(): both float32, the 512-term synthesis
# product summed by cuBLAS at two shapes ([rows * 2 * 2340, 512] against
# [1152, 512]), so a sample within 1e-2 LSB of a rounding boundary can land
# on either side. On the CPU the two are equal sample for sample
# (tests/test_torch_chunked.py holds 99.9% there).
CHUNKED_EXACT = 0.998


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
                f"(held to {CHUNKED_EXACT}; over 0.999: {exact > 0.999})")
            if got.shape != ref.shape or d.max() > 1 or exact < CHUNKED_EXACT:
                raise AssertionError("chunked decode outside 1 LSB / "
                                     f"{CHUNKED_EXACT} exact")
            compare_i16(got[:n_or], oracle[:n_or],
                        f"chunked (K={k}) vs the float64 oracle, first "
                        f"{n_or / SR:.1f} s")
            calls = k if rows >= 2 * k and rows % k == 0 else 1
            if launches[k]["fused_z"] != calls:
                raise AssertionError(f"chunked decode: {launches[k]} launches, "
                                     f"expected {calls}")
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
        try:
            run(["split", paths["track60"], "-f", "mp3", "-d",
                 os.path.join(d, "mp3")])
        except NotImplementedError as e:
            log(f"cli split -f mp3: raises NotImplementedError ({e})")
        else:
            raise AssertionError("cli split -f mp3 did not raise")
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
        if launches["fused_z"] <= 0:
            raise AssertionError("the cli did not go through the kernel")


def phase_config3(clips: dict, card: str) -> None:
    """BASELINE config 3: one uint8 arena per window for all S streams
    (4-bit spectrum, int8 sideband, byte exponents), one H2D, the split
    into planes, decode and one resample on the device."""
    from mp3tpu_torch.kernels import pipeline as kp
    from mp3tpu_torch.pipeline import probe_granules, stream_meta, unpack_planes
    S = 256
    body = stream_meta(clips["tonal"])[0]   # fits the 4-bit plane family
    G = probe_granules(body)                # the last window is zero-padded
    n_win = -(-G // WIN)

    t0 = time.perf_counter()
    got = unpack_planes([body] * S, [G] * S, S, WIN, plane_bits=4)
    if got is None or got[2:] != (4, True):
        raise AssertionError("config3: the clip leaves the 4-bit plane family")
    planes = got[0]
    host = kp.pack_window_arenas(planes, S, WIN)
    t_unpack = time.perf_counter() - t0

    def stage():
        dev = torch.from_numpy(host).cuda()
        torch.cuda.synchronize()
        return dev

    def device(dev):
        parts = [kp._split_window_arena(dev[w], S, WIN) for w in range(n_win)]
        x = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        out = kp.decode_all_windows_flat_resampled_i16(
            x["is12"], x["exp"], x["esc"], x["bt"], x["mx"], x["smode"],
            kp.init_state(S, device="cuda"),
            kp.init_resample_state(S, SR, device="cuda"), SR, 48000,
            plane_bits=4)
        torch.cuda.synchronize()
        return out

    device(stage())  # warm-up: cuBLAS handles, allocator
    t0 = time.perf_counter()
    dev = stage()
    t_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcm16, _, _ = device(dev)
    t_dev = time.perf_counter() - t0
    wall = t_unpack + t_h2d + t_dev
    audio_s = S * G * 576 / SR
    log(f"config3: {S} streams x {G * 576 / SR:.3f} s -> 48 kHz int16 "
        f"{tuple(pcm16.shape)}")
    log(f"config3: host unpack {t_unpack:.4f} s, H2D {t_h2d:.4f} s "
        f"({host.nbytes / 1e6:.1f} MB), device {t_dev:.4f} s, wall {wall:.4f} s "
        f"({card})")
    log(f"config3: aggregate realtime factor {audio_s / wall:.1f}x, "
        f"device-only {audio_s / t_dev:.1f}x ({card})")

    ref, _, _ = kp.decode_all_windows_flat_resampled_i16(
        *(torch.from_numpy(np.ascontiguousarray(planes[k][:, :1]))
          for k in ("is12", "exp", "esc", "bt", "mx", "smode")),
        kp.init_state(1, device="cpu"),
        kp.init_resample_state(1, SR, device="cpu"), SR, 48000, plane_bits=4)
    n2 = 2 * 48000
    got = pcm16[0, :n2].cpu().numpy()
    if int(np.abs(got).max()) == 0:
        raise AssertionError("config3: silent output")
    compare_i16(got, ref[0, :n2].numpy(), "config3 stream 0 vs CPU, first 2 s")


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
    if launches["fused_z"] <= 0:
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
    if launches["fused_z"] <= 0:
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
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # the port imports neither JAX nor the JAX package: make sure of it
    sys.modules["jax"] = None
    sys.modules["mp3tpu"] = None
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import mp3tpu_torch  # noqa: F401  (fails outside the repository)

    card = timed("environment", phase_environment)
    timed("build", phase_build)
    if sys.argv[1:] == ["--profile"]:
        profile_main(card)
        return 0
    if sys.argv[1:] == ["--variants"]:
        variants_main(card)
        return 0
    clips = timed("clips", read_clips)
    krec, check_calls = timed("kernel", phase_kernel, clips, card)
    paths = {}
    paths["decode_batch"], batch, fast = timed("decode_batch",
                                               phase_decode_batch, clips)
    timed("window_loop", window_loop_ms, batch, card)
    paths["device_batch"] = timed("device_batch", phase_device_batch, clips,
                                  batch, fast, card)
    timed("config3", phase_config3, clips, card)
    track = timed("track", read_track)
    paths["player"] = timed("player", phase_player, track, card)
    paths["chunked"] = timed("chunked", phase_chunked, track, card)
    paths["scheduler"] = timed("scheduler", phase_scheduler, batch, fast, card)
    timed("cli", phase_cli, clips, track, card)

    # each kernel's launches in the five paths' runs, each counted from 0;
    # the kernel phase's calls apart. No path calls fused_frontend (nor its
    # TPU kernel, in the JAX package), so its path launches read 0.
    # Times, errors and bounds at the shape and types of the decode_batch
    # run counted above (64 streams x 32 granules, widened planes: int32
    # spectrum, int16 exponents); every case of the kernel phase in "cases".
    replaces = {"fused_z": "src/mp3tpu/kernels/pallas_fused.py:237",
                "fused_frontend": "src/mp3tpu/kernels/pallas_fused.py:72"}
    kernels = []
    for name, rep in replaces.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        if check_calls[name] <= 0:
            raise AssertionError(f"{name}: the kernel phase did not launch it")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/mp3tpu_torch/csrc/fused_z.cu", "replaces": rep,
            "launches": sum(by_path.values()), "paths": by_path,
            "check_calls": check_calls[name],
            **next(c for c in krec[name]
                   if c["S"] == 64 and c["types"] == "int32/int16"),
            "cases": [{k: c[k] for k in ("S", "G", "types", "used_by", "ms",
                                         "ms_cold_l2", "bound_us", "bound_share")}
                      for c in krec[name]]})
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
