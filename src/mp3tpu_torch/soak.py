"""Hour-scale scheduler soak of the PyTorch port (counterpart of the
repository's tools/soak.py, which stays the JAX package's).

Hundreds of streams churn through the port's StreamScheduler in waves, its
elastic refill taking them into its slots. Every Nth stream is corrupted,
by three kinds in turn: byte flips inside side info and main data, a cut of
the leading audio frames that leaves a reservoir back-pointer dangling, and
a broken frame header that makes the container scan resync. Live
ring-buffer consumer threads drain every Mth stream while the scheduler
routes into it, corrupted streams included. On a card every step launches
csrc/fused_z.cu (C1-C5) and csrc/synth.cu (C6-C7).

check_report() raises on any broken invariant of the report run_soak()
returns (check_session() holds all but the two rates, check_rates() those
two, which read host walls):
* no stream lost: every submitted stream finishes;
* exact accounting: every stream, clean, corrupted or ring-drained, routes
  exactly the sample count its own container scan implies;
* the fault counters fire (frames_error, granules_muted, resyncs) and no
  sink underruns;
* every clean stream that no ring drains is held, push by push as it
  arrives, within 1 LSB and at least 98% exact of decode_file's PCM of its
  clip, without keeping its PCM: the crackle detector;
* every wave decodes faster than realtime, and the last third of the
  waves runs at least 0.6 of the first third's rate;
* bounded memory after the first wave (memory_growth(), from the end of
  wave 2 on): host RSS grows by less than 300 MB; on a card,
  memory_allocated at each wave's end stays within 1 MiB of its value
  there, either way, and memory_reserved grows by at most 64 MiB.

    python -m mp3tpu_torch.soak [--seconds 3600] [--device cuda] [--out PATH]

prints the report without its waves and its per-stream accounting as one
JSON line (naming the card), writes the whole report to --out when given,
and exits non-zero when check_report raises. --device cuda, the default,
needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

from .player.sink import Sink

SR = 44100
_MIB = float(1 << 20)


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _signals(seed: int = 11) -> list:
    """The six base signals of the pool, 6-10 s each: tonal, transient,
    noise and sweep content, mono and stereo in turn (tools/soak.py's)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, secs in enumerate((6.0, 7.5, 6.5, 8.0, 10.0, 7.0)):
        n = int(secs * SR)
        t = np.arange(n) / SR
        kind = i % 4
        if kind == 0:
            sig = 0.45 * np.sin(2 * np.pi * (300 + 40 * i) * t) \
                + 0.15 * np.sin(2 * np.pi * 2500 * t)
        elif kind == 1:
            sig = 0.02 * rng.standard_normal(n)
            for j in range(0, n - 500, SR // 4):
                sig[j:j + 300] += 0.6 * np.hanning(300) * np.sin(
                    2 * np.pi * 1700 * np.arange(300) / SR)
        elif kind == 2:
            sig = 0.25 * rng.standard_normal(n)
        else:
            k = np.log(3000.0 / 150.0)
            ph = 2 * np.pi * 150.0 * (np.exp(t / t[-1] * k) - 1) * t[-1] / k
            sig = 0.4 * np.sin(ph)
        out.append(sig if i % 2 == 0 else np.stack([sig, np.roll(sig, 5)], 1))
    return out


def _pool(device) -> list:
    """The six signals as 128 kbps MP3. On the CPU the host encode_pcm,
    byte for byte the JAX package's pool; on a card encode_batch on that
    card, one call for the mono streams and one for the stereo."""
    sigs = _signals()
    dev = torch.device(device)
    if dev.type == "cpu":
        from .encoder import encode_pcm
        return [encode_pcm(s, SR, bitrate=128, device="cpu") for s in sigs]
    from .encoder import encode_batch
    out = [None] * len(sigs)
    for ndim in (1, 2):
        idx = [i for i, s in enumerate(sigs) if s.ndim == ndim]
        mp3s = encode_batch([sigs[i] for i in idx], SR, bitrate=128, device=dev)
        for i, mp3 in zip(idx, mp3s):
            out[i] = mp3
    return out


# ---- corruption (three kinds, each keeping the scan-exact accounting) --

def _scan(mp3: bytes):
    from .container import frames as fr
    return fr.scan_frames(np.frombuffer(mp3, np.uint8))


def _corrupt_flip(mp3: bytes, rng, n_hits: int = 4) -> bytes:
    """Flip bytes inside side info and main data of mid-file audio frames.
    Headers stay, so the frame geometry, and the expected sample count,
    is kept exactly."""
    idx = _scan(mp3)
    b = bytearray(mp3)
    for _ in range(n_hits):
        j = int(rng.integers(3, idx.n_frames - 1))
        off = int(idx.offsets[j])
        h = idx.headers[j]
        lo = off + 4 + (2 if h.crc_protected else 0)
        pos = int(rng.integers(lo, off + h.frame_bytes))
        b[pos] ^= int(rng.integers(1, 256))
    return bytes(b)


def _corrupt_cut(mp3: bytes, rng) -> bytes:
    """Drop the leading audio frames up to a mid-file frame whose reservoir
    back-pointer is nonzero: at its new position the pointer reaches behind
    the first byte, and the reservoir underflow mutes its granules. The
    metadata frame (the gapless tag) is kept."""
    idx = _scan(mp3)
    j = 4
    for _ in range(32):
        j = int(rng.integers(4, idx.n_frames - 4))
        off = int(idx.offsets[j])
        h = idx.headers[j]
        si = off + 4 + (2 if h.crc_protected else 0)
        if (mp3[si] << 1) | (mp3[si + 1] >> 7):  # main_data_begin != 0
            break
    return mp3[: int(idx.offsets[1])] + mp3[int(idx.offsets[j]):]


def _corrupt_header(mp3: bytes, rng) -> bytes:
    """Break one mid-file frame header: the scan loses sync over that frame
    and resyncs (FrameIndex.resyncs)."""
    idx = _scan(mp3)
    j = int(rng.integers(4, idx.n_frames - 4))
    b = bytearray(mp3)
    b[int(idx.offsets[j])] = 0x00   # kill the syncword
    return bytes(b)


_CORRUPTIONS = (("flip", _corrupt_flip),
                ("cut", _corrupt_cut),
                ("header", _corrupt_header))


def _expected_samples(data: bytes) -> int:
    """The sample count the scheduler must route for these exact bytes:
    granules from the container scan, gapless bounds from the same parse
    submit() performs; valid for every corruption kind."""
    from .pipeline import load_source
    from .player.scheduler import gapless_bounds_of
    src, _info, _index = load_source(data)
    total = src.n_granules * 576
    skip, end = gapless_bounds_of(data, src.n_granules)
    hi = total if end is None else min(end, total)
    return max(hi - skip, 0)


class _RingConsumer:
    """A live consumer thread on a RingBuffer the scheduler routes into."""

    def __init__(self, ring):
        self.ring = ring
        self.samples = 0
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        # RingBuffer.pop(n) always returns n samples, zero-padded on an
        # underrun (a realtime callback's semantics): drain by `fill`, or
        # the thread spins and never sees the ring empty
        while True:
            avail = self.ring.fill
            if avail:
                self.samples += len(self.ring.pop(min(1024, avail)))
            else:
                if self.done.is_set():
                    return
                time.sleep(0.0005)


class _RingSink(Sink):
    """Pushes into a ring, waiting while the ring is full."""

    def __init__(self, ring):
        self.ring = ring

    @property
    def underruns(self):
        return self.ring.underruns

    def push(self, pcm):
        off = 0
        while off < len(pcm):
            n = self.ring.push(pcm[off:])
            off += n
            if n == 0:
                time.sleep(0.0005)


class _CountSink(Sink):
    """Counts the samples it is pushed and keeps none."""

    def __init__(self):
        self.samples = 0

    def push(self, pcm):
        self.samples += len(pcm)


class _CheckSink(Sink):
    """Holds each push, as it arrives, against the same samples of `ref`
    (decode_file's PCM of the stream's clip) and keeps no PCM: the largest
    difference in LSB, the values equal, and whether every push lined up
    with `ref` in shape."""

    def __init__(self, ref: np.ndarray):
        self.ref = ref
        self.samples = 0
        self.max_lsb = 0
        self.exact = 0
        self.values = 0
        self.aligned = True

    def push(self, pcm):
        want = self.ref[self.samples:self.samples + len(pcm)]
        self.samples += len(pcm)
        if want.shape != pcm.shape:
            self.aligned = False
            return
        d = np.abs(pcm.astype(np.int32) - want.astype(np.int32))
        self.max_lsb = max(self.max_lsb, int(d.max(initial=0)))
        self.exact += int(np.count_nonzero(d == 0))
        self.values += d.size


def prepare(device="cuda", pool=None, n_slots: int = 8, win: int = 32) -> dict:
    """What a session needs before its first wave: the pool (encoded on
    `device` by _pool unless a list of MP3 bytes is given), each clip's
    decode_file PCM on `device`, and the sample count the scheduler must
    route for it; and the device warmed: the kernels built and one window
    of the session's scheduler shape run, so the first wave is not a
    build."""
    from .pipeline import decode_file
    from .player import StreamScheduler
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device here; the soak "
                           "does not fall back to the CPU (device='cpu' asks "
                           "for it)")
    rss = _rss_mb()
    pool = _pool(dev) if pool is None else [bytes(p) for p in pool]
    refs = [decode_file(mp3, device=dev)[0] for mp3 in pool]
    warm = StreamScheduler(n_slots=n_slots, win=win, sample_rate=SR, device=dev)
    warm.submit(pool[0], sink=_CountSink())
    warm.step()
    return {"device": dev, "pool": pool, "refs": refs,
            "expected": [_expected_samples(mp3) for mp3 in pool],
            "rss_before_mb": rss}


def _device_mb(dev) -> tuple:
    """(memory_allocated, memory_reserved) of a card in MiB, or (None, None)
    on the CPU."""
    if dev.type != "cuda":
        return None, None
    return (torch.cuda.memory_allocated(dev) / _MIB,
            torch.cuda.memory_reserved(dev) / _MIB)


def memory_growth(waves: list) -> dict:
    """The report's memory figures after the first wave, which they leave
    out as the JAX harness leaves out its compiles: how far host RSS and
    memory_reserved rose above their values at the end of wave 2, and how
    far memory_allocated moved from its value there, either way (None on
    the CPU)."""
    post = waves[1:] or waves

    def move(key, either_way=False):
        if post[0][key] is None:
            return None
        d = [w[key] - post[0][key] for w in post]
        return max(abs(x) for x in d) if either_way else max(d)

    return {"rss_growth_post_warmup_mb": move("rss_mb"),
            "device_alloc_growth_post_warmup_mb": move("device_alloc_mb", True),
            "device_reserved_growth_post_warmup_mb": move("device_reserved_mb")}


def run_soak(total_audio_s: float = 3600.0, n_slots: int = 8, win: int = 32,
             corrupt_every: int = 7, ring_every: int = 13,
             wave_streams: int = 24, seed: int = 5, device="cuda", pool=None,
             prepared: dict | None = None) -> dict:
    """Run the session on `device` (a card unless the caller asks for the
    CPU) and return its report; check_report() holds its invariants.
    `pool` replaces the six encoded signals by the given MP3 bytes;
    `prepared` is prepare()'s result, for a caller that counts the
    session's kernel launches apart from the set-up's."""
    from .player import RingBuffer, StreamScheduler
    prep = prepare(device, pool, n_slots, win) if prepared is None else prepared
    dev, pool = prep["device"], prep["pool"]
    refs, expected = prep["refs"], prep["expected"]
    durations = [len(r) / SR for r in refs]
    if dev.type == "cuda":
        from .bench import card_line
        card = card_line()
    else:
        card = "cpu"

    rng = np.random.default_rng(seed)
    sched = StreamScheduler(n_slots=n_slots, win=win, sample_rate=SR,
                            device=dev)
    report = {"device": str(dev), "card": card, "waves": [], "n_streams": 0,
              "n_corrupted": 0, "n_kind": {k: 0 for k, _ in _CORRUPTIONS},
              "n_ring_consumers": 0, "config": {
                  "n_slots": n_slots, "win": win,
                  "corrupt_every": corrupt_every, "ring_every": ring_every,
                  "wave_streams": wave_streams, "seed": seed,
                  "total_audio_s": total_audio_s}}
    rss0 = _rss_mb()
    consumers = []
    checks = []       # the _CheckSinks of the clean streams no ring drains
    accounting = []   # [stream_id, kind, sink, expected, count getter]
    submitted_audio = 0.0
    sid = 0
    t_session = time.perf_counter()

    while submitted_audio < total_audio_s:
        # ---- submit one wave (the scheduler's refill takes the streams
        # into its slots as they come)
        n_wave = 0
        wave_consumers = []
        for _ in range(wave_streams):
            if submitted_audio >= total_audio_s:
                break
            k = int(rng.integers(len(pool)))
            data, kind, want = pool[k], "clean", expected[k]
            if sid % corrupt_every == corrupt_every - 1:
                kind, fn = _CORRUPTIONS[
                    report["n_corrupted"] % len(_CORRUPTIONS)]
                data = fn(data, rng)
                want = _expected_samples(data)
                report["n_corrupted"] += 1
                report["n_kind"][kind] += 1
            # ring consumers attach whatever the corruption: the concurrent
            # path must survive corrupted streams too
            if sid % ring_every == ring_every - 1:
                ring = RingBuffer(1 << 15, 2)
                sink = _RingSink(ring)
                c = _RingConsumer(ring)
                consumers.append(c)
                wave_consumers.append(c)
                report["n_ring_consumers"] += 1
                role, got = "ring", (lambda c=c: c.samples)
            elif kind == "clean":
                sink = _CheckSink(refs[k])
                checks.append(sink)
                role, got = "check", (lambda s=sink: s.samples)
            else:
                sink = _CountSink()
                role, got = "count", (lambda s=sink: s.samples)
            accounting.append([sid, kind, role, want, got])
            sched.submit(data, sink=sink, stream_id=sid)
            submitted_audio += durations[k]
            report["n_streams"] += 1
            n_wave += 1
            sid += 1

        # ---- drain this wave while measuring
        s0 = sched.metrics.samples_out
        t0 = time.perf_counter()
        sched.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        w = time.perf_counter() - t0
        d = sched.metrics.samples_out - s0
        # this wave's consumers drain their tail and exit: consumers left
        # spinning until the end of the session would slow every later
        # wave by their count, not by anything of the scheduler's
        for c in wave_consumers:
            c.done.set()
        alloc, reserved = _device_mb(dev)
        report["waves"].append({
            "streams": n_wave, "audio_s": d / SR, "wall_s": w,
            "x_realtime": d / SR / max(w, 1e-9), "rss_mb": _rss_mb(),
            "device_alloc_mb": alloc, "device_reserved_mb": reserved})

    for c in consumers:
        c.done.set()
    for c in consumers:
        c.thread.join(timeout=10.0)

    waves = report["waves"]
    xs = [w["x_realtime"] for w in waves]
    third = max(len(xs) // 3, 1)
    report.update({
        "session_wall_s": time.perf_counter() - t_session,
        "steps": sched.steps,
        "min_wave_x": min(xs),
        "first_third_x": float(np.mean(xs[:third])),
        "last_third_x": float(np.mean(xs[-third:])),
        "rss_before_prepare_mb": prep["rss_before_mb"],
        "rss_start_mb": rss0,
        "rss_peak_mb": max(w["rss_mb"] for w in waves),
        **memory_growth(waves),
        "metrics": sched.metrics.to_dict(),
        "scheduler_drained": sched.n_active == 0 and not sched.queue,
        "accounting": [row[:4] + [row[4]()] for row in accounting],
        "streams_sample_checked": len(accounting),
        "ring_samples_drained": int(sum(c.samples for c in consumers)),
        "clean_streams_checked": len(checks),
        "clean_max_abs_lsb": max((s.max_lsb for s in checks), default=None),
        "clean_min_exact": min((s.exact / max(s.values, 1) for s in checks),
                               default=None),
        "clean_misaligned": sum(not s.aligned or s.samples != len(s.ref)
                                for s in checks),
    })
    return report


def _need(ok, what) -> None:
    if not ok:
        raise AssertionError(f"soak: {what}")


def check_report(rep: dict) -> None:
    """Raise AssertionError naming the first broken invariant of a run_soak
    report (see the module's docstring)."""
    check_session(rep)
    check_rates(rep)


def check_rates(rep: dict) -> None:
    """The report's two wall-clock invariants: every wave faster than
    realtime, and the last third of the waves at least 0.6 of the first
    third's rate."""
    _need(rep["min_wave_x"] >= 1.0,
          f"a wave ran at {rep['min_wave_x']}x realtime")
    _need(rep["last_third_x"] >= 0.6 * rep["first_third_x"],
          f"throughput decayed: last third {rep['last_third_x']}x, first "
          f"{rep['first_third_x']}x")


def check_session(rep: dict) -> None:
    """Every invariant of check_report but check_rates': accounting, the
    fault counters, the clean streams against decode_file, and bounded
    memory."""
    m = rep["metrics"]
    rows = rep["accounting"]
    _need(rep["n_streams"] >= 1 and len(rows) == rep["n_streams"]
          == rep["streams_sample_checked"],
          f"{len(rows)} streams accounted of {rep['n_streams']}")
    _need(m["streams_finished"] == rep["n_streams"],
          f"streams lost: {m['streams_finished']} of {rep['n_streams']} finished")
    _need(rep["scheduler_drained"], "scheduler stuck: slots active or queued")
    bad = [r for r in rows if r[3] != r[4]]
    _need(not bad, f"sample accounting off for {len(bad)} streams "
          f"([stream, kind, sink, expected, routed]): {bad[:5]}")
    kinds = {k: sum(r[1] == k for r in rows) for k in rep["n_kind"]}
    _need(kinds == rep["n_kind"]
          and sum(kinds.values()) == rep["n_corrupted"],
          f"corruption counts {rep['n_kind']} against the streams' {kinds}")
    _need(all(v >= 1 for v in kinds.values()),
          f"a corruption kind never ran: {kinds}")
    ring = [r for r in rows if r[2] == "ring"]
    _need(len(ring) == rep["n_ring_consumers"]
          and {r[1] == "clean" for r in ring} == {True, False},
          "ring consumers must drain clean and corrupted streams")
    _need(rep["ring_samples_drained"] == sum(r[4] for r in ring) > 0,
          f"ring consumers drained {rep['ring_samples_drained']} samples")
    # the fault taxonomy reached the scheduler's counters
    for key in ("frames_ok", "frames_error", "granules_muted", "resyncs"):
        _need(m[key] > 0, f"metrics.{key} is {m[key]}")
    _need(m["underruns"] == 0, f"{m['underruns']} underruns")
    # every clean stream that no ring drains was held to decode_file
    clean = [r for r in rows if r[1] == "clean" and r[2] != "ring"]
    _need(all(r[2] == "check" for r in clean)
          and rep["clean_streams_checked"] == len(clean) >= 1,
          f"{rep['clean_streams_checked']} clean streams checked of "
          f"{len(clean)}")
    _need(rep["clean_misaligned"] == 0,
          f"{rep['clean_misaligned']} clean streams out of line with decode_file")
    _need(rep["clean_max_abs_lsb"] <= 1 and rep["clean_min_exact"] >= 0.98,
          f"clean streams against decode_file: max {rep['clean_max_abs_lsb']} "
          f"LSB, exact share {rep['clean_min_exact']}")
    # bounded memory
    _need(rep["rss_growth_post_warmup_mb"] < 300.0,
          f"RSS grew {rep['rss_growth_post_warmup_mb']} MB after wave 1")
    if rep["device"].startswith("cuda"):
        drift = rep["device_alloc_growth_post_warmup_mb"]
        _need(drift <= 1.0, f"memory_allocated moved {drift} MiB after wave 1")
        _need(rep["device_reserved_growth_post_warmup_mb"] <= 64.0,
              f"memory_reserved grew "
              f"{rep['device_reserved_growth_post_warmup_mb']} MiB after wave 1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.soak",
        description="hour-scale scheduler soak: corrupted streams, live ring "
                    "consumers, exact accounting, bounded memory")
    ap.add_argument("--seconds", type=float, default=3600.0,
                    help="audio seconds submitted in all (default 3600)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to the CPU)")
    ap.add_argument("--out", help="write the whole report here as JSON")
    args = ap.parse_args(argv)
    rep = run_soak(total_audio_s=args.seconds, device=args.device)
    print(json.dumps({k: v for k, v in rep.items()
                      if k not in ("waves", "accounting")}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    check_report(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
