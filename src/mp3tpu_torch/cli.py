"""Command line of the PyTorch port (counterpart of mp3tpu.cli):
decode | play | practice | encode | transcode | info | segments | split |
loudness, each with the JAX CLI's arguments and JSON output, and --device
(default cuda; cpu runs the kernels' plain versions). bench comes with the
benchmark.

    python -m mp3tpu_torch.cli info track.mp3 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _wav_sink_for(path, out: str, device):
    """A WavFileSink at `out` with the rate and channels of track `path`."""
    from .player import Player, WavFileSink
    probe = Player(path, device=device)
    return WavFileSink(out, probe.track.sample_rate, probe.track.channels)


def _cmd_decode(args):
    from .pipeline import decode_file
    from .player.sink import WavFileSink
    t0 = time.perf_counter()
    pcm, sr = decode_file(args.input, gapless=not args.no_gapless,
                          device=args.device)
    dt = time.perf_counter() - t0
    out = args.output or (args.input.rsplit(".", 1)[0] + ".wav")
    sink = WavFileSink(out, sr, pcm.shape[1])
    sink.push(pcm)
    sink.close()
    print(f"decoded {len(pcm)} samples @ {sr} Hz -> {out} "
          f"({len(pcm) / sr / dt:.1f}x realtime)")


def _cmd_play(args):
    """Headless play: decode (with seek/loop) to a WAV sink. Several inputs
    play as one gapless queue (PlayQueue)."""
    from .player import Player, PlayQueue
    first, dev = args.input[0], args.device
    eq = [float(x) for x in args.eq.split(",")] if args.eq else None
    if len(args.input) > 1:
        if args.segments or args.segment is not None or args.loop \
                or args.seek:
            raise SystemExit(
                "--segments/--segment/--loop/--seek need a single input")
        sink = _wav_sink_for(first, args.output, dev) if args.output else None
        q = PlayQueue(args.input, sink=sink, gain_db=args.gain,
                      eq_gains_db=eq, speed=args.speed,
                      normalize=args.normalize, device=dev)
        q.play()
        if sink:
            sink.close()
        print(json.dumps({"tracks": q.n_tracks,
                          "metrics": q.metrics.to_dict()}))
        return
    if args.segments:  # analysis only: never open an output sink
        p = Player(first, device=dev)
        print(json.dumps({"segments": [[round(a, 3), round(b, 3)]
                                       for a, b in p.segments()]}))
        return
    sink = _wav_sink_for(first, args.output, dev) if args.output else None
    gain = args.gain
    if args.normalize:  # single track: match to the target directly
        from .dsp.loudness import TARGET_DB, normalization_gain_db
        from .pipeline import track_levels
        ld, pk = track_levels(first, device=dev)
        gain = args.gain + normalization_gain_db(
            ld, TARGET_DB, peak_db=pk, base_gain_db=args.gain)
    p = Player(first, sink=sink, gain_db=gain, eq_gains_db=eq,
               speed=args.speed, device=dev)
    if args.segment is not None:
        p.play_segment(args.segment, times=args.times)
    elif args.loop:
        a, b = (float(x) for x in args.loop.split(":"))
        p.loop(a, b, times=args.times)
    else:
        if args.seek:
            p.seek(args.seek)
        p.play()
    if sink:
        sink.close()
    print(json.dumps({"duration": p.duration, "metadata": p.metadata,
                      "metrics": p.metrics.to_dict()}, default=str))


def _cmd_practice(args):
    """Sentence-repeat practice: segment the file, then play each
    sentence --times times at --speed with --gap seconds of silence after
    every repetition."""
    from .player import Player
    sink = (_wav_sink_for(args.input, args.output, args.device)
            if args.output else None)
    p = Player(args.input, sink=sink, gain_db=args.gain, device=args.device)
    segs = p.practice(times=args.times, gap_s=args.gap,
                      speed=args.speed if args.speed != 1.0 else None,
                      start=args.start, stop=args.stop)
    if sink:
        sink.close()
    print(json.dumps({
        "sentences": [[round(a, 3), round(b, 3)] for a, b in segs],
        "times": args.times, "speed": p.speed, "gap_s": args.gap,
        "metrics": p.metrics.to_dict()}))


def _cmd_segments(args):
    """Library indexing: silence-split boundaries of many files through the
    device-resident batch decode (no PCM comes to the host)."""
    from .pipeline import segment_files
    res = segment_files(args.input, device=args.device)
    out = {p: [[round(a, 3), round(b, 3)] for a, b in segs]
           for p, segs in zip(args.input, res)}
    print(json.dumps(out))


def _cmd_split(args):
    """Export each sentence as its own clip file (wav or mp3)."""
    from .pipeline import split_file
    paths = split_file(args.input, args.out_dir, fmt=args.format,
                       bitrate=args.bitrate, device=args.device)
    print(json.dumps({"clips": paths}))


def _cmd_encode(args):
    import struct
    import numpy as np
    from .encoder import encode_pcm
    with open(args.input, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF":
        raise SystemExit("encode expects a 16-bit PCM WAV input")
    ch = struct.unpack("<H", data[22:24])[0]
    sr = struct.unpack("<I", data[24:28])[0]
    i = data.index(b"data")
    pcm = np.frombuffer(data[i + 8:], "<i2").astype(np.float64) / 32768.0
    pcm = pcm.reshape(-1, ch)
    t0 = time.perf_counter()
    mp3 = encode_pcm(pcm, sr, bitrate=args.bitrate,
                     vbr_quality=args.vbr_quality, device=args.device)
    dt = time.perf_counter() - t0
    out = args.output or (args.input.rsplit(".", 1)[0] + ".mp3")
    with open(out, "wb") as f:
        f.write(mp3)
    print(f"encoded {len(pcm)} samples -> {out} ({len(mp3)} bytes, "
          f"{len(pcm) / sr / dt:.1f}x realtime)")


def _cmd_transcode(args):
    """Batched MP3->MP3 re-encode at a new bitrate; the PCM stays on the
    device between decode and encode (api.transcode_batch)."""
    import os
    from .api import transcode_batch
    t0 = time.perf_counter()
    blobs = transcode_batch(args.input, bitrate=args.bitrate,
                            device=args.device)
    dt = time.perf_counter() - t0
    outs = []
    for p, b in zip(args.input, blobs):
        base = os.path.basename(p).rsplit(".", 1)[0] + ".transcoded.mp3"
        out = os.path.join(args.out_dir, base)
        with open(out, "wb") as f:
            f.write(b)
        outs.append(out)
    print(json.dumps({"outputs": outs, "wall_s": round(dt, 3)}))


def _cmd_loudness(args):
    """Per-track loudness and peak, and the clipping-safe gain that would
    bring each to the target (what `play --normalize` applies)."""
    from .dsp.loudness import TARGET_DB, normalization_gain_db
    from .pipeline import track_levels_batch
    tgt = TARGET_DB if args.target is None else args.target
    out = {}
    levels = track_levels_batch(args.input, device=args.device)
    for p, (ld, pk) in zip(args.input, levels):
        out[p] = {"loudness_db": round(ld, 2), "peak_db": round(pk, 2),
                  "gain_db": round(normalization_gain_db(
                      ld, tgt, peak_db=pk), 2)}
    print(json.dumps({"target_db": tgt, "tracks": out}))


def _cmd_info(args):
    from .player.engine import open_track
    t = open_track(args.input)
    print(json.dumps({
        "sample_rate": t.sample_rate, "channels": t.channels,
        "version": {3: "MPEG-1", 2: "MPEG-2", 0: "MPEG-2.5"}.get(
            t.source.version, "?"),
        "frames": int(t.index.n_frames),
        "duration_s": round(t.seek_table.duration, 3),
        "vbr_tag": t.stream_info.kind,
        "gapless": t.stream_info.gapless,
        "encoder_delay": t.stream_info.encoder_delay,
        "encoder_padding": t.stream_info.encoder_padding,
        "id3": t.id3.frames, "id3v1": t.id3v1,
        "decode_errors": int((t.source.whole().errors != 0).sum()),
    }, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mp3tpu-torch",
        description="MP3 decode and playback in PyTorch on an NVIDIA GPU")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions); also accepted after the "
                         "subcommand's arguments")
    # --device after the subcommand: set only when given there, so that
    # the main parser's value (or default) stands otherwise
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=argparse.SUPPRESS,
                        help="torch device (default cuda)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def command(name, fn, **kw):
        sp = sub.add_parser(name, parents=[common], **kw)
        sp.set_defaults(fn=fn)
        return sp

    d = command("decode", _cmd_decode, help="decode MP3 to WAV")
    d.add_argument("input")
    d.add_argument("-o", "--output")
    d.add_argument("--no-gapless", action="store_true")

    p = command("play", _cmd_play, help="headless play/seek/loop to a sink; "
                                        "several inputs = gapless queue")
    p.add_argument("input", nargs="+")
    p.add_argument("-o", "--output", help="WAV sink path")
    p.add_argument("--seek", type=float, default=0.0)
    p.add_argument("--loop", help="A:B seconds segment")
    p.add_argument("--times", type=int, default=1)
    p.add_argument("--gain", type=float, default=0.0)
    p.add_argument("--eq", help="10 comma-separated band gains (dB)")
    p.add_argument("--speed", type=float, default=1.0,
                   help="pitch-preserving tempo, 0.25-4.0 (slow listening)")
    p.add_argument("--normalize", action="store_true",
                   help="loudness-match queue tracks (device envelope "
                        "scan per track; clipping-safe)")
    p.add_argument("--segments", action="store_true",
                   help="print detected sentence boundaries (JSON) and exit")
    p.add_argument("--segment", type=int,
                   help="replay sentence N (see --segments) --times times")

    i = command("info", _cmd_info, help="stream/tag info as JSON")
    i.add_argument("input")

    pr = command("practice", _cmd_practice,
                 help="sentence-repeat practice: each detected "
                      "sentence, --times times at --speed, with --gap s of "
                      "shadowing silence")
    pr.add_argument("input")
    pr.add_argument("-o", "--output", help="WAV sink path")
    pr.add_argument("--times", type=int, default=3,
                    help="repetitions per sentence (default 3)")
    pr.add_argument("--speed", type=float, default=1.0,
                    help="pitch-preserving tempo, 0.25-4.0")
    pr.add_argument("--gap", type=float, default=0.0,
                    help="seconds of silence after each repetition")
    pr.add_argument("--start", type=int, default=0,
                    help="first sentence index (from `segments`)")
    pr.add_argument("--stop", type=int, default=None,
                    help="one past the last sentence index")
    pr.add_argument("--gain", type=float, default=0.0)

    s = command("segments", _cmd_segments,
                help="sentence boundaries per file (device-side envelope, "
                     "no PCM download) as JSON")
    s.add_argument("input", nargs="+")

    e = command("encode", _cmd_encode, help="encode WAV to MP3")
    e.add_argument("input")
    e.add_argument("-o", "--output")
    e.add_argument("-b", "--bitrate", type=int, default=None,
                   help="CBR kbps (default: active config, 128)")
    e.add_argument("--vbr-quality", type=int, default=None,
                   help="constant-quality VBR, 0 (best) .. 9 (smallest)")

    tc = command("transcode", _cmd_transcode,
                 help="batched MP3->MP3 re-encode at a new bitrate; PCM "
                      "stays on the device between decode and encode")
    tc.add_argument("input", nargs="+")
    tc.add_argument("-d", "--out-dir", default=".")
    tc.add_argument("-b", "--bitrate", type=int, default=None,
                    help="target CBR kbps (default: active config, 128)")

    sp = command("split", _cmd_split,
                 help="write each sentence to its own clip file (wav, or mp3 "
                      "via ONE batched re-encode)")
    sp.add_argument("input")
    sp.add_argument("-d", "--out-dir", default=".")
    sp.add_argument("-f", "--format", choices=("wav", "mp3"), default="wav")
    sp.add_argument("-b", "--bitrate", type=int, default=None,
                    help="mp3 clips: CBR kbps (default: active config)")

    lv = command("loudness", _cmd_loudness,
                 help="track loudness/peak + the normalization gain (device "
                      "envelope; no PCM download)")
    lv.add_argument("input", nargs="+")
    lv.add_argument("--target", type=float, default=None,
                    help="target loudness dB (default -14)")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
