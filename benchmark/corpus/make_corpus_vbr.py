"""Make the frozen corpus of a VBR configuration: 8 clips of 10 s.

    PYTHONPATH=src:benchmark python benchmark/corpus/make_corpus_vbr.py [config ...]

The VBR counterpart of make_corpus.py (default config: vbr_v2). Each clip
is one kind of mp3bench.signals from a fixed seed, encoded by the
program's host encoder (mp3tpu_torch.encoder.encode_pcm on the CPU, the
float64 path) in constant-quality VBR at the configuration's
format.vbr_quality: every frame takes the smallest bitrate that holds it,
and the first frame is a Xing (not Info) frame with a byte TOC and the
LAME tag. The manifest records, beside make_corpus.py's fields, each
clip's mean bitrate over its audio frames and its count of distinct frame
bitrates, and the corpus's mean bitrate. Every clip's first audio frame
must have main_data_begin 0, as mp3bench/compose.py requires; the script
refuses a clip that does not. It runs once, when the corpus is made, and
never on the chip.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SECONDS = 10.0
SEED = 1000


def frame_stats(data: bytes) -> dict:
    """Mean bitrate (kbps) and distinct bitrates of a stream's audio
    frames, the Xing frame left out; checks main_data_begin 0 first."""
    from mp3bench.reference.bitstream.bits import BitReader
    from mp3bench.reference.container import frames as fr
    from mp3bench.reference.container.xing import parse_stream_info
    buf = np.frombuffer(data, np.uint8)
    index = fr.scan_frames(buf)
    info = parse_stream_info(data, int(index.offsets[0]), index.headers[0])
    if info.kind != "xing" or not info.gapless:
        raise ValueError(f"no Xing/LAME frame first (kind {info.kind!r})")
    h = index.headers[1]
    si = int(index.offsets[1]) + 4 + (2 if h.crc_protected else 0)
    if BitReader(buf[si: si + 2]).read(9) != 0:
        raise ValueError("the first audio frame borrows reservoir")
    audio = index.headers[1:]
    rates = [a.bitrate // 1000 for a in audio]
    n_bytes = len(data) - int(index.offsets[1])
    seconds = len(audio) * 1152 / index.sample_rate
    return {"frames": len(audio), "audio_bytes": n_bytes,
            "mean_kbps": round(8 * n_bytes / seconds / 1000, 3),
            "distinct_bitrates": len(set(rates)),
            "bitrates_kbps": sorted(set(rates))}


def main(names) -> None:
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.dirname(HERE)]
    from mp3bench import signals
    from mp3tpu_torch.encoder import encode_pcm
    for name in names:
        with open(os.path.join(os.path.dirname(HERE), "configs",
                               f"{name}.json")) as f:
            fmt = json.load(f)["format"]
        out = os.path.join(HERE, name)
        os.makedirs(out, exist_ok=True)
        clips = []
        for i, kind in enumerate(signals.KINDS):
            pcm = signals.make(kind, SECONDS, SEED + i, fmt["sample_rate"])
            data = encode_pcm(pcm, fmt["sample_rate"],
                              vbr_quality=fmt["vbr_quality"],
                              joint_stereo=fmt["mode"] == "joint_stereo",
                              device="cpu")
            stats = frame_stats(data)
            with open(os.path.join(out, f"{kind}.mp3"), "wb") as f:
                f.write(data)
            clips.append({"file": f"{kind}.mp3", "kind": kind,
                          "seed": SEED + i, "samples": len(pcm),
                          "bytes": len(data),
                          "sha256": hashlib.sha256(data).hexdigest(),
                          **stats})
            print(name, kind, len(data), stats["mean_kbps"],
                  stats["distinct_bitrates"], flush=True)
        audio_bytes = sum(c["audio_bytes"] for c in clips)
        seconds = sum(c["frames"] for c in clips) * 1152 / fmt["sample_rate"]
        manifest = {"made_by": "benchmark/corpus/make_corpus_vbr.py",
                    "encoder": "mp3tpu_torch.encoder.encode_pcm, device=cpu",
                    "seconds": SECONDS, "sample_rate": fmt["sample_rate"],
                    "vbr_quality": fmt["vbr_quality"], "mode": fmt["mode"],
                    "mean_kbps": round(8 * audio_bytes / seconds / 1000, 3),
                    "clips": clips}
        with open(os.path.join(out, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:] or ["vbr_v2"])
