"""Make the benchmark's frozen corpus: 8 clips of 10 s per configuration.

    PYTHONPATH=src:benchmark python benchmark/corpus/make_corpus.py [config ...]

Each clip is one kind of mp3bench.signals (a sweep, tones, transients,
noise, ...) from a fixed seed, encoded by the program's host encoder
(mp3tpu_torch.encoder.encode_pcm on the CPU: the float64 path, byte for
byte the JAX package's) at the configuration's bitrate. The clips and a
manifest.json with their kinds, seeds, lengths and SHA-256 sums go into
benchmark/corpus/<config>/. The benchmark's command only reads them: this
script runs once, when the corpus is made, and never on the chip.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SECONDS = 10.0
SEED = 1000


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
                              bitrate=fmt["bitrate_kbps"],
                              joint_stereo=fmt["mode"] == "joint_stereo",
                              device="cpu")
            with open(os.path.join(out, f"{kind}.mp3"), "wb") as f:
                f.write(data)
            clips.append({"file": f"{kind}.mp3", "kind": kind,
                          "seed": SEED + i, "samples": len(pcm),
                          "bytes": len(data),
                          "sha256": hashlib.sha256(data).hexdigest()})
            print(name, kind, len(data), flush=True)
        manifest = {"made_by": "benchmark/corpus/make_corpus.py",
                    "encoder": "mp3tpu_torch.encoder.encode_pcm, device=cpu",
                    "seconds": SECONDS, "sample_rate": fmt["sample_rate"],
                    "bitrate_kbps": fmt["bitrate_kbps"], "mode": fmt["mode"],
                    "clips": clips}
        with open(os.path.join(out, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:] or ["cbr128", "cbr320"])
