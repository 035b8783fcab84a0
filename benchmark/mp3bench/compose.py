"""The frozen corpus and the streams composed from it by the seed.

A configuration's corpus (benchmark/corpus/<config>/, made once by
corpus/make_corpus.py) holds 8 clips of 10 s. A composed stream joins
`parts` clips at frame boundaries: the first clip's Xing/LAME frame, its
frame and byte counts rewritten for the whole stream and its padding taken
from the last part, then every part's audio frames. Each part's first audio
frame has main_data_begin 0 (its reservoir is empty), so every composed
stream is valid, and the gapless trim drops the first part's delay and the
last part's padding. Every batch uses each clip equally often, so the audio
and the bits of a call do not depend on the seed: the seed picks the
order.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np

from .reference.bitstream.bits import BitReader
from .reference.container import frames as fr
from .reference.container.xing import is_metadata_frame, parse_stream_info
from .spec import load_json


@dataclass
class Clip:
    name: str
    tag: bytes          # the Xing/LAME frame
    audio: bytes        # the audio frames
    n_audio_frames: int
    delay: int
    padding: int
    samples: int        # of the source PCM
    sample_rate: int


def rng(seed: int, *salt) -> np.random.Generator:
    """The generator of one use of the seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


def load_clip(name: str, data: bytes, samples: int) -> Clip:
    buf = np.frombuffer(data, np.uint8)
    index = fr.scan_frames(buf)
    info = parse_stream_info(data, int(index.offsets[0]), index.headers[0])
    if not (is_metadata_frame(info) and info.gapless):
        raise ValueError(f"{name}: no Xing/LAME frame first")
    h = index.headers[1]
    si = int(index.offsets[1]) + 4 + (2 if h.crc_protected else 0)
    if BitReader(buf[si: si + 2]).read(9) != 0:
        raise ValueError(f"{name}: the first audio frame borrows reservoir")
    a = int(index.offsets[1])
    return Clip(name=name, tag=data[:a], audio=data[a:],
                n_audio_frames=index.n_frames - 1, delay=info.encoder_delay,
                padding=info.encoder_padding, samples=samples,
                sample_rate=index.sample_rate)


def load_corpus(config: dict, root: str) -> list:
    """The clips of a configuration, checked against their manifest."""
    d = os.path.join(root, config["corpus"])
    man = load_json(os.path.join(d, "manifest.json"))
    clips = []
    for c in man["clips"]:
        with open(os.path.join(d, c["file"]), "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != c["sha256"]:
            raise ValueError(f"{c['file']}: not the clip of the manifest")
        clips.append(load_clip(c["file"], data, c["samples"]))
    return clips


def _xing_at(tag: bytes) -> int:
    h = fr.parse_header(int.from_bytes(tag[:4], "big"))
    return 4 + (2 if h.crc_protected else 0) + h.side_info_bytes


def compose(parts: list) -> bytes:
    """One stream of the clips `parts`, joined at frame boundaries."""
    first, last = parts[0], parts[-1]
    body = b"".join(p.audio for p in parts)
    tag = bytearray(first.tag)
    x = _xing_at(tag)
    flags = int.from_bytes(tag[x + 4: x + 8], "big")
    pos = x + 8
    if flags & 1:
        tag[pos: pos + 4] = sum(p.n_audio_frames for p in parts).to_bytes(4, "big")
        pos += 4
    if flags & 2:
        tag[pos: pos + 4] = (len(tag) + len(body)).to_bytes(4, "big")
        pos += 4
    pos += (100 if flags & 4 else 0) + (4 if flags & 8 else 0)
    v = (first.delay << 12) | last.padding
    tag[pos + 21: pos + 24] = bytes(((v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))
    return bytes(tag) + body


def plan(n_streams: int, parts: int, n_clips: int, gen) -> list:
    """[n_streams][parts] clip indices, each clip equally often, in an order
    from `gen`."""
    slots = n_streams * parts
    if slots % n_clips:
        raise ValueError(f"{n_streams} streams of {parts} parts do not use "
                         f"{n_clips} clips equally often")
    order = gen.permutation(np.repeat(np.arange(n_clips), slots // n_clips))
    return order.reshape(n_streams, parts).tolist()
