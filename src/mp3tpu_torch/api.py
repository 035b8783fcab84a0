"""Public API of the PyTorch port: the decode, playback and analysis entry
points of mp3tpu.api.

Each takes `device` ("cuda" by default; "cpu" runs the plain versions of the
kernels) and otherwise the arguments of its mp3tpu counterpart.
"""
from __future__ import annotations


def decode(path_or_bytes, device="cuda", **kw):
    """One file -> (pcm [n, ch], sample_rate); output="int16" (default) or
    "float32", gapless=True trims by the LAME tag."""
    from .pipeline import decode_file
    return decode_file(path_or_bytes, device=device, **kw)


def decode_batch(paths, device="cuda", **kw):
    """Many files, batched on the device -> [(pcm int16 [n, ch],
    sample_rate), ...] aligned with the inputs."""
    from .pipeline import decode_files
    return decode_files(paths, device=device, **kw)


def segment(path_or_bytes, device="cuda", **kw):
    """Sentence/pause boundaries [(start_s, end_s), ...] of one file, from
    an envelope reduced on the device."""
    from .pipeline import segment_file
    return segment_file(path_or_bytes, device=device, **kw)


def loudness(path_or_bytes, device="cuda") -> float:
    """Track loudness in dB (ReplayGain-style statistic) from the device
    envelope."""
    from .pipeline import loudness_file
    return loudness_file(path_or_bytes, device=device)


def levels(path_or_bytes, device="cuda") -> tuple:
    """(loudness_db, peak_db) from one device envelope scan: what a
    normalizing queue measures per track."""
    from .pipeline import track_levels
    return track_levels(path_or_bytes, device=device)


def play(path_or_bytes, sink=None, device="cuda", **kw):
    """Open a playback session: a Player with play/seek/loop/stop/snapshot,
    decoding to `sink` (default: an in-memory CollectSink)."""
    from .player import Player
    return Player(path_or_bytes, sink=sink, device=device, **kw)
