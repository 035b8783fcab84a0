"""Faults planted under the timed path, to show that the check fails them.

Each is a context manager that breaks the program in one way while it is
open, and puts it back after:

- stale: every call returns the previous call's outputs (a step that
  returns its state unchanged);
- half: only the first half of a batch is done, the rest comes back empty;
- altered: an answer is altered where it is produced (one PCM sample of
  every stream moved by 64 LSB; every MP3's middle frame's main data
  flipped);
- window_state (decode entries): the decoder's window step hands its state
  on unchanged, so no overlap-add or synthesis history crosses a window.

calibrate.py reads the numbers they give on the card; the CPU tests drive
a whole run with each one planted and see `correct` come out false.
"""
from __future__ import annotations

import contextlib

import numpy as np

ENTRY_ATTR = {"decode_files": "decode_batch", "encode_batch": "encode_batch",
              "transcode_batch": "transcode_batch"}
FAULTS = ("stale", "half", "altered", "window_state")


def applies(fault: str, entry: str) -> bool:
    return fault != "window_state" or entry in ("decode_files",
                                                "transcode_batch")


def _flip_frame(data: bytes) -> bytes:
    """data with every main-data byte of its middle frame flipped: a frame
    altered where it is produced. (One flipped byte of Huffman data is
    not enough: the count1 region takes up whatever bits are left, so the
    granule still ends on its budget, and its noise hides in a lossy
    stream's.)"""
    from .reference.container.frames import scan_frames
    index = scan_frames(np.frombuffer(data, np.uint8))
    mid = index.n_frames // 2
    h = index.headers[mid]
    off = int(index.offsets[mid])
    m0 = off + 4 + (2 if h.crc_protected else 0) + h.side_info_bytes
    b = bytearray(data)
    b[m0: off + h.frame_bytes] = bytes(x ^ 0xFF for x in b[m0: off + h.frame_bytes])
    return bytes(b)


def _alter(out):
    if isinstance(out, (bytes, bytearray)):
        return _flip_frame(out)
    pcm, rate = out
    pcm = pcm.copy()
    v = int(pcm[len(pcm) // 2, 0])
    pcm[len(pcm) // 2, 0] = v + 64 if v < 0 else v - 64
    return pcm, rate


def _empty(out):
    if isinstance(out, (bytes, bytearray)):
        return b""
    return None


@contextlib.contextmanager
def plant(fault: str, entry: str):
    import mp3tpu_torch as m
    if fault == "window_state":
        from mp3tpu_torch.kernels import pipeline as kp
        orig = kp._packed_step

        def step(dec, plane_bits, *rest):
            pcm, _new = orig(dec, plane_bits, *rest)
            return pcm, rest[-1]
        kp._packed_step = step
        try:
            yield
        finally:
            kp._packed_step = orig
        return
    attr = ENTRY_ATTR[entry]
    orig = getattr(m, attr)
    last = []

    def broken(inputs, *a, **kw):
        inputs = list(inputs)
        if fault == "half":
            n = len(inputs) // 2
            out = list(orig(inputs[:n], *a, **kw))
            return out + [_empty(o) for o in out[: len(inputs) - n]]
        out = list(orig(inputs, *a, **kw))
        if fault == "altered":
            return [_alter(o) for o in out]
        if fault == "stale":
            prev = last[0] if last else out[::-1]
            last[:] = [out]
            return prev
        raise ValueError(f"unknown fault {fault!r}")
    setattr(m, attr, broken)
    try:
        yield
    finally:
        setattr(m, attr, orig)
