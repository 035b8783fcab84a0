"""Frame sync scanning and header parsing (SURVEY.md A1-A3).

Implements ISO/IEC 11172-3 §2.4.1.3 (header syntax) plus the LSF
extension (MPEG-2, ISO 13818-3) and the de-facto MPEG-2.5 variant.

Frozen copy of mp3tpu_torch.container.frames for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# version code (header bits 19-20): 0=MPEG2.5, 1=reserved, 2=MPEG2, 3=MPEG1
VERSION_MPEG1 = 3
VERSION_MPEG2 = 2
VERSION_MPEG25 = 0

# Layer III bitrates (kbps), index 1..14; 0 = free format (unsupported)
BITRATES_V1_L3 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320)
BITRATES_V2_L3 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)

SAMPLE_RATES = {
    VERSION_MPEG1: (44100, 48000, 32000),
    VERSION_MPEG2: (22050, 24000, 16000),
    VERSION_MPEG25: (11025, 12000, 8000),
}

MODE_STEREO, MODE_JOINT, MODE_DUAL, MODE_MONO = 0, 1, 2, 3


@dataclass(frozen=True)
class FrameHeader:
    version: int          # VERSION_* code
    layer: int            # 1, 2, or 3
    crc_protected: bool
    bitrate: int          # bits/s
    sample_rate: int
    padding: int
    mode: int             # MODE_*
    mode_ext: int         # bit1: MS stereo on, bit0: intensity on (layer III)
    frame_bytes: int      # total frame length incl. header
    samples: int          # PCM samples per channel in this frame

    @property
    def channels(self) -> int:
        return 1 if self.mode == MODE_MONO else 2

    @property
    def lsf(self) -> bool:
        return self.version != VERSION_MPEG1

    @property
    def n_granules(self) -> int:
        return 1 if self.lsf else 2

    @property
    def ms_stereo(self) -> bool:
        return self.mode == MODE_JOINT and bool(self.mode_ext & 2)

    @property
    def intensity_stereo(self) -> bool:
        return self.mode == MODE_JOINT and bool(self.mode_ext & 1)

    @property
    def side_info_bytes(self) -> int:
        if self.lsf:
            return 9 if self.channels == 1 else 17
        return 17 if self.channels == 1 else 32


def parse_header(word: int) -> FrameHeader | None:
    """Parse a 32-bit big-endian header word; None if invalid/unsupported."""
    if (word >> 21) & 0x7FF != 0x7FF:
        return None
    version = (word >> 19) & 3
    if version == 1:
        return None
    layer_code = (word >> 17) & 3
    if layer_code == 0:
        return None
    layer = 4 - layer_code
    if layer != 3:
        return None  # mp3tpu decodes Layer III only (SURVEY.md §7.6)
    bitrate_idx = (word >> 12) & 0xF
    if bitrate_idx in (0, 15):
        return None  # free format unsupported / invalid
    sr_idx = (word >> 10) & 3
    if sr_idx == 3:
        return None
    padding = (word >> 9) & 1
    mode = (word >> 6) & 3
    mode_ext = (word >> 4) & 3
    crc_protected = ((word >> 16) & 1) == 0

    lsf = version != VERSION_MPEG1
    bitrate = (BITRATES_V2_L3 if lsf else BITRATES_V1_L3)[bitrate_idx] * 1000
    sample_rate = SAMPLE_RATES[version][sr_idx]
    samples = 576 if lsf else 1152
    frame_bytes = (samples // 8) * bitrate // sample_rate + padding
    return FrameHeader(
        version=version, layer=layer, crc_protected=crc_protected,
        bitrate=bitrate, sample_rate=sample_rate, padding=padding,
        mode=mode, mode_ext=mode_ext, frame_bytes=frame_bytes, samples=samples)


@dataclass
class FrameIndex:
    """Result of scanning a whole file (offsets exclude ID3 regions)."""
    offsets: np.ndarray       # int64 [n_frames] byte offset of each frame
    headers: list             # FrameHeader per frame
    junk_bytes: int           # bytes skipped during resync
    sample_rate: int
    channels: int
    version: int
    resyncs: int = 0          # mid-stream lost-sync events (junk runs
    #                           after the first accepted frame — §5.3)

    @property
    def n_frames(self) -> int:
        return len(self.offsets)

    @property
    def total_samples(self) -> int:
        return sum(h.samples for h in self.headers)


def scan_frames(data: bytes | np.ndarray, start: int = 0, end: int | None = None) -> FrameIndex:
    """Walk the byte stream frame-by-frame, resyncing over garbage (A1).

    A candidate header is accepted only if the frame it describes is
    followed by another valid syncword (or end-of-data), which makes
    resync robust against 0xFFF byte patterns inside main data.
    """
    buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    end = len(buf) if end is None else end
    offsets: list[int] = []
    headers: list[FrameHeader] = []
    junk = 0
    resyncs = 0
    pending_resync = False
    pos = start
    while pos + 4 <= end:
        word = (int(buf[pos]) << 24) | (int(buf[pos + 1]) << 16) | \
               (int(buf[pos + 2]) << 8) | int(buf[pos + 3])
        h = parse_header(word)
        ok = False
        if h is not None and pos + h.frame_bytes <= end + 4:
            nxt = pos + h.frame_bytes
            if nxt + 4 > end:
                ok = True  # last (possibly truncated) frame
            else:
                w2 = (int(buf[nxt]) << 24) | (int(buf[nxt + 1]) << 16) | \
                     (int(buf[nxt + 2]) << 8) | int(buf[nxt + 3])
                h2 = parse_header(w2)
                ok = h2 is not None and h2.version == h.version \
                    and h2.sample_rate == h.sample_rate and h2.layer == h.layer
        if ok:
            if pos + h.frame_bytes > end:
                break  # truncated final frame: drop it
            offsets.append(pos)
            headers.append(h)
            pos += h.frame_bytes
            if pending_resync:  # sync recovered after mid-stream junk
                resyncs += 1
                pending_resync = False
        else:
            # a resync EVENT is a junk run BETWEEN accepted frames:
            # leading garbage (tag remnants) and trailing bytes (ID3v1)
            # are container slack, not mid-stream sync loss — so the
            # event commits only when a later frame is accepted
            pending_resync = bool(headers)
            pos += 1
            junk += 1
    if not headers:
        raise ValueError("no MPEG audio frames found")
    h0 = headers[0]
    return FrameIndex(
        offsets=np.asarray(offsets, np.int64), headers=headers,
        junk_bytes=junk, sample_rate=h0.sample_rate,
        channels=h0.channels, version=h0.version, resyncs=resyncs)


def check_crc16(buf: np.ndarray, frame_off: int, h: FrameHeader) -> bool:
    """16-bit CRC over header bytes 2-3 + side info [ISO 11172-3 §2.4.3.1].

    Polynomial x^16 + x^15 + x^2 + 1, init 0xFFFF. Returns True if OK
    (or frame not protected).
    """
    if not h.crc_protected:
        return True
    stored = (int(buf[frame_off + 4]) << 8) | int(buf[frame_off + 5])
    crc = 0xFFFF
    span = bytes(buf[frame_off + 2: frame_off + 4]) + \
        bytes(buf[frame_off + 6: frame_off + 6 + h.side_info_bytes])
    for byte in span:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc == stored
