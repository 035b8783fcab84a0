"""Xing/Info, VBRI and LAME-tag parsing (SURVEY.md A5; de-facto standards).

The first frame of VBR (and most CBR) files carries stream metadata:
total frames/bytes, a 100-point seek TOC, and — in the LAME extension —
the encoder delay/padding needed for gapless playback (SURVEY.md D1).

Frozen copy of mp3tpu_torch.container.xing for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .frames import FrameHeader


@dataclass
class StreamInfo:
    kind: str = ""                 # "xing" | "info" | "vbri" | ""
    n_frames: int | None = None
    n_bytes: int | None = None
    toc: np.ndarray | None = None  # 100 bytes: position permille -> byte
    quality: int | None = None
    encoder: str = ""
    encoder_delay: int = 0         # samples added by encoder at start
    encoder_padding: int = 0       # samples appended at end
    gapless: bool = False          # True if a LAME tag provided delay/padding


def parse_stream_info(data: bytes, frame_off: int, h: FrameHeader) -> StreamInfo:
    """Parse Xing/Info/VBRI (+LAME) from the first frame at frame_off."""
    info = StreamInfo()
    # Xing header sits after the side info
    xing_off = frame_off + 4 + (2 if h.crc_protected else 0) + h.side_info_bytes
    tag = data[xing_off:xing_off + 4]
    if tag in (b"Xing", b"Info"):
        info.kind = "xing" if tag == b"Xing" else "info"
        pos = xing_off + 4
        flags = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4
        if flags & 1:
            info.n_frames = int.from_bytes(data[pos:pos + 4], "big")
            pos += 4
        if flags & 2:
            info.n_bytes = int.from_bytes(data[pos:pos + 4], "big")
            pos += 4
        if flags & 4:
            info.toc = np.frombuffer(data[pos:pos + 100], np.uint8).copy()
            pos += 100
        if flags & 8:
            info.quality = int.from_bytes(data[pos:pos + 4], "big")
            pos += 4
        # LAME extension tag
        enc = data[pos:pos + 9]
        if enc[:4] in (b"LAME", b"Lavc", b"Lavf", b"GOGO"):
            info.encoder = enc.decode("latin-1", "replace").strip()
            # delay/padding: 12+12 bits at offset 21 from tag start
            dp = data[pos + 21:pos + 24]
            if len(dp) == 3:
                v = (dp[0] << 16) | (dp[1] << 8) | dp[2]
                info.encoder_delay = v >> 12
                info.encoder_padding = v & 0xFFF
                info.gapless = True
        return info

    # VBRI: fixed offset 32 bytes after the header
    vbri_off = frame_off + 4 + 32
    if data[vbri_off:vbri_off + 4] == b"VBRI":
        info.kind = "vbri"
        p = vbri_off + 4
        be = lambda a, n: int.from_bytes(data[a:a + n], "big")
        # version(2) delay(2) quality(2) bytes(4) frames(4)
        info.quality = be(p + 4, 2)
        info.n_bytes = be(p + 6, 4)
        info.n_frames = be(p + 10, 4)
        n_ent = be(p + 14, 2)
        scale = be(p + 16, 2)
        esize = be(p + 18, 2)
        eframes = be(p + 20, 2)
        ents = [be(p + 22 + i * esize, esize) * scale for i in range(n_ent)]
        # convert VBRI entry table to a Xing-style byte TOC
        if ents and info.n_bytes:
            cum = np.cumsum([0] + ents[:-1])
            frac = cum / max(cum[-1] + ents[-1], 1)
            toc = np.interp(np.arange(100) / 100.0,
                            np.arange(len(frac)) / max(len(frac) - 1, 1), frac)
            info.toc = (toc * 255).astype(np.uint8)
            del eframes
        return info
    return info


def is_metadata_frame(info: StreamInfo) -> bool:
    """Metadata-only first frames carry no audio and are skipped."""
    return info.kind in ("xing", "vbri", "info")
