"""ID3v2 / ID3v1 tag parsing (SURVEY.md A4; de-facto standard, id3.org).

Frozen copy of mp3tpu_torch.container.id3 for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Id3Info:
    version: str = ""
    size: int = 0                      # bytes to skip at file start
    frames: dict = field(default_factory=dict)   # frame id -> decoded text
    v1: dict = field(default_factory=dict)       # ID3v1 trailer fields


def _syncsafe(b: bytes) -> int:
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


def _decode_text(data: bytes) -> str:
    if not data:
        return ""
    enc, body = data[0], data[1:]
    try:
        if enc == 0:
            return body.decode("latin-1").rstrip("\x00")
        if enc == 1:
            return body.decode("utf-16").rstrip("\x00")
        if enc == 2:
            return body.decode("utf-16-be").rstrip("\x00")
        return body.decode("utf-8").rstrip("\x00")
    except UnicodeDecodeError:
        return body.decode("latin-1", "replace").rstrip("\x00")


TEXT_FRAMES = {"TIT2", "TPE1", "TALB", "TDRC", "TYER", "TRCK", "TCON", "TPE2",
               "TCOM", "TPOS", "TSSE"}


def parse_id3v2(data: bytes) -> Id3Info:
    """Parse an ID3v2 header at the start of `data` (empty Info if none)."""
    info = Id3Info()
    if len(data) < 10 or data[:3] != b"ID3":
        return info
    major, _rev, flags = data[3], data[4], data[5]
    body_size = _syncsafe(data[6:10])
    info.version = f"2.{major}"
    info.size = 10 + body_size + (10 if flags & 0x10 else 0)  # footer flag
    pos = 10
    if flags & 0x40:  # extended header
        if major == 4:
            pos += _syncsafe(data[pos:pos + 4])
        else:
            pos += 4 + int.from_bytes(data[pos:pos + 4], "big")
    end = min(10 + body_size, len(data))
    while pos + 10 <= end:
        fid = data[pos:pos + 4]
        if fid == b"\x00\x00\x00\x00":
            break
        if major == 4:
            fsize = _syncsafe(data[pos + 4:pos + 8])
        elif major == 3:
            fsize = int.from_bytes(data[pos + 4:pos + 8], "big")
        else:  # v2.2: 3-byte ids/sizes
            fid = data[pos:pos + 3] + b" "
            fsize = int.from_bytes(data[pos + 3:pos + 6], "big")
            body = data[pos + 6:pos + 6 + fsize]
            if fid[:3].decode("latin-1", "replace").startswith("T"):
                info.frames[fid.decode("latin-1").strip()] = _decode_text(body)
            pos += 6 + fsize
            continue
        body = data[pos + 10:pos + 10 + fsize]
        name = fid.decode("latin-1", "replace")
        if name in TEXT_FRAMES:
            info.frames[name] = _decode_text(body)
        pos += 10 + fsize
    return info


def parse_id3v1(data: bytes) -> dict:
    """128-byte ID3v1 trailer, if present."""
    if len(data) < 128 or data[-128:-125] != b"TAG":
        return {}
    t = data[-128:]
    f = lambda a, b: t[a:b].decode("latin-1", "replace").rstrip("\x00 ").strip()
    out = {"title": f(3, 33), "artist": f(33, 63), "album": f(63, 93),
           "year": f(93, 97), "comment": f(97, 125)}
    if t[125] == 0 and t[126] != 0:
        out["track"] = t[126]
    out["genre"] = t[127]
    return out
