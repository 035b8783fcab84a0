"""MSB-first bit reader over numpy byte buffers (SURVEY.md B2).

The pure-Python reader is the mandatory fallback; the C++ fast path
(mp3tpu.native) mirrors its semantics exactly and is tested for equality.

Frozen copy of mp3tpu_torch.bitstream.bits for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

import numpy as np


class BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes | np.ndarray, bitpos: int = 0):
        if isinstance(data, np.ndarray):
            self.data = data.astype(np.uint8, copy=False)
        else:
            self.data = np.frombuffer(data, np.uint8)
        self.pos = bitpos

    def read(self, n: int) -> int:
        """Read n bits MSB-first (n <= 57)."""
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        byte0 = p >> 3
        nbytes = ((p & 7) + n + 7) >> 3
        acc = 0
        d = self.data
        for i in range(byte0, byte0 + nbytes):
            acc = (acc << 8) | int(d[i]) if i < len(d) else (acc << 8)
        drop = (nbytes << 3) - ((p & 7) + n)
        return (acc >> drop) & ((1 << n) - 1)

    def read1(self) -> int:
        p = self.pos
        self.pos = p + 1
        i = p >> 3
        if i >= len(self.data):
            return 0
        return (int(self.data[i]) >> (7 - (p & 7))) & 1

    def skip(self, n: int):
        self.pos += n

    @property
    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos
