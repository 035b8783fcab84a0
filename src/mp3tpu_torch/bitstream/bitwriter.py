"""MSB-first bit writer (encoder side, SURVEY.md E6).

Copy of mp3tpu.bitstream.bitwriter, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""
from __future__ import annotations

import numpy as np


class BitWriter:
    __slots__ = ("bits",)

    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def put_array(self, values, lens):
        """Append many (value, nbits) fields at once, MSB-first each —
        the vectorized equivalent of [put(v, n) for v, n in zip(...)];
        zero-length fields contribute nothing."""
        values = np.asarray(values, np.int64)
        lens = np.asarray(lens, np.int64)
        m = int(lens.max(initial=0))
        if m == 0:
            return
        ks = np.arange(m)
        shift = lens[:, None] - 1 - ks[None]          # [N, m]
        bits = (values[:, None] >> np.maximum(shift, 0)) & 1
        # boolean C-order indexing keeps (field, bit) order
        self.bits.extend(bits[shift >= 0].tolist())

    def put_bits(self, other: "BitWriter"):
        self.bits.extend(other.bits)

    def __len__(self):
        return len(self.bits)

    def to_bytes(self, pad_to: int | None = None) -> bytes:
        out = np.packbits(np.asarray(self.bits, np.uint8)).tobytes()
        if pad_to is not None:
            assert len(out) <= pad_to, f"overflow: {len(out)} > {pad_to}"
            out += b"\x00" * (pad_to - len(out))
        return out
