"""The card's peaks and the bytes and operations of the port's kernels.

Peaks: NVIDIA's data sheet for one H100 SXM at its full 700 W, dense rates:
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores (both
kernels run on the CUDA cores). A kernel's least time is the larger of its
bytes over the first and its operations over the second; its roofline
share is that least time over its measured time.

Bytes count each input read once and each output written once, at the
types the launch takes (the symbols' types are the template arguments in
the kernel's name). These are the formulas of the program's own kernel
checks (kernels/selfcheck.py: traffic, synth_traffic), copied here so that
the yardstick stays where the program cannot move it.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

_CTYPES = {"int": 4, "unsigned int": 4, "short": 2, "unsigned short": 2,
           "signed char": 1, "unsigned char": 1, "char": 1, "long": 8}
FUSED_Z = re.compile(r"fused_z_kernel<\s*([\w ]+?)\s*,\s*([\w ]+?)\s*,"
                     r"\s*(true|false)\s*>")


def fused_z_per_pair(name: str):
    """(bytes, float32 operations) of one granule pair (both channels) of
    a launch of csrc/fused_z.cu named `name`, or None for another kernel.
    In: the spectrum [2, 576] and exponents [2, 64] at the template's types,
    block types and mixed flags (a byte each, both channels) and 64 stereo
    palette indices; out: z [2, 32, 36] (C1-C5) or [2, 576] (C1-C4) float32.
    Operations: C1's scale and C2's mixing (8 a line), the alias
    butterflies at their most (31 boundaries a channel, 3 multiply-adds of
    16 lines each), and C5's 18-term IMDCT of 36 outputs a subband; the
    bytes bound these kernels at 3x the operations."""
    m = FUSED_Z.search(name)
    if m is None:
        return None
    ti, te = _CTYPES[m.group(1)], _CTYPES[m.group(2)]
    c1_c4 = m.group(3) == "true"
    n_in = 2 * 576 * ti + 2 * 64 * te + 2 + 2 + 64
    n_out = 2 * (576 if c1_c4 else 32 * 36) * 4
    ops = 576 * 8 + 16 * 3 * 62 + (0 if c1_c4 else 2 * 32 * 36 * 18 * 2)
    return n_in + n_out, ops


def synth_per_launch(S: int, G: int):
    """(bytes, float32 operations) of one launch of csrc/synth.cu on S
    streams of G granules: z [S, G, 2, 32, 36] in, the state (overlap
    [S, 2, 32, 18] and history [S, 2, 15, 32]) in and out, its tables (the
    inversion mask, 32 rows of the matrixing, the 512-tap window) in, PCM
    [S, G*576, 2] float32 out; 48 multiply-adds a sample and the
    overlap-add's add and multiply."""
    state = S * 2 * (32 * 18 + 15 * 32) * 4
    n = (S * G * 2 * 32 * 36 * 4 + 2 * state + (32 * 18 + 32 * 32 + 512) * 4
         + S * 2 * G * 576 * 4)
    return n, S * 2 * G * 576 * (48 * 2 + 2)


def least_seconds(n_bytes: float, ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
