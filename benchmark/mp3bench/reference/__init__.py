"""The benchmark's plain reference: a Layer III decoder in NumPy and plain
torch (frozen copies of the container parse and the Python unpacker, and
the granule chain in dsp.py) and the audit of an encoded stream
(audit.py). It imports nothing of the program under test."""
from __future__ import annotations

import numpy as np

from . import dsp
from .bitstream.unpack import unpack
from .container import frames as fr
from .container.id3 import parse_id3v2
from .container.xing import is_metadata_frame, parse_stream_info


def load(data: bytes):
    """(SymbolTensors of the audio frames, StreamInfo): the whole stream
    unpacked, less a leading Xing/Info/VBRI frame's granules."""
    id3 = parse_id3v2(data)
    index = fr.scan_frames(np.frombuffer(data, np.uint8), start=id3.size)
    info = parse_stream_info(data, int(index.offsets[0]), index.headers[0])
    st = unpack(data, index)
    if is_metadata_frame(info):
        st = st.slice_granules(index.headers[0].n_granules, st.n_granules)
    return st, info


def decode(data: bytes, precision: str = "float64", device="cpu"):
    """(int16 PCM [n, channels], sample rate) of one stream, computed in
    `precision` (dsp.PRECISIONS), trimmed by its LAME tag."""
    st, info = load(data)
    return pcm(st, info, precision, device), st.sample_rate


def pcm(st, info, precision: str = "float64", device="cpu"):
    """int16 PCM [n, channels] of unpacked symbols (load(), audit()),
    trimmed by the LAME tag where the stream has one."""
    out = dsp.to_int16(dsp.granule_chain(st, precision, device))
    if info.gapless:
        lo, hi = dsp.gapless_bounds(len(out), info.encoder_delay,
                                    info.encoder_padding)
        out = out[lo:hi]
    return out
