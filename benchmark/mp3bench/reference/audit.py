"""What a decoder reads of an encoded stream: its frames and its budgets.

audit() walks every frame of a Layer III stream as ISO/IEC 11172-3 lays it
out (the frozen frame scanner, side-info parser and Python unpacker of this
package) and counts what breaks a guarantee of a CBR encode:

- header_off: audio frames whose version, layer, sample rate, bitrate or
  mode is not the one asked for, and a missing or wrong Xing/LAME frame
  (frame count, byte count, gapless delay and padding);
- budget_off: frames whose main data starts before the stream's first main
  data byte (a reservoir underflow) or runs into the next frame's, or past
  the end of the stream; and granule-channels whose scalefactors and
  Huffman data do not end exactly at their part2_3_length, or that the
  unpacker flags.
"""
from __future__ import annotations

import numpy as np

from .bitstream.bits import BitReader
from .bitstream.sideinfo import parse_side_info
from .bitstream.unpack import unpack
from .container import frames as fr
from .container.xing import is_metadata_frame, parse_stream_info

MODES = {"stereo": fr.MODE_STEREO, "joint_stereo": fr.MODE_JOINT,
         "dual_channel": fr.MODE_DUAL, "mono": fr.MODE_MONO}


def audit(data: bytes, sample_rate: int, bitrate_kbps: int,
          modes=("joint_stereo",)) -> dict:
    """{"frames", "header_off", "budget_off", "st", "info"} of one stream:
    st holds the symbols of its audio frames for pcm(), None where no frame
    was found."""
    buf = np.frombuffer(data, np.uint8)
    try:
        index = fr.scan_frames(buf)
    except ValueError:
        return {"frames": 0, "header_off": 1, "budget_off": 1, "st": None,
                "info": None}
    info = parse_stream_info(data, int(index.offsets[0]), index.headers[0])
    tagged = is_metadata_frame(info)
    first = 1 if tagged else 0
    header_off = 0
    if not (tagged and info.gapless and info.n_bytes == len(data)
            and info.n_frames in (index.n_frames, index.n_frames - 1)):
        header_off += 1
    if int(index.offsets[0]) != 0 or index.junk_bytes or index.resyncs:
        header_off += 1
    want_modes = {MODES[m] for m in modes}
    main_pos, spans = 0, []        # main-data byte stream, in stream order
    budget_off = 0
    for f, (off, h) in enumerate(zip(index.offsets, index.headers)):
        off = int(off)
        if f >= first and (h.version != fr.VERSION_MPEG1 or h.layer != 3
                           or h.sample_rate != sample_rate
                           or h.bitrate != bitrate_kbps * 1000
                           or h.mode not in want_modes):
            header_off += 1
        si_at = off + 4 + (2 if h.crc_protected else 0)
        main_len = off + h.frame_bytes - si_at - h.side_info_bytes
        if f >= first:
            si = parse_side_info(BitReader(buf[si_at: si_at + h.side_info_bytes]), h)
            bits = sum(g.part2_3_length for gr in si.granules for g in gr)
            spans.append((main_pos - si.main_data_begin, bits))
        main_pos += main_len
    first_main = sum(int(index.headers[f].frame_bytes) - 4
                     - (2 if index.headers[f].crc_protected else 0)
                     - index.headers[f].side_info_bytes for f in range(first))
    for i, (start, bits) in enumerate(spans):
        end = spans[i + 1][0] * 8 if i + 1 < len(spans) else main_pos * 8
        if start < first_main or start * 8 + bits > end:
            budget_off += 1
    st = unpack(data, index)
    g0 = first * index.headers[0].n_granules
    errs, slack = st.errors[g0:], st.huff_slack[g0:, :st.channels]
    budget_off += int((errs != 0).sum()) + int((slack != 0).sum())
    return {"frames": index.n_frames - first, "header_off": header_off,
            "budget_off": budget_off, "st": st.slice_granules(g0, st.n_granules),
            "info": info}
