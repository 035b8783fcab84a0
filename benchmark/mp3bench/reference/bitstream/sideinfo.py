"""Side information parsing (SURVEY.md B1) — ISO 11172-3 §2.4.1.7 and the
LSF layout of ISO 13818-3 §2.4.1.7.

Frozen copy of mp3tpu_torch.bitstream.sideinfo for the benchmark's plain
reference: it imports nothing of the program, and a change to the program
does not move it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .bits import BitReader
from ..container.frames import FrameHeader


@dataclass
class GranuleSI:
    part2_3_length: int = 0
    big_values: int = 0
    global_gain: int = 0
    scalefac_compress: int = 0
    window_switching: int = 0
    block_type: int = 0
    mixed_block_flag: int = 0
    table_select: tuple = (0, 0, 0)
    subblock_gain: tuple = (0, 0, 0)
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scalefac_scale: int = 0
    count1table_select: int = 0


@dataclass
class SideInfo:
    main_data_begin: int = 0
    scfsi: list = field(default_factory=list)       # [ch][4]
    granules: list = field(default_factory=list)    # [gr][ch] -> GranuleSI


def parse_side_info(r: BitReader, h: FrameHeader) -> SideInfo:
    si = SideInfo()
    nch = h.channels
    if h.lsf:
        si.main_data_begin = r.read(8)
        r.skip(nch)  # private bits: 1 (mono) / 2 (stereo)
        si.scfsi = [[0, 0, 0, 0] for _ in range(nch)]
    else:
        si.main_data_begin = r.read(9)
        r.skip(5 if nch == 1 else 3)
        si.scfsi = [[r.read1() for _ in range(4)] for _ in range(nch)]
    for _gr in range(h.n_granules):
        chs = []
        for _ch in range(nch):
            g = GranuleSI()
            g.part2_3_length = r.read(12)
            g.big_values = r.read(9)
            g.global_gain = r.read(8)
            g.scalefac_compress = r.read(9 if h.lsf else 4)
            g.window_switching = r.read1()
            if g.window_switching:
                g.block_type = r.read(2)
                g.mixed_block_flag = r.read1()
                g.table_select = (r.read(5), r.read(5), 0)
                g.subblock_gain = (r.read(3), r.read(3), r.read(3))
                # implicit region split [§2.4.2.7]: region0 covers 36 lines
                # (8 bands short / per convention), region1 the rest
                g.region0_count = 8 if (g.block_type == 2 and not g.mixed_block_flag) else 7
                g.region1_count = 20 - g.region0_count
            else:
                g.block_type = 0
                g.table_select = (r.read(5), r.read(5), r.read(5))
                g.region0_count = r.read(4)
                g.region1_count = r.read(3)
            if h.lsf:
                g.preflag = 0  # derived from scalefac_compress branch for LSF
            else:
                g.preflag = r.read1()
            g.scalefac_scale = r.read1()
            g.count1table_select = r.read1()
            chs.append(g)
        si.granules.append(chs)
    return si
