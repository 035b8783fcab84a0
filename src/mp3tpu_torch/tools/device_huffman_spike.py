"""Can the Huffman decode move to the card? Its irreducible part, measured
(counterpart of tools/device_huffman_spike.py).

The bit-serial transition chain alone: for each granule-channel's bits,
walk the code's automaton one bit at a time (kernels/huffman_dfa.py:
dfa_count, the CUDA kernel of csrc/huffman_dfa.cu, one thread a row).
Deliberately left out, as in the JAX tool, and all of it extra cost: the
values, the linbits, placing the lines in the spectrum, the upload of the
main data. The JAX tool's test, applied to the card: if the chain alone is
not decisively faster than the host's whole section for the same streams,
the host's C++ stands.

Cases (bits: random bytes from numpy's default_rng(0), as the JAX tool's):
  default: count1 table A, 131,072 rows x 256 bits, as the JAX tool (256
      streams of 512 granule-channels);
  bench: the bench's shape, 256 x the granule-channels of
      tests/torch_clips/bench_cbr128.mp3, each of that clip's mean
      part2_3_length rounded up to 32 bits, for count1 table A and the
      big-values tables 13 (the most pairs in the bench's clip) and 24 (with
      linbits).
Without --rows and --bits the tool runs the default case and the bench
cases; with them, that one case (of --table).

Each case prints one JSON line: the JAX tool's figures (the first call's
wall with the build, the min of `reps` steady walls, G transitions/s, ms
per stream) and: the kernel's time on the card by CUDA events, its bound
(kernels/huffman_dfa.bound: bytes over 3.35 TB/s against the fewest
shared-memory lookups, ceil(bits / k) a row through the widest k-bit table
that fits an SM, at 32 a cycle per SM at the card's highest SM clock) and
the share of it reached, the same at the kernel's one bit a lookup
("bit_serial_bound_ms", "bit_serial_bound_share"), the plain version's time
on the same inputs
(its counts equal the kernel's, or the tool raises), the card, and the same
machine's host sections per stream (sanitize.profile: csrc/prof_main.cpp's
cycles for Huffman big values and count1 on bench_cbr128.mp3, turned into
ms by that run's own wall over its cycles, an upper bound: the wall holds
the process's start), with the host section over the chain's time per
stream.

    python -m mp3tpu_torch.tools.device_huffman_spike [--rows N --bits L]
        [--table count1a|13|24|...] [--reps 5] [--host-iters 200]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import EXTRA_KEYS, check, cuda_ms, where

# the JAX tool prints text, not JSON: its figures under these names (the
# first call's wall, the first row's count, the steady walls, their min, the
# rate, ms per stream), then this tool's own, then EXTRA_KEYS; the card's
# figures are None on the CPU
JAX_FIELDS = ("compile_run_s", "completed_row0", "walls_ms", "ms_steady",
              "g_transitions_per_s", "ms_per_stream")
KEYS = ("case", "table", "n_states", "rows", "bits", "streams", "completed",
        *JAX_FIELDS, "kernel_ms", "kernel_ms_per_stream", "bound_ms",
        "bound_by", "bound_share", "sm_clock_mhz", "bytes", "table_bits",
        "lookups", "bit_serial_bound_ms", "bit_serial_bound_share", "plain_ms", "host", "host_section_ms_per_stream", "host_over_chain",
        *EXTRA_KEYS)
DEFAULT = ("count1a", 131072, 256, 512)   # table, rows, bits, rows a stream
BENCH_TABLES = ("count1a", 13, 24)
BENCH_STREAMS = 256
SECTION = {"count1a": "huff_count1"}      # else "huff_big_values"


def bench_shape() -> dict:
    """The granule-channels of the bench's CBR clip (its audio frames: not
    the metadata frame) and their mean part2_3_length."""
    from ..bench import fixture
    from ..bitstream.bits import BitReader
    from ..bitstream.sideinfo import parse_side_info
    from ..container import frames as fr
    from ..container.id3 import parse_id3v2
    from ..container.xing import is_metadata_frame, parse_stream_info
    data = fixture("cbr")
    body = data[parse_id3v2(data).size:]
    buf = np.frombuffer(body, np.uint8)
    index = fr.scan_frames(buf)
    first = 1 if is_metadata_frame(parse_stream_info(
        body, int(index.offsets[0]), index.headers[0])) else 0
    lengths = []
    for off, h in zip(index.offsets[first:], index.headers[first:]):
        start = int(off) + 4 + (2 if h.crc_protected else 0)
        si = parse_side_info(BitReader(buf[start:start + h.side_info_bytes]), h)
        lengths += [g.part2_3_length for gr in si.granules for g in gr]
    mean = float(np.mean(lengths))
    return {"granule_channels": len(lengths), "mean_part2_3_length": mean,
            "bits": 32 * int(np.ceil(mean / 32))}


def host_sections(iters: int) -> dict:
    """The unpacker's Huffman sections per stream of bench_cbr128.mp3 on this
    host (sanitize.profile, single-threaded), in cycles and in ms at the
    run's wall over its cycles."""
    from ..sanitize import profile
    rep = profile(iters)
    cyc = {s["name"]: s["cycles"] for s in rep["sections"]}
    s_per_cycle = rep["wall_s"] / rep["total_cycles"]
    out = {"cpu": rep["cpu"], "iters": iters, "wall_s": rep["wall_s"],
           "total_cycles": rep["total_cycles"], "s_per_cycle": s_per_cycle,
           "unpack_ms_per_stream": 1e3 * rep["wall_s"] / iters}
    for name in ("huff_big_values", "huff_count1"):
        out[f"{name}_cycles_per_stream"] = cyc[name] / iters
        out[f"{name}_ms_per_stream"] = 1e3 * cyc[name] / iters * s_per_cycle
    return out


def run_case(case: str, table, rows: int, bits: int, streams: float,
             reps: int, device, host: dict | None, clock_mhz) -> dict:
    """One case's JSON line; raises when the kernel's counts differ from the
    plain version's."""
    from ..bench import timed
    from ..kernels import huffman_dfa as hd
    trans, n_states = hd.automaton(table)
    rng = np.random.default_rng(0)
    row_bytes = -(-bits // 8)
    packed = torch.from_numpy(rng.integers(0, 256, (rows, row_bytes), np.uint8)
                              ).to(device)
    tab = torch.from_numpy(trans).to(device)
    t0 = time.perf_counter()
    got = hd.dfa_count(packed, tab, bits)
    if packed.is_cuda:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    walls = [timed(lambda: hd.dfa_count(packed, tab, bits), device)[1]
             for _ in range(reps)]
    w = min(walls)
    want, plain_s = timed(lambda: hd.dfa_count_reference(packed, tab, bits), device)
    check(torch.equal(got, want), f"{case} {table}: the kernel's counts differ "
          "from the plain version's")
    line = {"case": case, "table": table, "n_states": n_states, "rows": rows,
            "bits": bits, "streams": streams, "compile_run_s": first_s,
            "completed_row0": int(got[0]), "completed": int(got.sum()),
            "walls_ms": [1e3 * x for x in walls], "ms_steady": 1e3 * w,
            "g_transitions_per_s": rows * bits / w / 1e9,
            "ms_per_stream": 1e3 * w / streams,
            "kernel_ms": None, "kernel_ms_per_stream": None, "bound_ms": None,
            "bound_by": None, "bound_share": None, "sm_clock_mhz": None,
            "bytes": None, "table_bits": None, "lookups": None,
            "bit_serial_bound_ms": None, "bit_serial_bound_share": None,
            "plain_ms": 1e3 * plain_s,
            "host": host, "host_section_ms_per_stream": None,
            "host_over_chain": None}
    if packed.is_cuda:
        kernel = cuda_ms(lambda: hd.dfa_count(packed, tab, bits))
        line["plain_ms"] = cuda_ms(
            lambda: hd.dfa_count_reference(packed, tab, bits), reps=3, inner=1)
        b = hd.bound(rows, bits, row_bytes, n_states, clock_mhz)
        line.update(kernel_ms=kernel, kernel_ms_per_stream=kernel / streams,
                    bound_ms=b["bound_us"] / 1e3, bound_by=b["bound_by"],
                    bound_share=b["bound_us"] / 1e3 / kernel,
                    sm_clock_mhz=clock_mhz, bytes=b["bytes"],
                    table_bits=b["table_bits"], lookups=b["lookups"],
                    bit_serial_bound_ms=b["bit_serial_us"] / 1e3,
                    bit_serial_bound_share=b["bit_serial_us"] / 1e3 / kernel)
    if host is not None:
        sec = host[f"{SECTION.get(table, 'huff_big_values')}_ms_per_stream"]
        line["host_section_ms_per_stream"] = sec
        per_stream = line["kernel_ms_per_stream"] or line["ms_per_stream"]
        line["host_over_chain"] = sec / per_stream
    return line


def cases(rows=None, bits=None, table="count1a") -> list:
    """(case, table, rows, bits, streams) of a run."""
    if rows is not None or bits is not None:
        rows = DEFAULT[1] if rows is None else rows
        bits = DEFAULT[2] if bits is None else bits
        return [("custom", table, rows, bits, rows / DEFAULT[3])]
    shape = bench_shape()
    rows_b = BENCH_STREAMS * shape["granule_channels"]
    return [("default", *DEFAULT[:3], DEFAULT[1] / DEFAULT[3])] + [
        ("bench", t, rows_b, shape["bits"], BENCH_STREAMS) for t in BENCH_TABLES]


def measure(rows=None, bits=None, table="count1a", reps: int = 5,
            host_iters: int = 200, device="cuda") -> list:
    """The JSON lines of a run (cases())."""
    at = where(device)
    from ..bench import max_sm_clock_mhz
    clock = max_sm_clock_mhz() if torch.device(device).type == "cuda" else None
    host = host_sections(host_iters) if host_iters else None
    return [{**run_case(*c, reps, device, host, clock), **at}
            for c in cases(rows, bits, table)]


def _table(s: str):
    return s if s == "count1a" else int(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.tools.device_huffman_spike",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int)
    ap.add_argument("--bits", type=int)
    ap.add_argument("--table", type=_table, default="count1a",
                    help="count1a or a big-values table id (with --rows/--bits)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--host-iters", type=int, default=200,
                    help="unpacks of the host profile (0: none)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for line in measure(args.rows, args.bits, args.table, args.reps,
                        args.host_iters, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
