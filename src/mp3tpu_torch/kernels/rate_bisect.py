"""The encoder's inner rate bisection and exact bit count on the card
(csrc/rate_bisect.cu). No TPU kernel is its counterpart: the JAX package's
rate loops are jnp code (mp3tpu.encoder.vloop_device).

inner_bisect is encoder/vloop_device.py:_inner_bisect and count_rows is
_count_rows, for the rate loops of every encoder path. On CPU tensors they
run those plain torch versions; on CUDA tensors they launch the kernel once
a call (the bisection's closed-form lower bound stays in torch,
vloop_device._bisect_lo, so its float arithmetic is the plain version's) and
give the same results, bit for bit. Each inner_bisect call is a span,
mp3tpu.encode.bisect (items: its rows; outcome kernel or plain).

The kernel reads the count's tables of an EncoderTables as one int32 vector
(count_consts): the code lengths [289, 32] (the 31 columns of m_len, then a
zero column), r1p and r2p [289], c1a_sig and c1b_sig [16], a validity rule a
column [32] (xl for a plain table, ESC | linbits for an escape table, 0 past
the 30 tables), the 256 gain scales (gain_scale) and MAGIC, as float32 bits.
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import build
from ..utils.profiling import annotate

LINES = 576
BINS = 289              # clamped pair bins, 17 x 17
COLUMNS = 32            # the length table's columns in the kernel (31 used)
TABLE_COLUMNS = 31      # 30 Huffman tables and the sign bits
ESC = 0x100             # csrc/rate_bisect.cu kEsc: a rule's escape flag
CONSTS_WORDS = BINS * COLUMNS + 2 * BINS + 2 * 16 + COLUMNS + 256 + 1
# the bound's card, an H100 SXM: SMs, shared-memory words a SM delivers a
# cycle, HBM bytes a second
H100_SMS = 132
LOOKUPS_PER_CYCLE = 32
HBM_BYTES_PER_S = 3.35e12
# bytes a row: bisect reads p34 (float32) and sign (int32), budget and lo,
# and writes gg and next_lo (int32), has and capped (bool); the count reads
# ix (int32) and writes bits, three columns, bv, k and c1sel (int32)
BISECT_ROW_BYTES = 2 * 4 * LINES + 2 * 4 + 2 * 4 + 2
COUNT_ROW_BYTES = 4 * LINES + 7 * 4


def _plain():
    """encoder/vloop_device.py, which holds the plain versions and imports
    this module."""
    from ..encoder import vloop_device
    return vloop_device


@functools.cache
def gain_scale(device) -> torch.Tensor:
    """float32 [256]: 2^(-3/16 (g - 210)) at every global gain g, by the
    expression of vloop_device._quantize, on `device`."""
    g = torch.arange(256, device=device)
    return torch.exp2(-0.75 * (g.float() - 210.0) / 4.0)


_CONSTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def count_consts(t) -> torch.Tensor:
    """The kernel's int32 vector of the tables `t` (an EncoderTables), on
    t's device, made once per EncoderTables (layout: the module's
    docstring)."""
    got = _CONSTS.get(t)
    if got is not None:
        return got
    from ..encoder.quantize import MAGIC
    dev = t.m_len.device
    lens = torch.zeros(BINS, COLUMNS, dtype=torch.int32, device=dev)
    lens[:, :TABLE_COLUMNS] = t.m_len
    rule = torch.zeros(COLUMNS, dtype=torch.int32, device=dev)
    rule[:TABLE_COLUMNS - 1] = torch.where(t.is_esc, ESC | t.linbits, t.xl)
    magic = torch.tensor([MAGIC], dtype=torch.float32, device=dev)
    got = torch.cat([lens.reshape(-1), t.r1p, t.r2p, t.c1a_sig, t.c1b_sig,
                     rule, gain_scale(dev).view(torch.int32),
                     magic.view(torch.int32)])
    _CONSTS[t] = got
    return got


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build("rate_bisect.cu")))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mp3tpu_rate_bisect.restype = I
    lib.mp3tpu_rate_bisect.argtypes = [P] * 9 + [I] * 5 + [P]
    lib.mp3tpu_rate_count.restype = I
    lib.mp3tpu_rate_count.argtypes = [P] * 7 + [I] * 3 + [P]
    lib.mp3tpu_rate_config.restype = I
    lib.mp3tpu_rate_config.argtypes = [ctypes.POINTER(I)] * 4
    lib.mp3tpu_cuda_error_string.restype = ctypes.c_char_p
    lib.mp3tpu_cuda_error_string.argtypes = [I]
    return lib


def _check_rows(name: str, x, dtype, rows=None) -> None:
    """Raise unless x is a contiguous `dtype` tensor [rows, 576] on the CPU
    or a CUDA device (16-byte aligned there)."""
    if (not isinstance(x, torch.Tensor) or x.dtype != dtype or x.dim() != 2
            or x.shape[1] != LINES or (rows is not None and x.shape[0] != rows)):
        want = f"[{'rows' if rows is None else rows}, {LINES}]"
        raise ValueError(f"{name}: {getattr(x, 'dtype', type(x))} "
                         f"{tuple(getattr(x, 'shape', ()))}, expected {dtype} {want}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: the rate loops run on cpu or cuda, not {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
    if x.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: {x.shape[0]} rows, at most 2^31 - 1")


def _check_vector(name: str, x, rows: int, device) -> None:
    if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32
            or tuple(x.shape) != (rows,)):
        raise ValueError(f"{name}: {getattr(x, 'dtype', type(x))} "
                         f"{tuple(getattr(x, 'shape', ()))}, expected int32 ({rows},)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the rows on {device}")


def _check_tables(t, device) -> None:
    if t.m_len.device != device:
        raise ValueError(f"the tables are on {t.m_len.device}, the rows on {device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _library().mp3tpu_cuda_error_string(rc).decode())


def launch_bisect(t, p34, sign, budgets, lo, steps: int, window: int,
                  short_split: bool, out=None) -> tuple:
    """The bisection kernel on the current CUDA stream from the adjusted
    lower bounds `lo` (int32 [R], in [0, 255]): (gg, has, capped, next_lo).
    `out`, where given, is the four tensors it writes (sanitize.py's guarded
    outputs): int32, bool, bool, int32, each [R] and contiguous."""
    R = p34.shape[0]
    dev = p34.device
    if out is None:
        i32 = lambda: torch.empty(R, dtype=torch.int32, device=dev)
        b8 = lambda: torch.empty(R, dtype=torch.bool, device=dev)
        out = (i32(), b8(), b8(), i32())
    for o, dt in zip(out, (torch.int32, torch.bool, torch.bool, torch.int32)):
        if o.dtype != dt or tuple(o.shape) != (R,) or not o.is_contiguous():
            raise ValueError(f"out: {o.dtype} {tuple(o.shape)}, expected a "
                             f"contiguous {dt} ({R},)")
    consts = count_consts(t)
    with torch.cuda.device(dev):
        rc = _library().mp3tpu_rate_bisect(
            p34.data_ptr(), sign.data_ptr(), budgets.data_ptr(), lo.data_ptr(),
            consts.data_ptr(), *(o.data_ptr() for o in out), R, steps, window,
            int(short_split), t.fixed_pairs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "mp3tpu_rate_bisect")
    return tuple(out)


def launch_count(t, ix, short_split: bool, out=None) -> tuple:
    """The count-only kernel on the current CUDA stream: (bits, selr [R, 3],
    bv, k, c1sel), int32. `out`, where given, is the five contiguous int32
    tensors it writes."""
    R = ix.shape[0]
    dev = ix.device
    shapes = ((R,), (R, 3), (R,), (R,), (R,))
    if out is None:
        out = tuple(torch.empty(s, dtype=torch.int32, device=dev) for s in shapes)
    for o, s in zip(out, shapes):
        if o.dtype != torch.int32 or tuple(o.shape) != s or not o.is_contiguous():
            raise ValueError(f"out: {o.dtype} {tuple(o.shape)}, expected a "
                             f"contiguous int32 {s}")
    consts = count_consts(t)
    with torch.cuda.device(dev):
        rc = _library().mp3tpu_rate_count(
            ix.data_ptr(), consts.data_ptr(), *(o.data_ptr() for o in out), R,
            int(short_split), t.fixed_pairs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "mp3tpu_rate_count")
    return tuple(out)


def inner_bisect(t, p34, sign, budgets, lo0, short_split: bool,
                 window: int | None = None) -> tuple:
    """vloop_device._inner_bisect: the fixed-step bisection for the smallest
    fitting gg of each row, from p34 float32 and sign int32 (-1, 0 or 1)
    [R, 576], budgets and lo0 (in [0, 255]) int32 [R], all contiguous on one
    device. Returns (gg int32, has bool, capped bool, next_lo int32) [R]. On
    CUDA tensors one launch of the kernel (counted in inner_bisect.launches)
    after the torch closed-form bound; on CPU tensors the plain version. A
    span mp3tpu.encode.bisect with the rows as items."""
    _check_rows("p34", p34, torch.float32)
    R = p34.shape[0]
    _check_rows("sign", sign, torch.int32, R)
    dev = p34.device
    if sign.device != dev:
        raise ValueError(f"sign is on {sign.device}, p34 on {dev}")
    _check_vector("budgets", budgets, R, dev)
    _check_vector("lo0", lo0, R, dev)
    _check_tables(t, dev)
    if window is not None and not 1 <= window <= 256:
        raise ValueError(f"window {window}: expected 1 to 256 or None")
    vd = _plain()
    with annotate("mp3tpu.encode.bisect", items=R) as sp:
        if dev.type == "cpu":
            out = vd._inner_bisect(t, p34, sign, budgets, lo0, short_split,
                                   window)
            sp.outcome = "plain"
            return out
        lo = vd._bisect_lo(p34, lo0)
        steps = vd._FULL_STEPS if window is None else vd._WINDOW_STEPS
        out = launch_bisect(t, p34, sign, budgets, lo, steps, window or 0,
                            short_split)
        _INNER_BISECT.launches += R > 0
        sp.outcome = "kernel"
        return out


def count_rows(t, ix, short_split: bool) -> tuple:
    """vloop_device._count_rows: the exact big_values + count1 bit count of
    quantized rows ix int32 [R, 576] (contiguous) -> (bits, selr [R, 3]
    table columns, bv, k, c1sel), int32. On CUDA tensors one launch of the
    kernel in count-only mode (counted in count_rows.launches); on CPU
    tensors the plain version."""
    _check_rows("ix", ix, torch.int32)
    _check_tables(t, ix.device)
    if ix.device.type == "cpu":
        return _plain()._count_rows(t, ix, short_split)
    out = launch_count(t, ix, short_split)
    _COUNT_ROWS.launches += ix.shape[0] > 0
    return out


# the launch counters, on the functions as defined here (a caller that wraps
# the module's names, as the tests and chip_smoke.py do, leaves them there)
_INNER_BISECT, _COUNT_ROWS = inner_bisect, count_rows
inner_bisect.launches = 0
count_rows.launches = 0


def kernel_config(device=None) -> dict:
    """The kernel's launch shape on a CUDA device: blocks per SM (the
    occupancy query), threads and static shared memory a block."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.mp3tpu_rate_config(*(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(lib.mp3tpu_cuda_error_string(rc).decode())
    per_sm, threads, smem, words = (v.value for v in vals)
    if words != CONSTS_WORDS:
        raise RuntimeError(f"csrc/rate_bisect.cu reads {words} consts words, "
                           f"count_consts makes {CONSTS_WORDS}")
    return {"blocks_per_sm": per_sm, "threads": threads, "smem_bytes": smem}


def persistent_rows(device) -> int:
    """Rows the persistent grid holds at once on CUDA device `device`: its
    SMs x blocks an SM x warps a block (a warp a row)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cfg = kernel_config(device)
    return sms * cfg["blocks_per_sm"] * cfg["threads"] // 32


def bound(rows: int, walked_pairs: int, sm_clock_mhz: float,
          count_only: bool = False, sms: int = H100_SMS) -> dict:
    """The least time the card could take for one call: the larger of the
    bytes (BISECT_ROW_BYTES or COUNT_ROW_BYTES a row, and the consts, each
    read or written once) over HBM_BYTES_PER_S and the length lookups the
    count needs over the SMs' LOOKUPS_PER_CYCLE a cycle at `sm_clock_mhz`:
    TABLE_COLUMNS a pair below bv, summed over the steps the rows count
    (`walked_pairs`: the sum of bv over them)."""
    nbytes = rows * (COUNT_ROW_BYTES if count_only else BISECT_ROW_BYTES) \
        + 4 * CONSTS_WORDS
    lookups = walked_pairs * TABLE_COLUMNS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = lookups / (sms * LOOKUPS_PER_CYCLE * sm_clock_mhz * 1e6)
    return {"bytes": nbytes, "lookups": lookups,
            "bound_us": 1e6 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
