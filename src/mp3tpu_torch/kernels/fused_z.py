"""C1-C5 of the granule chain in one step: requantize, stereo mix, reorder,
alias reduction, IMDCT and window (counterpart of
mp3tpu.kernels.pallas_fused.fused_pipeline_z, the TPU kernel _kernel_z), and
its first four stages alone (counterpart of fused_frontend, the TPU kernel
_kernel).

fused_pipeline_z and fused_frontend run the C1-C5 and the C1-C4
instantiations of the CUDA kernel of csrc/fused_z.cu on CUDA tensors, with
the symbols as they are (a pair of _SYMBOL_TYPES, int8 or int32 block
type), and their plain PyTorch versions,
fused_pipeline_z_reference and fused_frontend_reference, on CPU tensors.
kernels/selfcheck.py holds each kernel to its plain version on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .tables import DeviceTables

_INT_TYPES = (torch.int16, torch.int32)
# (spectrum, exponents) types the kernel reads: int16 symbols (player,
# scheduler, single-stream decode), the plane decode's int32, and int32
# spectrum with int16 exponents where its byte exponents overflow
_SYMBOL_TYPES = ((torch.int16, torch.int16), (torch.int32, torch.int32),
                 (torch.int32, torch.int16))


def _pow43(a: torch.Tensor) -> torch.Tensor:
    """|is|^(4/3) = a * cbrt(a); the cube root is seeded by pow(a, 1/3)
    and refined by one Newton step, as the XLA path's _pow43."""
    y = torch.pow(a, 1.0 / 3.0)
    y2 = y * y
    y = torch.where(a > 0, y - (y2 * y - a) / (3.0 * y2 + 1e-30), 0.0)
    return a * y


def _flavor(block_type: torch.Tensor, mixed: torch.Tensor) -> torch.Tensor:
    """0 long, 1 short, 2 mixed (int64, for indexing)."""
    short = block_type.long() == 2
    return torch.where(short, torch.where(mixed.bool(), 2, 1), 0)


def fused_frontend_reference(is_, exp, block_type, mixed, smode,
                             tables: DeviceTables) -> torch.Tensor:
    """Plain C1-C4 (the XLA path's _granule_pipeline_xla up to nat, with
    direct indexing where it multiplies by one-hot matrices).

    is_ int [S,G,2,576], exp int [S,G,2,64], block_type int [S,G,2],
    mixed bool [S,G,2], smode uint8 [S,G,64] -> natural-order,
    alias-reduced spectrum float32 [S,G,2,576]."""
    iv = is_.float()
    fl = _flavor(block_type, mixed)                          # [S,G,2]

    # C1 requantize: sign * |is|^(4/3) * 2^(exp[band]/4)
    bands = tables.band_map.long()[fl]                       # [S,G,2,576]
    e_line = exp.long().gather(-1, bands).float()
    xr = torch.sign(iv) * _pow43(iv.abs()) * torch.exp2(0.25 * e_line)

    # C2 stereo: palette matrix per band on channel 0's band geometry
    pidx = smode.long().gather(-1, bands[:, :, 0])           # [S,G,576]
    m = tables.palette4[pidx]                                # [S,G,576,4]
    x0, x1 = xr[:, :, 0], xr[:, :, 1]
    xr = torch.stack([m[..., 0] * x0 + m[..., 1] * x1,
                      m[..., 2] * x0 + m[..., 3] * x1], dim=2)

    # C3 reorder + C4 alias butterflies (each line has at most one partner)
    v = xr.gather(-1, tables.reorder_map.long()[fl])
    return (v * tables.alias_self[fl]
            + v.gather(-1, tables.alias_partner[fl]) * tables.alias_cross[fl])


def fused_pipeline_z_reference(is_, exp, block_type, mixed, smode,
                               tables: DeviceTables) -> torch.Tensor:
    """Plain C1-C5: fused_frontend_reference, then the IMDCT and window.

    Takes the inputs of fused_frontend_reference -> z float32
    [S,G,2,32,36]."""
    S, G = is_.shape[:2]
    v = fused_frontend_reference(is_, exp, block_type, mixed, smode, tables)
    v = v.reshape(S, G, 2, 32, 18)
    bt = block_type.long()
    fl = _flavor(bt, mixed)

    # C5 IMDCT + window; per-subband block type (mixed: subbands 0-1 long)
    sb = torch.arange(32, device=v.device)
    bt_sb = torch.where((fl == 2)[..., None] & (sb < 2), 0, bt[..., None])
    z_long = v @ tables.imdct_long
    z_short = v @ tables.imdct_short
    return torch.where((bt_sb == 2)[..., None], z_short,
                       z_long * tables.windows[bt_sb])


@functools.cache
def _library(defines: tuple = ()) -> ctypes.CDLL:
    """The kernels' library; `defines` builds a measurement variant of it
    (csrc/fused_z.cu's MP3TPU_FZ_* macros)."""
    lib = ctypes.CDLL(str(build.build("fused_z.cu", defines)))
    P, I = ctypes.c_void_p, ctypes.c_int
    head = [P, I, P, I, P, I, P, P, P, P, P, P, I, P, P]
    lib.mp3tpu_fused_z.restype = I
    lib.mp3tpu_fused_z.argtypes = head + [P, P, ctypes.c_int64, P]
    lib.mp3tpu_fused_frontend.restype = I
    lib.mp3tpu_fused_frontend.argtypes = head + [P, ctypes.c_int64, P]
    lib.mp3tpu_fused_blocks_per_sm.restype = I
    lib.mp3tpu_fused_blocks_per_sm.argtypes = [I, ctypes.POINTER(I)]
    lib.mp3tpu_cuda_error_string.restype = ctypes.c_char_p
    lib.mp3tpu_cuda_error_string.argtypes = [I]
    return lib


def _check(is_, exp, block_type, mixed, smode, tables):
    S, G = is_.shape[:2]
    want = {"is_": (is_, (S, G, 2, 576), _INT_TYPES),
            "exp": (exp, (S, G, 2, 64), _INT_TYPES),
            "block_type": (block_type, (S, G, 2), (torch.int8, torch.int32)),
            "mixed": (mixed, (S, G, 2), (torch.bool, torch.uint8)),
            "smode": (smode, (S, G, 64), (torch.uint8,))}
    for name, (t, shape, dtypes) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
        if t.device != tables.band_map.device:
            raise ValueError(f"{name} is on {t.device}, the tables on "
                             f"{tables.band_map.device}")
    if (is_.dtype, exp.dtype) not in _SYMBOL_TYPES:
        raise TypeError(f"is_/exp: dtypes {is_.dtype}/{exp.dtype}, expected "
                        f"a pair of {_SYMBOL_TYPES}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned, as the kernel's bulk copies need:
    the tensors of the decode paths already are, and pass as they are."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(entry: str, out_tail: tuple, is_, exp, block_type, mixed, smode,
            tables: DeviceTables, lib: ctypes.CDLL | None = None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch one instantiation of the kernel of csrc/fused_z.cu (`entry`,
    writing float32 [S, G, 2, *out_tail]) on the current CUDA stream, from
    `lib` (default: _library()), into `out` where given (a contiguous,
    16-byte aligned tensor of that shape: sanitize.py's guarded outputs).
    The symbols go in with the types they have; nothing is cast first."""
    S, G = is_.shape[:2]
    dev = is_.device
    shape = (S, G, 2) + out_tail
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out: {tuple(out.shape)} {out.dtype}, expected a "
                         f"contiguous, 16-byte aligned float32 {shape}")
    if S * G == 0:
        return out
    is_, exp, smode = _aligned(is_), _aligned(exp), _aligned(smode)
    block_type = block_type.contiguous()
    mixed = mixed.contiguous().view(torch.uint8)
    t = tables
    coefs = ([t.imdct_coefs_host.data_ptr()] if entry == "mp3tpu_fused_z"
             else [])
    lib = lib or _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            is_.data_ptr(), is_.element_size(), exp.data_ptr(),
            exp.element_size(), block_type.data_ptr(),
            block_type.element_size(), mixed.data_ptr(), smode.data_ptr(),
            t.band_map.data_ptr(), t.reorder_map.data_ptr(),
            t.n_alias.data_ptr(), t.palette4.data_ptr(), t.palette4.shape[0],
            t.alias_cs.data_ptr(), t.alias_ca.data_ptr(), *coefs,
            out.data_ptr(), S * G, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           + lib.mp3tpu_cuda_error_string(rc).decode())
    return out


def _device_type(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return t.device.type


def fused_pipeline_z(is_, exp, block_type, mixed, smode,
                     tables: DeviceTables) -> torch.Tensor:
    """C1-C5 -> z float32 [S,G,2,32,36], ready for the overlap-add.

    On CUDA tensors it launches the kernel of csrc/fused_z.cu (built at
    first use) and counts the launch in fused_pipeline_z.launches; on CPU
    tensors it runs fused_pipeline_z_reference."""
    _check(is_, exp, block_type, mixed, smode, tables)
    if _device_type(is_, "fused_pipeline_z") == "cpu":
        return fused_pipeline_z_reference(is_, exp, block_type, mixed, smode,
                                          tables)
    z = _launch("mp3tpu_fused_z", (32, 36), is_, exp, block_type, mixed,
                smode, tables)
    if z.numel():  # zero pairs launch nothing
        fused_pipeline_z.launches += 1
    return z


fused_pipeline_z.launches = 0


def fused_frontend(is_, exp, block_type, mixed, smode,
                   tables: DeviceTables) -> torch.Tensor:
    """C1-C4 -> natural-order, alias-reduced spectrum float32 [S,G,2,576].

    On CUDA tensors it launches the C1-C4 instantiation of the kernel of
    csrc/fused_z.cu and counts the launch in fused_frontend.launches; on
    CPU tensors it runs fused_frontend_reference. No decode path calls it:
    the JAX package has none either."""
    _check(is_, exp, block_type, mixed, smode, tables)
    if _device_type(is_, "fused_frontend") == "cpu":
        return fused_frontend_reference(is_, exp, block_type, mixed, smode,
                                        tables)
    nat = _launch("mp3tpu_fused_frontend", (576,), is_, exp, block_type,
                  mixed, smode, tables)
    if nat.numel():  # zero pairs launch nothing
        fused_frontend.launches += 1
    return nat


fused_frontend.launches = 0
