"""C6-C7 of the granule chain: overlap-add, frequency inversion and the
polyphase synthesis (counterpart of mp3tpu.kernels.pipeline._backend, which
is jnp code there, not a TPU kernel).

synth_backend runs the CUDA kernel of csrc/synth.cu on CUDA tensors and its
plain PyTorch version, synth_backend_reference (unfold + one matmul over the
512 FIR taps), on CPU tensors. The kernel computes the same function in its
factored form, the standard matrixing and 16-tap window, and adds every sum
in one order written in the source, so a sample's bits do not depend on the
call's shape, where a library matmul picks its blocking by the shape.
synth_backend_factored_reference is that factored form in plain PyTorch,
for the tests and chip_smoke.py only. kernels/selfcheck.py holds the kernel
to both plain versions on the card and its bits across shapes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .tables import DeviceTables, synth_v_expansion


def synth_backend_reference(z: torch.Tensor, state: dict, tables: DeviceTables):
    """Overlap-add + frequency inversion + synthesis FIR (C6-C7):
    z [S,G,2,32,36] -> pcm float32 [S, G*576, 2], new state."""
    S, G = z.shape[:2]
    tails = torch.cat([state["overlap"][:, None], z[:, :-1, :, :, 18:]], dim=1)
    s = (z[..., :18] + tails) * tables.inv_mask                # [S,G,2,32,18]
    new_overlap = z[:, -1, :, :, 18:].contiguous()

    # C7: pcm_t = sum_d seq_{t-d} @ synth_fir[d], as one matmul over
    # windows full[t : t+16] (synth_w holds the taps in that order)
    T = G * 18
    seq = s.permute(0, 2, 1, 4, 3).reshape(S, 2, T, 32)
    full = torch.cat([state["hist"], seq], dim=2)             # [S,2,15+T,32]
    win = full.unfold(2, 16, 1).reshape(S * 2 * T, 512)       # [.., k*16+w]
    pcm = (win @ tables.synth_w).reshape(S, 2, T * 32).transpose(1, 2)
    new_hist = full[:, :, -15:].contiguous()
    return pcm, {"overlap": new_overlap, "hist": new_hist}


def synth_backend_factored_reference(z: torch.Tensor, state: dict,
                                     tables: DeviceTables):
    """The same function as synth_backend_reference, in the factored form
    of csrc/synth.cu: V = N @ full for every row of full = hist ++ seq (its
    32 distinct values as one matmul, the other 32 by sign flips and
    copies), then pcm[t, j] = sum over d = 0..15 of D[32d + j] * V[t + 15 -
    d, j + 32 (d & 1)] as tensor ops. Used by the tests and chip_smoke.py,
    by nothing on the decode path."""
    S, G = z.shape[:2]
    tails = torch.cat([state["overlap"][:, None], z[:, :-1, :, :, 18:]], dim=1)
    s = (z[..., :18] + tails) * tables.inv_mask                # [S,G,2,32,18]
    new_overlap = z[:, -1, :, :, 18:].contiguous()

    T = G * 18
    seq = s.permute(0, 2, 1, 4, 3).reshape(S, 2, T, 32)
    full = torch.cat([state["hist"], seq], dim=2)             # [S,2,15+T,32]
    src, sign = synth_v_expansion()
    p = full @ tables.synth_matrix.T                          # [S,2,15+T,32]
    v = p[..., src] * p.new_tensor(sign)                      # [S,2,15+T,64]
    D = tables.synth_window.reshape(16, 32)
    pcm = torch.zeros((S, 2, T, 32), dtype=z.dtype, device=z.device)
    for d in range(16):
        c = 32 * (d & 1)
        pcm = pcm + D[d] * v[:, :, 15 - d:15 - d + T, c:c + 32]
    pcm = pcm.reshape(S, 2, T * 32).transpose(1, 2)
    return pcm, {"overlap": new_overlap, "hist": full[:, :, -15:].contiguous()}


@functools.cache
def _library(defines: tuple = ()) -> ctypes.CDLL:
    """The kernel's library; `defines` builds a measurement variant of it
    (the MP3TPU_SY_* macros of csrc/synth.cu)."""
    lib = ctypes.CDLL(str(build.build("synth.cu", defines)))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mp3tpu_synth.restype = I
    lib.mp3tpu_synth.argtypes = [P, P, P, P, P, P, P, P, I, I, P]
    lib.mp3tpu_synth_config.restype = I
    lib.mp3tpu_synth_config.argtypes = [ctypes.POINTER(I)] * 3
    lib.mp3tpu_cuda_error_string.restype = ctypes.c_char_p
    lib.mp3tpu_cuda_error_string.argtypes = [I]
    return lib


def _check(z, state, tables):
    if z.dim() != 5 or tuple(z.shape[2:]) != (2, 32, 36):
        raise ValueError(f"z: shape {tuple(z.shape)}, expected [S, G, 2, 32, 36]")
    S = z.shape[0]
    want = {"z": (z, tuple(z.shape)),
            "overlap": (state["overlap"], (S, 2, 32, 18)),
            "hist": (state["hist"], (S, 2, 15, 32))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
        if t.device != tables.synth_w.device:
            raise ValueError(f"{name} is on {t.device}, the tables on "
                             f"{tables.synth_w.device}")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"synth_backend runs on cpu or cuda, not {z.device}")


def _launch(z, state, tables: DeviceTables, lib=None, out=None):
    """Launch the kernel of csrc/synth.cu (of `lib`, a variant's library,
    where given) on the current CUDA stream -> (pcm [S, G*576, 2] as the
    view of a channel-planar [S, 2, G*576] tensor, as the plain version
    returns it; new state). `out`, where given, is the (channel-planar pcm,
    new hist) pair the kernel writes (sanitize.py's guarded outputs)."""
    S, G = z.shape[:2]
    dev = z.device
    # the kernel reads these by TMA bulk copies, from 16-byte aligned rows
    z, overlap, hist = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                        else t.clone(memory_format=torch.contiguous_format)
                        for t in (z, state["overlap"], state["hist"]))
    if out is None:
        out = (torch.empty((S, 2, G * 576), dtype=torch.float32, device=dev),
               torch.empty_like(hist))
    pcm, new_hist = out
    for t, shape in ((pcm, (S, 2, G * 576)), (new_hist, tuple(hist.shape))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"out: {tuple(t.shape)} {t.dtype}, expected a "
                             f"contiguous, 16-byte aligned float32 {shape}")
    lib = lib or _library()
    with torch.cuda.device(dev):
        rc = lib.mp3tpu_synth(
            z.data_ptr(), overlap.data_ptr(), hist.data_ptr(),
            tables.inv_mask.data_ptr(), tables.synth_matrix.data_ptr(),
            tables.synth_window.data_ptr(), pcm.data_ptr(), new_hist.data_ptr(),
            S, G, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("mp3tpu_synth kernel launch failed: "
                           + lib.mp3tpu_cuda_error_string(rc).decode())
    new_overlap = z[:, -1, :, :, 18:].contiguous()
    return pcm.transpose(1, 2), {"overlap": new_overlap, "hist": new_hist}


def kernel_config(device=None) -> dict:
    """The kernel's launch shape on a CUDA device: blocks per SM (the
    occupancy query), threads and dynamic shared memory a block."""
    per_sm, threads, smem = (ctypes.c_int(0) for _ in range(3))
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.mp3tpu_synth_config(ctypes.byref(per_sm), ctypes.byref(threads),
                                     ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(lib.mp3tpu_cuda_error_string(rc).decode())
    return {"blocks_per_sm": per_sm.value, "threads": threads.value,
            "smem_bytes": smem.value}


def synth_backend(z: torch.Tensor, state: dict, tables: DeviceTables):
    """C6-C7: z float32 [S,G,2,32,36] and the decoder state {overlap
    [S,2,32,18], hist [S,2,15,32]} -> (pcm float32 [S, G*576, 2], new
    state).

    On CUDA tensors it launches the kernel of csrc/synth.cu (built at first
    use) and counts the launch in synth_backend.launches; on CPU tensors it
    runs synth_backend_reference. Zero streams or zero granules give empty
    PCM and the state as it was, with no launch."""
    _check(z, state, tables)
    S, G = z.shape[:2]
    if S * G == 0:
        return z.new_zeros((S, G * 576, 2)), state
    if z.device.type == "cpu":
        return synth_backend_reference(z, state, tables)
    out = _launch(z, state, tables)
    synth_backend.launches += 1
    return out


synth_backend.launches = 0
