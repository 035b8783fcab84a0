"""Device encoder transform: E1+E2 as batched torch (SURVEY.md §3.4:
analysis filterbank + MDCT run on the device).

Counterpart of mp3tpu.encoder.device. Maps a whole batch of PCM onto
spectra: the analysis polyphase bank is the same 16-tap FIR over 32-sample
blocks as the host version (16 accumulated [32 -> 32] matmuls), the MDCT is
a [36 -> 18] windowed constant matmul per block type, alias and reorder are
the decoder matrices' transposes. Granules are grouped by block type and
each group takes its own matrices, where the JAX package computes all four
and selects with a one-hot. All matmuls are float32 (TF32 stays off, as
torch leaves it by default). Matches the numpy transform to float32 accuracy
(tested).

Also here: staging of encoder input (int16 where every sample is
int16-origin), the gather of trimmed stream rows out of a device-resident
DecodedBatch chunk, and the float64 sub-block energies that block-type labels
are decided from.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
from torch import nn

from .tables import EncoderTables, encoder_tables

SPF = 576
# streams of one transform call: bounds the FIR's and the MDCT's temporaries
TRANSFORM_ROWS = 32


class EncoderTransform(nn.Module):
    """E1+E2 of one sample rate: PCM [B, n] -> transmitted-order spectra
    [B, G, 576], with the matrices as the tables' buffers."""

    def __init__(self, tables: EncoderTables):
        super().__init__()
        self.tables = tables

    def forward(self, pcm: torch.Tensor, block_types: torch.Tensor):
        """pcm f32 [B, n] (n a multiple of 576); block_types int64 [B, G] on
        the same device -> xr f32 [B, G, 576]."""
        t = self.tables
        B, n = pcm.shape
        G = n // SPF
        T = n // 32
        ppad = torch.cat([pcm.new_zeros(B, 15, 32), pcm.reshape(B, T, 32)], dim=1)
        s = ppad[:, 15: 15 + T] @ t.analysis_fir[0]
        for d in range(1, 16):
            s += ppad[:, 15 - d: 15 - d + T] @ t.analysis_fir[d]
        sg = s.reshape(B, G, 18, 32).transpose(2, 3) * t.inv_mask   # [B,G,32,18]
        prev = torch.cat([sg.new_zeros(B, 1, 32, 18), sg[:, :-1]], dim=1)
        wide = torch.cat([prev, sg], dim=3).reshape(B * G, 32, 36)
        out = pcm.new_empty(B * G, SPF)
        flat = block_types.reshape(-1)
        for bt in range(4):
            sel = torch.nonzero(flat == bt)[:, 0]
            if sel.numel() == 0:
                continue
            nat = (wide[sel] @ t.mdct[bt]).reshape(-1, SPF)
            out[sel] = nat @ t.post[bt]
        return out.reshape(B, G, SPF)


def _transform_rows(pcm_dev: torch.Tensor, block_types: np.ndarray,
                    sample_rate: int) -> torch.Tensor:
    tr = EncoderTransform(encoder_tables(sample_rate, pcm_dev.device))
    bts = torch.as_tensor(np.asarray(block_types, np.int64)).to(pcm_dev.device)
    parts = [tr(pcm_dev[lo: lo + TRANSFORM_ROWS], bts[lo: lo + TRANSFORM_ROWS])
             for lo in range(0, pcm_dev.shape[0], TRANSFORM_ROWS)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def granule_spectra_device(pcm: np.ndarray, block_types: np.ndarray,
                           sample_rate: int, device="cuda") -> np.ndarray:
    """Device counterpart of transform.granule_spectra for one channel."""
    return granule_spectra_device_batch(pcm[None], block_types[None],
                                        sample_rate, device=device)[0]


def granule_spectra_device_batch(pcm: np.ndarray, block_types: np.ndarray,
                                 sample_rate: int, device="cuda") -> np.ndarray:
    """pcm [B, n] and block_types [B, G] on the host -> float64 spectra
    [B, G, 576] on the host."""
    G = pcm.shape[1] // SPF
    x = torch.as_tensor(np.ascontiguousarray(pcm[:, : G * SPF], np.float32))
    xr = _transform_rows(x.to(device), block_types, sample_rate)
    return xr.cpu().numpy().astype(np.float64)


def granule_spectra_device_handle(pcm_dev: torch.Tensor,
                                  block_types: np.ndarray,
                                  sample_rate: int) -> torch.Tensor:
    """As granule_spectra_device_batch but takes staged device pcm [B, n]
    f32 and returns the device spectra [B, G, 576] f32 (no host round-trip:
    the batch encoder keeps the spectra on the device through the rate
    loops)."""
    return _transform_rows(pcm_dev, block_types, sample_rate)


FORCE_F32_STAGE = False  # test hook: pin the f32 staging path


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    """One host -> device copy; from pinned memory where the device is a
    card."""
    t = torch.from_numpy(host)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def stage_pcm(pcm_b: np.ndarray, device="cuda"):
    """Stage encoder input PCM [B, n] f32, shipping int16 when every
    sample is int16-origin (k/32768 with k in range: WAV files and decoder
    output, almost all real encoder input): half the H2D bytes, and k/2^15
    dequantized on the device is exact in f32, so the encode is
    bit-identical to f32 staging (tested). Returns (pcm_dev,
    staged_int16)."""
    if FORCE_F32_STAGE:
        return _to_device(pcm_b, device), False
    rows = max(1, (4 << 20) // max(pcm_b.shape[1] * 4, 1))
    i16 = np.empty(pcm_b.shape, np.int16)
    for lo in range(0, pcm_b.shape[0], rows):
        x = pcm_b[lo:lo + rows] * np.float32(32768.0)
        if not (np.array_equal(x, np.rint(x))
                and (x >= -32768.0).all() and (x <= 32767.0).all()):
            return _to_device(pcm_b, device), False
        i16[lo:lo + rows] = x.astype(np.int16)
    return _to_device(i16, device).float() * (1.0 / 32768.0), True


# the staging buffer that stage_int16 reuses across calls, and the event after
# the last copy out of it
_STAGE: dict = {"buf": None, "copied": None}
_STAGE_LOCK = threading.Lock()
STAGE_SLICE = 1 << 14  # samples of a stream quantized at a time: 256 KiB of stereo


def _quantize_into(a: np.ndarray, out: np.ndarray) -> bool:
    """out[...] = rint(a * 32768) as int16 if every sample of the float64 a
    [n, nch] is int16-origin (a * 32768 integral, in [-32768, 32767]), in
    slices that stay in cache; False at the first slice where one is not."""
    tmp = np.empty((min(len(a), STAGE_SLICE), a.shape[1]))
    rnd = np.empty_like(tmp)
    for lo in range(0, len(a), STAGE_SLICE):
        m = min(STAGE_SLICE, len(a) - lo)
        x = np.multiply(a[lo:lo + m], 32768.0, out=tmp[:m])
        r = np.rint(x, out=rnd[:m])
        if (x != r).any() or r.min() < -32768.0 or r.max() > 32767.0:
            return False
        np.copyto(out[lo:lo + m], r, casting="unsafe")
    return True


def stage_int16(arrs, device="cuda"):
    """Stage float64 encoder input streams [n_s, nch] as one int16 batch
    [B, max n_s, nch] on `device` (rows past n_s hold whatever an earlier
    call left: gather_rows trims them), or None where a sample of some stream
    is not int16-origin. One host pass quantizes the streams into a staging
    buffer, pinned on a card, that later calls reuse (grown when a batch
    needs more), and one copy ships it. A call first waits for the previous
    call's copy out of the buffer, so that shards on side streams in turn
    never overwrite a copy in flight."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    B, nch = len(arrs), arrs[0].shape[1]
    n_max = max(1, max(len(a) for a in arrs))
    need = B * n_max * nch
    with _STAGE_LOCK:
        if _STAGE["copied"] is not None:
            _STAGE["copied"].synchronize()
            _STAGE["copied"] = None
        buf = _STAGE["buf"]
        if (buf is None or buf.numel() < need
                or (on_card and not buf.is_pinned())):
            buf = _STAGE["buf"] = torch.empty(need, dtype=torch.int16,
                                              pin_memory=on_card)
        host = buf[:need].view(B, n_max, nch)
        h = host.numpy()
        for s, a in enumerate(arrs):
            if not _quantize_into(a, h[s, : len(a)]):
                return None
        if not on_card:
            return host.clone()
        out = host.to(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        _STAGE["copied"] = ev
        return out


def gather_rows(chunk_i16: torch.Tensor, rows, skips, lens, T: int,
                nch: int) -> torch.Tensor:
    """Device-resident encode input: pull trimmed, zero-padded, dequantized
    stream rows out of a DecodedBatch int16 chunk, so that the PCM stays on
    the device between decode and encode (the transcode path).

    chunk int16 [S, n, C]; rows/skips/lens [K] ints -> f32 [K, nch, T]:
    stream k's [skips[k], skips[k] + lens[k]) PCM, dequantized k/2^15 (exact
    in f32, identical to stage_pcm's int16-origin staging), zero-padded to
    T."""
    dev = chunk_i16.device
    ints = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    rows, skips, lens = ints(rows), ints(skips), ints(lens)
    j = torch.arange(T, device=dev)
    idx = torch.clamp(skips[:, None] + j[None], max=chunk_i16.shape[1] - 1)
    sel = chunk_i16[rows[:, None], idx]                          # [K, T, C]
    sel = torch.where(j[None, :, None] < lens[:, None, None], sel, 0)
    out = sel.float() * (1.0 / 32768.0)
    return out[:, :, :nch].transpose(1, 2).contiguous()          # [K, nch, T]


def subblock_energy(pcm_bnt: torch.Tensor, align: int) -> torch.Tensor:
    """64-sample sub-block energies of the high-passed channel mean:
    block_type_sequence's reduction half, on the device (the decision half
    stays on the host: psymodel.block_types_from_subblock_energy). `align`
    applies align_to_mdct's delay. f32 [B, nch, T] (T % 64 == 0) ->
    e float64 [B, T // 64].

    In float64, and so for int16-origin PCM (k/2^15) equal bit for bit to
    the host's float64 energies: the channel mean needs 17 bits, the
    high-pass 18, a square 36 and a sum of 64 squares 42, all under
    float64's 53 in any order of summation."""
    x = pcm_bnt.double().mean(dim=1)                             # [B, T]
    T = x.shape[1]
    x = torch.nn.functional.pad(x, (align, 0))[:, :T]
    hp = x - torch.cat([x[:, :1], x[:, :-1]], dim=1)
    hp = hp.reshape(x.shape[0], T // 64, 64)
    return (hp * hp).sum(dim=2)
