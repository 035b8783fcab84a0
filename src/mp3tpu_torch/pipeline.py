"""File-level decode: host unpack -> device windows -> PCM
(counterpart of mp3tpu.pipeline: the single-file and batch decodes, the
envelope scans behind segment/loudness/levels, and the streaming source the
player reads).

The host half (container parse, C++ unpack, fault counters, config) is the
port's own copy of the JAX package's (container/, bitstream/, metrics.py,
config.py). Every device function takes `device`; the default is "cuda".
Batches the packed-plane fast path cannot take go to
player.scheduler.decode_batch_streams, as in the JAX package.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .bitstream.unpack import SymbolTensors, unpack_fast
from .container import frames as fr
from .container.id3 import parse_id3v2
from .container.xing import is_metadata_frame, parse_stream_info
from .dsp.gapless import gapless_bounds
from .kernels import pipeline as kp

# One window shape for every single-stream path, and windows per group, as
# in the JAX package: the last group is zero-padded to the full group.
WINDOW = 32
GROUP_WINDOWS = 8
ENV_HOP = 576  # envelope hop = one granule (13 ms @ 44.1 kHz)


def _read(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def _native_lib():
    """The C++ unpacker's library, or None (MP3TPU_NO_NATIVE is set, or
    the host has no g++); raises when its build fails."""
    from .bitstream import native as nat
    return nat._load()


def load_symbols(data: bytes):
    """Container parse + unpack: (SymbolTensors, StreamInfo, FrameIndex),
    without ID3v2 regions and a leading Xing/Info/VBRI metadata frame."""
    from .metrics import record_resyncs, record_symbol_errors
    id3 = parse_id3v2(data)
    buf = np.frombuffer(data, np.uint8)
    index = fr.scan_frames(buf, start=id3.size)
    info = parse_stream_info(data, int(index.offsets[0]), index.headers[0])
    st = unpack_fast(data)
    if is_metadata_frame(info):
        n = index.headers[0].n_granules
        st = st.slice_granules(n, st.n_granules)
        index = fr.FrameIndex(
            offsets=index.offsets[1:], headers=index.headers[1:],
            junk_bytes=index.junk_bytes, sample_rate=index.sample_rate,
            channels=index.channels, version=index.version,
            resyncs=index.resyncs)
    # counted after the metadata-frame trim, as the batch path counts
    record_resyncs(index.resyncs)
    record_symbol_errors(st.errors, st.granules_per_frame)
    return st, info, index


def load_source(data: bytes):
    """Container parse + streaming symbol source: (SymbolSource,
    StreamInfo, FrameIndex). No audio is unpacked up front: the player and
    the scheduler pull granule windows on demand."""
    from .bitstream.source import SymbolSource
    id3 = parse_id3v2(data)
    body = data[id3.size:] if id3.size else data
    index = fr.scan_frames(np.frombuffer(body, np.uint8))
    info = parse_stream_info(body, int(index.offsets[0]), index.headers[0])
    skip = 1 if is_metadata_frame(info) else 0
    src = SymbolSource(body, index=index, skip_frames=skip)
    if skip:
        index = fr.FrameIndex(
            offsets=index.offsets[1:], headers=index.headers[1:],
            junk_bytes=index.junk_bytes, sample_rate=index.sample_rate,
            channels=index.channels, version=index.version,
            resyncs=index.resyncs)
    return src, info, index


def _iter_group_pcm(st: SymbolTensors, window: int, group: int, device):
    """Yield (pcm float32 [1, window*group*576, 2] on `device`, valid
    granules) per group of `group` windows, carrying the decoder state."""
    G = st.n_granules
    state = kp.init_state(1, device=device)
    span = window * group
    for start in range(0, G, span):
        g = min(span, G - start)

        def prep(a):
            a = a[start:start + g]
            if g != span:  # zero-pad the final partial group
                a = np.pad(a, ((0, span - g),) + ((0, 0),) * (a.ndim - 1))
            return torch.from_numpy(np.ascontiguousarray(a[None])).to(device)

        pcm, state = kp.decode_window_group(
            prep(st.is_), prep(st.exp), prep(st.block_type), prep(st.mixed),
            prep(st.smode), state, st.sample_rate, group)
        yield pcm, g


def decode_symbols_device(st: SymbolTensors, window: int = WINDOW,
                          group: int = GROUP_WINDOWS,
                          output: str = "float32", device="cuda") -> np.ndarray:
    """All granules of one stream -> PCM [n, channels], int16 (quantized on
    the device, per group) or float32."""
    out = []
    for pcm, g in _iter_group_pcm(st, window, group, device):
        if output == "int16":
            pcm = kp.quantize_i16(pcm)
        out.append(pcm[0, : g * 576].cpu().numpy())
    return np.concatenate(out, axis=0)[:, : st.channels]


def decode_envelope_device(st: SymbolTensors, window: int = WINDOW,
                           group: int = GROUP_WINDOWS,
                           with_peak: bool = False,
                           peak_bounds: tuple | None = None, device="cuda"):
    """Per-granule power envelope (dB) of one stream, reduced on the
    device group by group: only the envelope crosses to the host. Returns
    env_db [n_granules] float32; frame f covers samples [f*ENV_HOP,
    (f+1)*ENV_HOP). with_peak=True also returns the sample peak (max |x|,
    linear) over peak_bounds=(lo, hi) (default: the whole stream)."""
    nch = st.channels
    lo, hi = peak_bounds if peak_bounds is not None else (0, st.n_granules * 576)
    envs, peaks, pos = [], [], 0
    for pcm, g in _iter_group_pcm(st, window, group, device):
        x = pcm[0, :, :nch]
        p = (x * x).mean(dim=1)
        e = p.reshape(-1, ENV_HOP).mean(dim=1)
        envs.append((10.0 * torch.log10(e + 1e-12))[:g])
        if with_peak:
            idx = pos + torch.arange(x.shape[0], device=x.device)
            m = ((idx >= lo) & (idx < hi)).float()
            peaks.append((x.abs() * m[:, None]).max())
        pos += g * 576
    env = torch.cat(envs).cpu().numpy()
    if not with_peak:
        return env
    return env, max(0.0, float(torch.stack(peaks).max()))


def _shift_segments(segs, total, sr, info, gapless):
    """Sample segments on the untrimmed timeline -> seconds on the
    gapless-trimmed one (the clock decode()/play use)."""
    a, b = 0, total
    if gapless and info.gapless:
        a, b = gapless_bounds(total, info.encoder_delay, info.encoder_padding)
    out = []
    for s, e in segs:
        s2, e2 = max(s - a, 0), min(e - a, b - a)
        if e2 > s2:
            out.append((s2 / sr, e2 / sr))
    return out


def segment_file(path_or_bytes, gapless: bool | None = None, device="cuda",
                 **kw):
    """Sentence/pause boundaries [(start_s, end_s), ...] of one file
    (dsp/segment.py semantics) from the device envelope, on the
    gapless-trimmed timeline when the LAME tag is present. The envelope hop
    is fixed at one granule (ENV_HOP); a hop_s that rounds to another hop
    is rejected."""
    from .config import get_active
    from .dsp.segment import segments_from_envelope
    if gapless is None:
        gapless = get_active().decode.gapless
    st, info, _index = load_symbols(_read(path_or_bytes))
    kw = _check_seg_kw(kw, st.sample_rate)
    env = decode_envelope_device(st, device=device)
    total = st.n_granules * 576
    segs = segments_from_envelope(env, ENV_HOP, st.sample_rate,
                                  total=total, **kw)
    return _shift_segments(segs, total, st.sample_rate, info, gapless)


def _check_seg_kw(kw: dict, sr: int) -> dict:
    """A copy of kw without hop_s, which device-envelope segmentation
    accepts only when it is the fixed ENV_HOP at this sample rate."""
    kw = dict(kw)
    hop_s = kw.pop("hop_s", None)
    if hop_s is not None and int(round(hop_s * sr)) != ENV_HOP:
        raise ValueError(
            f"device-envelope segmentation has a fixed {ENV_HOP}-sample "
            f"({ENV_HOP / sr:.4f} s at {sr} Hz) hop; hop_s={hop_s} is only "
            "available through Player.segments() (host envelope)")
    return kw


def loudness_file(path_or_bytes, device="cuda") -> float:
    """Track loudness in dB (ReplayGain-style 95th-percentile block
    statistic, dsp/loudness.py) from the device envelope."""
    return track_levels(path_or_bytes, device=device)[0]


def track_levels(path_or_bytes, device="cuda") -> tuple:
    """(loudness_db, peak_db) of one track from one device envelope scan.
    The peak and the loudness frames are taken over the playable
    (gapless-trimmed) range; the envelope covers the whole stream."""
    from .dsp.loudness import loudness_db
    st, info, _index = load_symbols(_read(path_or_bytes))
    n = st.n_granules * 576
    if info.gapless:
        lo, hi = gapless_bounds(n, info.encoder_delay, info.encoder_padding)
        hi = min(hi, n)
    else:
        lo, hi = 0, n
    env, peak = decode_envelope_device(st, with_peak=True,
                                       peak_bounds=(lo, hi), device=device)
    pk_db = 20.0 * float(np.log10(max(peak, 1e-9)))
    return loudness_db(_playable_env(env, lo, hi), ENV_HOP,
                       st.sample_rate), pk_db


def _playable_env(env, lo: int, hi: int):
    """Envelope frames fully inside the playable sample range [lo, hi)."""
    f_lo, f_hi = -(-lo // ENV_HOP), hi // ENV_HOP
    return env[f_lo:f_hi] if f_hi > f_lo else env


def decode_file(path_or_bytes, output: str | None = None,
                gapless: bool | None = None, device="cuda"):
    """decode(path) -> (pcm, sample_rate). output "int16" or "float32";
    gapless trims the encoder delay and padding of a LAME tag. Unset
    arguments come from the port's active Config (config.py)."""
    from .config import get_active
    cfg = get_active().decode
    output = cfg.output if output is None else output
    gapless = cfg.gapless if gapless is None else gapless
    st, info, _index = load_symbols(_read(path_or_bytes))
    pcm = decode_symbols_device(st, window=cfg.window_granules, output=output,
                                device=device)
    if gapless and info.gapless:
        a, b = gapless_bounds(len(pcm), info.encoder_delay, info.encoder_padding)
        pcm = pcm[a:b]
    return pcm, st.sample_rate


def decode_files(paths, gapless: bool = True, output: str = "pcm",
                 device="cuda"):
    """Batched multi-stream decode -> [(pcm int16 [n, ch], sample_rate)],
    aligned with the inputs and trimmed as decode_file trims."""
    if output == "device":
        raise NotImplementedError(
            'output="device" (the DecodedBatch handle) is not ported yet '
            "(ROADMAP Queue 1 item 4)")
    if output != "pcm":
        raise ValueError(f'output must be "pcm" or "device", got {output!r}')
    datas = [_read(p) for p in paths]
    fast = _decode_files_fast(datas, gapless, device)
    if fast is not None:
        return fast
    from .player.scheduler import decode_batch_streams
    return decode_batch_streams(datas, gapless=gapless, device=device)


def _decode_files_fast(datas, gapless: bool, device):
    """C++ unpack of every stream into window-major packed planes (4-bit
    spectrum + two-level escape sideband + byte exponents, widened on
    overflow), length-sorted chunks of batch_chunk_streams streams,
    fixed-shape windows on the device. Chunks over decode.batch_max_mb go
    to the scheduler. Returns None when the batch needs the scheduler
    whole: the C++ unpacker off or missing, a stream it cannot take, or a
    chunk no packed plane holds."""
    from .config import get_active
    cfg = get_active().decode
    if not cfg.use_native or _native_lib() is None:
        return None
    try:
        metas = [stream_meta(d) for d in datas]
    except (ValueError, IndexError):  # not a stream the container scan takes
        return None
    if any(m is None for m in metas):
        return None
    G_all = [probe_granules(m[0]) for m in metas]
    if min(G_all) <= 0:
        return None
    out: list = [None] * len(datas)
    slow: list = []
    pending_faults: list = []
    S, win = cfg.batch_chunk_streams, cfg.window_granules
    for rate in sorted({m[2] for m in metas}):
        idxs = sorted((i for i, m in enumerate(metas) if m[2] == rate),
                      key=lambda i: G_all[i])
        for c0 in range(0, len(idxs), S):
            chunk = idxs[c0: c0 + S]
            n_win = -(-max(G_all[i] for i in chunk) // win)
            nb = 1 << max(0, n_win - 1).bit_length()  # window bucket
            est_mb = S * (n_win * win * 934 + nb * win * 2304) / 1e6
            if est_mb > cfg.batch_max_mb:
                slow.extend(chunk)
                continue
            if not _fast_chunk(metas, chunk, [G_all[i] for i in chunk], rate,
                               gapless, out, cfg, pending_faults, device):
                return None
    # fault books commit only once every chunk has decoded: a batch that
    # goes to the scheduler whole keeps the scheduler's books alone
    from .metrics import record_resyncs, record_symbol_errors
    for errs, ngr, nrs in pending_faults:
        record_symbol_errors(errs, ngr)
        record_resyncs(nrs)
    if slow:
        from .player.scheduler import decode_batch_streams
        res = decode_batch_streams([datas[i] for i in slow], gapless=gapless,
                                   device=device)
        for i, r in zip(slow, res):
            out[i] = r
    return out


def stream_meta(data: bytes):
    """(audio body, StreamInfo, sample_rate, channels, version, resyncs) of
    one stream; the body lacks ID3v2 and a leading metadata frame. None
    when the metadata frame's bytes cannot be dropped exactly."""
    id3 = parse_id3v2(data)
    body = data[id3.size:] if id3.size else data
    index = fr.scan_frames(np.frombuffer(body, np.uint8))
    info = parse_stream_info(body, int(index.offsets[0]), index.headers[0])
    if is_metadata_frame(info):
        # dropping the metadata frame's bytes is exact only when the first
        # audio frame's reservoir pointer is 0
        if len(index.offsets) < 2:
            return None
        off = int(index.offsets[1])
        h = index.headers[1]
        si = off + 4 + (2 if h.crc_protected else 0)
        if si + 2 > len(body) or ((body[si] << 1) | (body[si + 1] >> 7)):
            return None
        body = body[off:]
    return (body, info, index.sample_rate, index.channels, index.version,
            index.resyncs)


def probe_granules(body: bytes) -> int:
    """Granule count of an audio body by the C++ probe; <= 0 when the probe
    refuses the stream."""
    import ctypes
    meta4 = (ctypes.c_int32 * 4)()
    return _native_lib().mp3tpu_probe(body, len(body), meta4)


def unpack_planes(bodies, Gs, S: int, win: int, plane_bits: int = 4):
    """C++ unpack of up to S streams into window-major packed planes
    [n_win, S, win, ...], widening on overflow: byte exponents -> int16,
    then 4 -> 8 -> 12-bit spectrum planes. Returns (planes, per-stream
    error flags, plane_bits, exp_bytes), or None if no plane holds them."""
    exp_bytes = True
    while (got := _unpack_chunk(bodies, Gs, S, win, plane_bits,
                                exp_bytes)) is None:
        if exp_bytes:
            exp_bytes = False
        elif plane_bits in (4, 8):
            plane_bits = {4: 8, 8: 12}[plane_bits]
        else:
            return None
    return got + (plane_bits, exp_bytes)


def _unpack_chunk(bodies, Gs, S, win, plane_bits, exp_bytes):
    """One try of unpack_planes at one plane width: (planes, error flags),
    or None if a granule-channel overflows the planes' sideband or
    exponent range."""
    from .bitstream.native import unpack_native_into12
    n_win = -(-max(Gs) // win)
    shp = {4: 288, 8: 576, 12: 864}[plane_bits]
    dt = {4: np.uint8, 8: np.int8, 12: np.uint8}[plane_bits]
    esc_shape = {4: (80,), 8: (16, 2), 12: (16, 2)}[plane_bits]
    b = {
        "is12": np.zeros((n_win, S, win, 2, shp), dt),
        "esc": np.zeros((n_win, S, win, 2) + esc_shape,
                        np.int8 if plane_bits == 4 else np.int16),
        "exp": (np.zeros((n_win, S, win, 2, 65), np.uint8) if exp_bytes
                else np.zeros((n_win, S, win, 2, 64), np.int16)),
        "bt": np.zeros((n_win, S, win, 2), np.int8),
        "mx": np.zeros((n_win, S, win, 2), np.uint8),
        "smode": np.zeros((n_win, S, win, 64), np.uint8),
    }
    errs = [np.zeros(g, np.int16) for g in Gs]

    def one(k):
        return unpack_native_into12(
            bodies[k], Gs[k], None, b["exp"], b["bt"], b["mx"], b["smode"],
            b["is12"], b["esc"], k, S, win,
            plane_bits=plane_bits | (0x10 if exp_bytes else 0), err=errs[k])

    # streams are independent and the C call releases the GIL
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        ok = all(list(ex.map(one, range(len(bodies)))))
    return (b, errs) if ok else None


def _fast_chunk(metas, chunk, Gs, rate, gapless, out, cfg, pending_faults,
                device) -> bool:
    """Decode one chunk into `out`; False when no packed plane holds it."""
    S, win = cfg.batch_chunk_streams, cfg.window_granules
    n_win = -(-max(Gs) // win)
    got = unpack_planes([metas[i][0] for i in chunk], Gs, S, win,
                        cfg.plane_bits)
    if got is None:
        return False
    b, errs, plane_bits, exp_bytes = got
    for k, i in enumerate(chunk):  # committed by the caller
        ngr = 2 if metas[i][4] == fr.VERSION_MPEG1 else 1
        pending_faults.append((errs[k], ngr, metas[i][5]))

    state = kp.init_state(S, device=device)
    nb = 1 << max(0, n_win - 1).bit_length()  # pad windows are silence
    if plane_bits == 4 and exp_bytes:
        # one uint8 arena per window, split back into planes on the device
        dev = torch.from_numpy(kp.pack_window_arenas(b, S, win)).to(device)
        zero = torch.zeros(dev.shape[1], dtype=torch.uint8, device=device)
        arenas = [dev[w] if w < n_win else zero for w in range(nb)]
        pcm, _ = kp.decode_window_arenas_i16(arenas, state, rate, S, win)
    else:
        keys = ("is12", "esc", "exp", "bt", "mx", "smode")
        dev = {k: torch.from_numpy(b[k]).to(device) for k in keys}
        per_win = [[dev[k][w] if w < n_win else torch.zeros_like(dev[k][0])
                    for w in range(nb)] for k in keys]
        pcm, _ = kp.decode_windows_scan_i16(*per_win, state, rate,
                                            plane_bits=plane_bits)
    pcm = pcm[:, : n_win * win * 576].cpu().numpy()  # one D2H per chunk

    for k, i in enumerate(chunk):
        nch, info, n = metas[i][3], metas[i][1], Gs[k] * 576
        skip, end = 0, n
        if gapless and info.gapless:
            # bounds from the original container parse
            skip, end = gapless_bounds(n, info.encoder_delay,
                                       info.encoder_padding)
        out[i] = (pcm[k, skip:min(n, end), :nch].copy(), rate)
    return True
