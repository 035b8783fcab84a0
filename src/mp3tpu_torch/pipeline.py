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
from dataclasses import dataclass

import numpy as np
import torch

from .bitstream.unpack import SymbolTensors, unpack_fast
from .container import frames as fr
from .container.id3 import parse_id3v2
from .container.xing import StreamInfo, is_metadata_frame, parse_stream_info
from .dsp.gapless import gapless_bounds
from .kernels import pipeline as kp
from .transfer import HostCopy
from .utils.profiling import annotate, device_trace, request

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

        with annotate("mp3tpu.decode_group", lo=start, hi=start + g):
            pcm, state = kp.decode_window_group(
                prep(st.is_), prep(st.exp), prep(st.block_type),
                prep(st.mixed), prep(st.smode), state, st.sample_rate, group)
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
    lo, hi = _playable_bounds(info, st.n_granules * 576)
    env, peak = decode_envelope_device(st, with_peak=True,
                                       peak_bounds=(lo, hi), device=device)
    pk_db = 20.0 * float(np.log10(max(peak, 1e-9)))
    return loudness_db(_playable_env(env, lo, hi), ENV_HOP,
                       st.sample_rate), pk_db


def _playable_env(env, lo: int, hi: int):
    """Envelope frames fully inside the playable sample range [lo, hi)."""
    f_lo, f_hi = -(-lo // ENV_HOP), hi // ENV_HOP
    return env[f_lo:f_hi] if f_hi > f_lo else env


def _env_batch(pcm: torch.Tensor, nch: torch.Tensor, bounds: torch.Tensor):
    """Per-granule dB envelope and per-stream sample peak of int16 PCM
    [S, n, 2], n a multiple of ENV_HOP. nch float32 [S, 1] masks channel 1
    of mono streams (their power is the real channel's, whatever the decode
    left in the other). The peak is taken over bounds int [S, 2], sample
    ranges [lo, hi) on the stored timeline (the playable range); the
    envelope covers the whole timeline. -> (env_db [S, G], peak [S]
    linear)."""
    x = pcm.float() * (1.0 / 32768.0)
    m1 = (nch >= 2.0).float()                                   # [S, 1]
    p = (x[..., 0] ** 2 + x[..., 1] ** 2 * m1) / nch            # [S, n]
    e = p.reshape(p.shape[0], -1, ENV_HOP).mean(dim=2)          # [S, G]
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    m = ((idx >= bounds[:, :1]) & (idx < bounds[:, 1:2])).float()
    pk = torch.maximum((x[..., 0].abs() * m).amax(dim=1),
                       (x[..., 1].abs() * m * m1).amax(dim=1))
    return 10.0 * torch.log10(e + 1e-12), pk


@dataclass
class _DecodedStream:
    """One stream of a DecodedBatch: a row of its chunk's tensor (int16
    [S, n, 2] on the device, the same object in every record of the chunk),
    or host PCM for a stream that came through the scheduler."""
    dev: object              # torch int16 chunk tensor, or None (host record)
    row: int
    host: object             # np int16 [n, nch] when dev is None
    n: int                   # decoded samples on the stored timeline
    skip: int                # the bounds numpy() applies
    end: int
    t_lo: int                # playable (LAME tag) bounds: peak and loudness
    t_hi: int
    nch: int
    rate: int
    info: object             # StreamInfo, for shifting segments

    @property
    def chunk_key(self) -> int:
        """Names the chunk this record's PCM lies in, whatever tensor
        object (the chunk or a view of it) the record holds."""
        return self.dev.untyped_storage().data_ptr()


class DecodedBatch:
    """What decode_batch(..., output="device") returns: the decoded int16
    PCM of each chunk stays on the device as one [S, n, 2] tensor, so that
    further device stages (levels() and segments() here, or the caller's
    torch code through device_pcm()) run without a copy to the host.
    numpy() gives host PCM equal to output="pcm": the same window loop at
    the same shapes, the same trims.

    Streams that came through the scheduler (C++ unpacker off, a chunk over
    the staging budget) are host records; every method treats them alike.
    """

    def __init__(self, recs):
        self._recs = recs
        self._host_chunks: dict = {}   # chunk_key -> np int16 [S, n, 2]

    def __len__(self):
        return len(self._recs)

    @property
    def sample_rates(self):
        return [r.rate for r in self._recs]

    def device_pcm(self, i):
        """(chunk, row, lo, hi, nch) of stream i: its PCM is
        chunk[row, lo:hi, :nch], the decode's gapless bounds applied. The
        chunk comes unsliced, so that consumers gather at fixed shapes. A
        host record gives its numpy array with row 0."""
        r = self._recs[i]
        if r.dev is not None:
            return r.dev, r.row, r.skip, r.end, r.nch
        return r.host[None], 0, r.skip, r.end, r.nch

    def numpy(self, i=None):
        """Host PCM: (pcm, sample_rate) of stream i, or the list of all,
        element for element what output="pcm" returns, each an owned copy.
        A chunk is copied to the host once and kept on the handle: going
        through its streams does not copy it again."""
        if i is None:
            return [self.numpy(j) for j in range(len(self._recs))]
        r = self._recs[i]
        if r.dev is None:
            return r.host[r.skip:r.end, : r.nch].copy(), r.rate
        key = r.chunk_key
        if key not in self._host_chunks:
            self._host_chunks[key] = HostCopy(r.dev).numpy(owned=False)
        pcm = self._host_chunks[key]
        return pcm[r.row, r.skip:r.end, : r.nch].copy(), r.rate

    def _envelope(self, i, cache):
        """(env_db [G] over the stored timeline, playable peak linear) of
        stream i. A device chunk is reduced once for all its streams
        (`cache`, by chunk); a host record takes the same formula in
        numpy."""
        r = self._recs[i]
        if r.dev is None:
            x = r.host[:, : r.nch].astype(np.float32) / 32768.0
            p = (x ** 2).mean(axis=1)
            Gn = len(p) // ENV_HOP
            e = p[: Gn * ENV_HOP].reshape(Gn, ENV_HOP).mean(axis=1)
            env = (10.0 * np.log10(e + 1e-12)).astype(np.float32)
            seg = x[r.t_lo: r.t_hi]
            return env, float(np.abs(seg).max()) if seg.size else 0.0
        key = r.chunk_key
        if key not in cache:
            S = r.dev.shape[0]
            nch = np.full((S, 1), 2.0, np.float32)
            bounds = np.zeros((S, 2), np.int64)
            for rr in self._recs:
                if rr.dev is not None and rr.chunk_key == key:
                    nch[rr.row, 0] = float(rr.nch)
                    bounds[rr.row] = (rr.t_lo, rr.t_hi)
            with annotate("mp3tpu.env_batch"):
                env, pk = _env_batch(r.dev,
                                     torch.from_numpy(nch).to(r.dev.device),
                                     torch.from_numpy(bounds).to(r.dev.device))
            cache[key] = (env.cpu().numpy(), pk.cpu().numpy())
        env, pk = cache[key]
        return env[r.row], float(pk[r.row])

    def levels(self):
        """(loudness_db, peak_db) per stream from one envelope reduction per
        device chunk: only the envelope comes to the host. Peak and
        loudness are taken over the playable (gapless-trimmed) range; the
        peak is measured on the int16 PCM."""
        from .dsp.loudness import loudness_db
        cache: dict = {}
        out = []
        for i, r in enumerate(self._recs):
            env, pk = self._envelope(i, cache)
            G = min(r.n // ENV_HOP, len(env))
            out.append((loudness_db(_playable_env(env[:G], r.t_lo, r.t_hi),
                                    ENV_HOP, r.rate),
                        20.0 * float(np.log10(max(pk, 1e-9)))))
        return out

    def segments(self, gapless: bool | None = None, **kw):
        """Sentence/pause boundaries per stream (dsp/segment.py semantics at
        the fixed ENV_HOP hop): segment_batch's output, from this handle's
        PCM."""
        from .config import get_active
        from .dsp.segment import segments_from_envelope
        if gapless is None:
            gapless = get_active().decode.gapless
        cache: dict = {}
        out = []
        for i, r in enumerate(self._recs):
            kw2 = _check_seg_kw(kw, r.rate)
            env, _pk = self._envelope(i, cache)
            G = min(r.n // ENV_HOP, len(env))
            segs = segments_from_envelope(env[:G], ENV_HOP, r.rate,
                                          total=r.n, **kw2)
            out.append(_shift_segments(segs, r.n, r.rate, r.info, gapless))
        return out


def _host_rec(pcm, rate, info, gapless: bool) -> _DecodedStream:
    """A DecodedBatch record of host PCM. Where the PCM is already
    gapless-trimmed, the playable range is the whole buffer and a tagless
    StreamInfo keeps segments() from trimming twice."""
    n = len(pcm)
    if gapless and info.gapless:
        t_lo, t_hi, info = 0, n, StreamInfo()
    else:
        t_lo, t_hi = _playable_bounds(info, n)
    return _DecodedStream(dev=None, row=0, host=pcm, n=n, skip=0, end=n,
                          t_lo=t_lo, t_hi=t_hi, nch=pcm.shape[1], rate=rate,
                          info=info)


def _over_handle(paths, device, of_handle, of_file) -> list:
    """One value per file: of_handle(DecodedBatch) for the streams the fast
    path decodes (gapless=False: the handle keeps the whole timeline), and
    of_file(data) for the streams over the staging budget, which take the
    per-file envelope scan (a few KB to the host) instead of the scheduler's
    host PCM; of_file for all when the fast path takes none."""
    datas = [_read(p) for p in paths]
    res = _decode_files_fast(datas, gapless=False, device=device,
                             output="device", slow_streams="skip")
    if res is None:
        return [of_file(d) for d in datas]
    idx = [i for i, r in enumerate(res) if r is not None]
    out: list = [None] * len(datas)
    for i, v in zip(idx, of_handle(DecodedBatch([res[i] for i in idx]))):
        out[i] = v
    for i, r in enumerate(res):
        if r is None:
            out[i] = of_file(datas[i])
    return out


def track_levels_batch(paths, device="cuda") -> list:
    """track_levels of many files through the device-resident batch handle:
    one window loop and one envelope reduction per chunk; [S] loudness and
    peak values come to the host, no PCM. Peaks are measured on the int16
    PCM (at most 1 LSB below the single-file float measurement) over each
    stream's playable range."""
    return _over_handle(paths, device, lambda h: h.levels(),
                        lambda d: track_levels(d, device=device))


def segment_files(paths, gapless: bool | None = None, device="cuda", **kw):
    """segment_file of many files (indexing a library) through the
    device-resident batch handle."""
    from .config import get_active
    if gapless is None:
        gapless = get_active().decode.gapless
    return _over_handle(
        paths, device, lambda h: h.segments(gapless=gapless, **kw),
        lambda d: segment_file(d, gapless=gapless, device=device, **kw))


def split_file(path_or_bytes, out_dir, fmt: str = "wav",
               stem: str | None = None, bitrate: int | None = None,
               gapless: bool | None = None, device="cuda", **seg_kw) -> list:
    """Write each sentence/pause-delimited segment of one track to its own
    file in out_dir; returns the paths in segment order. The boundaries are
    segment_file's (one host unpack feeds the envelope scan and the
    decode). fmt="wav" writes int16 WAV clips. fmt="mp3" re-encodes all
    clips in ONE encode_batch call (bitrate defaults to the active
    EncodeConfig)."""
    from .config import get_active
    from .dsp.segment import segments_from_envelope
    if fmt not in ("wav", "mp3"):
        raise ValueError(f"fmt must be 'wav' or 'mp3', got {fmt!r}")
    cfg = get_active().decode
    if gapless is None:
        gapless = cfg.gapless
    st, info, _index = load_symbols(_read(path_or_bytes))
    sr = st.sample_rate
    kw = _check_seg_kw(seg_kw, sr)
    total = st.n_granules * 576
    segs = _shift_segments(
        segments_from_envelope(decode_envelope_device(st, device=device),
                               ENV_HOP, sr, total=total, **kw),
        total, sr, info, gapless)
    if not segs:
        return []
    pcm = decode_symbols_device(st, window=cfg.window_granules,
                                output="int16", device=device)
    if gapless and info.gapless:
        a, b = gapless_bounds(len(pcm), info.encoder_delay,
                              info.encoder_padding)
        pcm = pcm[a:b]
    if stem is None:
        stem = ("clip" if isinstance(path_or_bytes, (bytes, bytearray))
                else os.path.splitext(os.path.basename(str(path_or_bytes)))[0])
    os.makedirs(out_dir, exist_ok=True)
    clips = [pcm[int(round(a * sr)): int(round(b * sr))] for a, b in segs]
    paths = [os.path.join(out_dir, f"{stem}-{i + 1:03d}.{fmt}")
             for i in range(len(clips))]
    if fmt == "mp3":
        from .encoder import encode_batch
        kw = {} if bitrate is None else {"bitrate": bitrate}
        blobs = encode_batch([c.astype(np.float32) / 32768.0 for c in clips],
                             sr, device=device, **kw)
        for p, blob in zip(paths, blobs):
            with open(p, "wb") as f:
                f.write(blob)
    else:
        from .player.sink import WavFileSink
        for p, c in zip(paths, clips):
            snk = WavFileSink(p, sr, c.shape[1])
            snk.push(c)
            snk.close()
    return paths


def decode_file(path_or_bytes, output: str | None = None,
                gapless: bool | None = None, device="cuda"):
    """decode(path) -> (pcm, sample_rate). output "int16" or "float32";
    gapless trims the encoder delay and padding of a LAME tag. Unset
    arguments come from the port's active Config (config.py). The device
    windows run under utils.profiling's annotations; MP3TPU_TRACE_DIR wraps
    them in a torch.profiler trace."""
    from .config import get_active
    cfg = get_active().decode
    output = cfg.output if output is None else output
    gapless = cfg.gapless if gapless is None else gapless
    st, info, _index = load_symbols(_read(path_or_bytes))
    with device_trace():  # a trace only where MP3TPU_TRACE_DIR is set
        pcm = decode_symbols_device(st, window=cfg.window_granules,
                                    output=output, device=device)
    if gapless and info.gapless:
        a, b = gapless_bounds(len(pcm), info.encoder_delay, info.encoder_padding)
        pcm = pcm[a:b]
    return pcm, st.sample_rate


def decode_files(paths, gapless: bool = True, output: str = "pcm",
                 device="cuda"):
    """Batched multi-stream decode. output="pcm" returns [(pcm int16 [n, ch],
    sample_rate)], aligned with the inputs and trimmed as decode_file trims.
    output="device" returns a DecodedBatch instead: each chunk's int16 PCM
    stays on `device` as one [S, n, 2] tensor, for levels(), segments() or
    the caller's own torch code (device_pcm()), and comes to the host only
    through numpy().

    The C++ unpacker's packed planes feed fixed-shape windows (the fast
    path); a batch it cannot take goes to the scheduler, and a handle then
    carries host records that behave the same."""
    if output not in ("pcm", "device"):
        raise ValueError(f'output must be "pcm" or "device", got {output!r}')
    paths = list(paths)
    with request("mp3tpu.decode_files", len(paths)):
        datas = [_read(p) for p in paths]
        fast = _decode_files_fast(datas, gapless, device, output=output)
        if fast is not None:
            return DecodedBatch(fast) if output == "device" else fast
        from .player.scheduler import decode_batch_streams
        if output != "device":
            return decode_batch_streams(datas, gapless=gapless, device=device)
        res, infos = decode_batch_streams(datas, gapless=gapless,
                                          device=device, return_info=True)
        return DecodedBatch([_host_rec(pcm, rate, info, gapless)
                             for info, (pcm, rate) in zip(infos, res)])


def _decode_files_fast(datas, gapless: bool, device, output: str = "pcm",
                       slow_streams: str = "decode"):
    """C++ unpack of every stream into window-major packed planes (4-bit
    spectrum + two-level escape sideband + byte exponents, widened on
    overflow), length-sorted chunks of batch_chunk_streams streams,
    fixed-shape windows on the device. Returns the results ((pcm, rate), or
    _DecodedStream records for output="device"), or None when the batch
    needs the scheduler whole: the C++ unpacker off or missing, a stream it
    cannot take, or a chunk no packed plane holds.

    Chunks over decode.batch_max_mb go to the scheduler (slow_streams=
    "decode"; host records in a handle), or keep None in their slots
    (slow_streams="skip") for callers that want only an envelope of them and
    take it per file."""
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
    with annotate("mp3tpu.probe_granules", len(metas)):
        G_all = [probe_granules(m[0]) for m in metas]
    if min(G_all, default=1) <= 0:
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
            # the JAX package's estimate, its power-of-two bucket of
            # windows included, so that the same chunks count as over
            # budget in both packages; the port decodes n_win windows
            nb = 1 << max(0, n_win - 1).bit_length()
            est_mb = S * (n_win * win * 934 + nb * win * 2304) / 1e6
            if est_mb > cfg.batch_max_mb:
                slow.extend(chunk)
                continue
            if not _fast_chunk(metas, chunk, [G_all[i] for i in chunk], rate,
                               gapless, out, cfg, pending_faults, device,
                               output):
                return None
    # fault books commit only once every chunk has decoded, in both output
    # modes: a batch that goes to the scheduler whole keeps the scheduler's
    # books alone
    from .metrics import record_resyncs, record_symbol_errors
    for errs, ngr, nrs in pending_faults:
        record_symbol_errors(errs, ngr)
        record_resyncs(nrs)
    if slow and slow_streams != "skip":
        from .player.scheduler import decode_batch_streams
        res = decode_batch_streams([datas[i] for i in slow], gapless=gapless,
                                   device=device)
        for i, (pcm, rrate) in zip(slow, res):
            out[i] = (_host_rec(pcm, rrate, metas[i][1], gapless)
                      if output == "device" else (pcm, rrate))
    return out


def stream_meta(data: bytes):
    """(audio body, StreamInfo, sample_rate, channels, version, resyncs) of
    one stream; the body lacks ID3v2 and a leading metadata frame. None
    when the metadata frame's bytes cannot be dropped exactly."""
    with annotate("mp3tpu.scan", 1):
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
    with annotate("mp3tpu.unpack", len(bodies)):
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
    with annotate("mp3tpu.unpack.pass", len(bodies), plane_bits=plane_bits,
                  exp_bytes=exp_bytes) as sp:
        with annotate("mp3tpu.unpack.alloc"):
            b = plane_buffers(-(-max(Gs) // win), S, win, plane_bits,
                              exp_bytes)
        with annotate("mp3tpu.unpack.run"):
            errs = unpack_into(b, bodies, Gs, S, win, plane_bits, exp_bytes)
        sp.outcome = "overflow" if errs is None else "ok"
    return None if errs is None else (b, errs)


def plane_buffers(n_win: int, S: int, win: int, plane_bits: int,
                  exp_bytes: bool) -> dict:
    """Zeroed host planes [n_win, S, win, ...] of one plane family."""
    shp = {4: 288, 8: 576, 12: 864}[plane_bits]
    dt = {4: np.uint8, 8: np.int8, 12: np.uint8}[plane_bits]
    esc_shape = {4: (80,), 8: (16, 2), 12: (16, 2)}[plane_bits]
    return {
        "is12": np.zeros((n_win, S, win, 2, shp), dt),
        "esc": np.zeros((n_win, S, win, 2) + esc_shape,
                        np.int8 if plane_bits == 4 else np.int16),
        "exp": (np.zeros((n_win, S, win, 2, 65), np.uint8) if exp_bytes
                else np.zeros((n_win, S, win, 2, 64), np.int16)),
        "bt": np.zeros((n_win, S, win, 2), np.int8),
        "mx": np.zeros((n_win, S, win, 2), np.uint8),
        "smode": np.zeros((n_win, S, win, 64), np.uint8),
    }


def unpack_into(b: dict, bodies, Gs, S, win, plane_bits, exp_bytes):
    """C++ unpack of the streams into zeroed planes b (plane_buffers' shapes
    for this family), one thread a stream: the per-stream error flags, or
    None if a granule-channel overflows the planes' sideband or exponent
    range."""
    from .bitstream.native import unpack_native_into12
    errs = [np.zeros(g, np.int16) for g in Gs]

    def one(k):
        return unpack_native_into12(
            bodies[k], Gs[k], None, b["exp"], b["bt"], b["mx"], b["smode"],
            b["is12"], b["esc"], k, S, win,
            plane_bits=plane_bits | (0x10 if exp_bytes else 0), err=errs[k])

    # streams are independent and the C call releases the GIL
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        ok = all(list(ex.map(one, range(len(bodies)))))
    return errs if ok else None


def window_segments(n: int, k: int) -> list:
    """[(lo, hi)] of at most k contiguous, near-equal, non-empty segments
    of range(n)."""
    k = max(1, min(int(k), n))
    edges = [n * j // k for j in range(k + 1)]
    return list(zip(edges, edges[1:]))


def _slice_parts(parts, row: int, lo: int, hi: int, nch: int) -> np.ndarray:
    """An owned copy of samples [lo, hi) of `row`, first nch channels, out
    of PCM held as [(sample offset, int16 [S, n, 2])] segments in order."""
    got = [p[row, max(lo - off, 0): hi - off, :nch] for off, p in parts
           if off < hi and off + p.shape[1] > lo]
    return (np.concatenate(got, axis=0) if got
            else np.zeros((0, nch), np.int16))


def _playable_bounds(info, n: int) -> tuple:
    """The playable sample range of a stream of n decoded samples: the LAME
    tag's, where there is one."""
    if not info.gapless:
        return 0, n
    lo, hi = gapless_bounds(n, info.encoder_delay, info.encoder_padding)
    return lo, min(hi, n)


def _fast_chunk(metas, chunk, Gs, rate, gapless, out, cfg, pending_faults,
                device, output: str = "pcm") -> bool:
    """Decode one chunk into `out`; False when no packed plane holds it.
    Only the chunk's n_win live windows are decoded. output="pcm": the
    window loop runs in decode.d2h_segments contiguous segments, and each
    segment's int16 PCM starts its copy to pinned host memory on the copy
    stream while the next segment decodes; the state carries through, so
    the PCM does not depend on the number of segments. output="device":
    the PCM stays on the device, one tensor that every record of the chunk
    shares."""
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

    if plane_bits == 4 and exp_bytes:
        # one uint8 arena per window, split back into planes on the device
        with annotate("mp3tpu.stage"):
            arenas = torch.from_numpy(
                kp.pack_window_arenas(b, S, win)).to(device)

        def scan(lo, hi, state):
            return kp.decode_window_arenas_i16(
                [arenas[w] for w in range(lo, hi)], state, rate, S, win)
    else:
        keys = ("is12", "esc", "exp", "bt", "mx", "smode")
        with annotate("mp3tpu.stage"):
            dev = {k: torch.from_numpy(b[k]).to(device) for k in keys}

        def scan(lo, hi, state):
            return kp.decode_windows_scan_i16(
                *([dev[k][w] for w in range(lo, hi)] for k in keys), state,
                rate, plane_bits=plane_bits)

    state = kp.init_state(S, device=device)
    if output == "device":
        with annotate("mp3tpu.decode_chunk", lo=0, hi=n_win):
            pcm_dev, _ = scan(0, n_win, state)
        with annotate("mp3tpu.device_records", len(chunk)):
            for k, i in enumerate(chunk):
                info, n = metas[i][1], Gs[k] * 576
                t_lo, t_hi = _playable_bounds(info, n)
                skip, end = (t_lo, t_hi) if gapless else (0, n)
                out[i] = _DecodedStream(
                    dev=pcm_dev, row=k, host=None, n=n, skip=skip, end=end,
                    t_lo=t_lo, t_hi=t_hi, nch=metas[i][3], rate=rate,
                    info=info)
        return True

    copies = []
    for lo, hi in window_segments(n_win, cfg.d2h_segments):
        with annotate("mp3tpu.decode_chunk", lo=lo, hi=hi):
            pcm_j, state = scan(lo, hi, state)
        with annotate("mp3tpu.d2h.start",
                      pcm_j.numel() * pcm_j.element_size()):
            copies.append((lo * win * 576, HostCopy(pcm_j, overlap=True)))
    parts = []
    for off, c in copies:
        with annotate("mp3tpu.d2h.wait"):
            parts.append((off, c.numpy(owned=False)))
    with annotate("mp3tpu.slice") as sp:
        nbytes = 0
        for k, i in enumerate(chunk):
            # bounds from the original container parse
            n = Gs[k] * 576
            skip, end = (_playable_bounds(metas[i][1], n) if gapless
                         else (0, n))
            pcm = _slice_parts(parts, k, skip, end, metas[i][3])
            nbytes += pcm.nbytes
            out[i] = (pcm, rate)
        sp.items = nbytes
    return True


def decode_symbols_chunked(st: SymbolTensors, chunk_granules: int = 128,
                           halo: int = 2, output: str = "float32",
                           device="cuda") -> np.ndarray:
    """Sequence-parallel decode of one long stream. The overlap-add couples
    a granule with the one before it and the synthesis FIR reads 15 earlier
    steps, both inside a 2-granule halo: so the stream is decoded as a batch
    of ceil(G / chunk_granules) independent rows, each led by `halo`
    granules whose output is dropped, in one call of the granule chain
    ([S, halo + chunk_granules] granules, one kernel launch) and no window
    loop. output="int16" quantizes on the device and brings a quarter of
    the bytes to the host. Within 1 LSB of decode_file, as every path.

    decode.d2h_segments_single = K > 1 splits the rows into K calls (they
    are independent) and starts each one's copy to the host on the copy
    stream while the next decodes; rows that do not split evenly, or fewer
    than 2K, take the single call."""
    from .config import get_active
    G = st.n_granules
    S = max(1, -(-G // chunk_granules))
    W = halo + chunk_granules
    # row c holds granules [c * chunk_granules - halo, (c + 1) * chunk_granules)
    g = (np.arange(S)[:, None] * chunk_granules - halo) + np.arange(W)[None, :]
    valid = (g >= 0) & (g < G)

    def gather(a):
        rows = np.zeros((S, W) + a.shape[1:], a.dtype)
        rows[valid] = a[g[valid]]
        return torch.from_numpy(rows).to(device)

    fn = kp.decode_window_i16 if output == "int16" else kp.decode_window
    args = [gather(a) for a in (st.is_, st.exp, st.block_type, st.mixed,
                                st.smode)]
    segs = max(1, int(get_active().decode.d2h_segments_single))
    if not (segs > 1 and S >= 2 * segs and S % segs == 0):
        segs = 1
    copies = []
    for lo, hi in window_segments(S, segs):
        with annotate("mp3tpu.decode_chunked", lo=lo, hi=hi):
            p, _ = fn(*(a[lo:hi] for a in args),
                      kp.init_state(hi - lo, device=device), st.sample_rate)
        copies.append(HostCopy(p[:, halo * 576:].contiguous(), overlap=True))
    pcm = np.concatenate([c.numpy(owned=False) for c in copies], axis=0)
    out = pcm.reshape(S * chunk_granules * 576, 2)[: G * 576]
    return out[:, : st.channels]
