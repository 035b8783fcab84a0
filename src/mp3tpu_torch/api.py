"""Public API of the PyTorch port: the decode, playback and analysis entry
points of mp3tpu.api. The encoder's three (encode, encode_batch,
transcode_batch) come with the encoder.

Each takes `device` ("cuda" by default; "cpu" runs the plain versions of the
kernels) and otherwise the arguments of its mp3tpu counterpart.
"""
from __future__ import annotations


def init(config=None, sample_rates=(44100,), n_streams: int = 1,
         distributed_coordinator: str | None = None,
         num_processes: int | None = None, process_id: int | None = None,
         device="cuda"):
    """Bring-up: make `config` (default: config.resolve()) the active
    config, build the tables of each sample rate on `device`, and run the
    decode once on zeros at the shapes the entry points use: the
    single-stream group of windows that decode and the player run and, for
    n_streams > 1, the scheduler's [n_streams, window] step. On the card
    this is where the one-off costs are paid instead of in the first real
    decode: the nvcc build of the kernels and the g++ build of the C++
    unpacker (both cached under build/mp3tpu_torch/ afterwards), the CUDA
    context, cuBLAS's handles and the first launches.

    The distributed_* arguments are accepted as the JAX package accepts
    them: with one process they do nothing; more than one is the sharded
    path, which is not ported yet. Returns the config."""
    import torch
    from .config import resolve, set_active
    from .kernels import pipeline as kp
    from .pipeline import GROUP_WINDOWS, _native_lib
    if num_processes not in (None, 1):
        raise NotImplementedError(
            f"init(num_processes={num_processes}): the multi-process path "
            "(parallel/) is not ported yet (ROADMAP Queue 1 item 9)")
    cfg = config if config is not None else resolve()
    set_active(cfg)  # decode/player/scheduler defaults now come from cfg
    if cfg.decode.use_native:
        _native_lib()

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    W, S = cfg.decode.window_granules, max(n_streams, 1)
    GW = W * GROUP_WINDOWS
    for sr in sample_rates:
        kp.decode_window_group(
            zeros((1, GW, 2, 576), torch.int16), zeros((1, GW, 2, 64), torch.int16),
            zeros((1, GW, 2), torch.int8), zeros((1, GW, 2), torch.bool),
            zeros((1, GW, 64), torch.uint8), kp.init_state(1, device=device),
            sr, GROUP_WINDOWS)
        if S > 1:  # the scheduler's masked-batch step
            kp.decode_window_i16(
                zeros((S, W, 2, 576), torch.int16), zeros((S, W, 2, 64), torch.int16),
                zeros((S, W, 2), torch.int8), zeros((S, W, 2), torch.bool),
                zeros((S, W, 64), torch.uint8), kp.init_state(S, device=device),
                sr)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return cfg


def decode(path_or_bytes, device="cuda", **kw):
    """One file -> (pcm [n, ch], sample_rate); output="int16" (default) or
    "float32", gapless=True trims by the LAME tag."""
    from .pipeline import decode_file
    return decode_file(path_or_bytes, device=device, **kw)


def decode_batch(paths, device="cuda", **kw):
    """Many files, batched on the device -> [(pcm int16 [n, ch],
    sample_rate), ...] aligned with the inputs; output="device" returns a
    DecodedBatch whose int16 PCM stays on the device for further device
    stages (levels, segments, the caller's torch code) and comes to the
    host through .numpy()."""
    from .pipeline import decode_files
    return decode_files(paths, device=device, **kw)


def segment(path_or_bytes, device="cuda", **kw):
    """Sentence/pause boundaries [(start_s, end_s), ...] of one file, from
    an envelope reduced on the device."""
    from .pipeline import segment_file
    return segment_file(path_or_bytes, device=device, **kw)


def segment_batch(paths, device="cuda", **kw):
    """segment() of many files through the device-resident batch decode."""
    from .pipeline import segment_files
    return segment_files(paths, device=device, **kw)


def split(path_or_bytes, out_dir, fmt: str = "wav", device="cuda",
          **kw) -> list:
    """Write each sentence of a track to its own WAV clip; returns the
    paths. fmt="mp3" waits on the encoder and raises NotImplementedError."""
    from .pipeline import split_file
    return split_file(path_or_bytes, out_dir, fmt=fmt, device=device, **kw)


def loudness(path_or_bytes, device="cuda") -> float:
    """Track loudness in dB (ReplayGain-style statistic) from the device
    envelope."""
    from .pipeline import loudness_file
    return loudness_file(path_or_bytes, device=device)


def levels(path_or_bytes, device="cuda") -> tuple:
    """(loudness_db, peak_db) from one device envelope scan: what a
    normalizing queue measures per track."""
    from .pipeline import track_levels
    return track_levels(path_or_bytes, device=device)


def levels_batch(paths, device="cuda") -> list:
    """levels() of many files through the device-resident batch decode: no
    PCM comes to the host."""
    from .pipeline import track_levels_batch
    return track_levels_batch(paths, device=device)


def global_metrics():
    """The process-wide counters: every decode path (decode, decode_batch,
    the scheduler, the player) feeds this Metrics beside its own, so the
    fault family (frames_ok, frames_error, granules_muted, resyncs,
    underruns) covers all that this process decoded with the port.
    .log_line() gives it as one JSON line."""
    from .metrics import GLOBAL
    return GLOBAL


def play(path_or_bytes, sink=None, device="cuda", **kw):
    """Open a playback session: a Player with play/seek/loop/stop/snapshot,
    decoding to `sink` (default: an in-memory CollectSink)."""
    from .player import Player
    return Player(path_or_bytes, sink=sink, device=device, **kw)
