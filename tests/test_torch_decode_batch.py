"""mp3tpu_torch.decode_batch on the CPU, held against mp3tpu.decode_batch
(JAX CPU backend) on the same files, and the config-3 resampled program
against the JAX one."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import mp3tpu
import mp3tpu_torch
from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch import pipeline as tpl
from mp3tpu_torch.bitstream import native
from mp3tpu_torch.config import resolve, set_active
from mp3tpu_torch.container import frames as fr
from mp3tpu_torch.kernels import pipeline as tp
from mp3tpu_torch.pipeline import (probe_granules, stream_meta, unpack_planes,
                                   window_segments)
from test_torch_decode import assert_i16_close, clip

CLIPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_clips")

requires_native = pytest.mark.skipif(not native.available(),
                                     reason="native unpacker unavailable")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@requires_native
@pytest.mark.parametrize("kinds", [("sweep", "transients", "tonal", "lsf22050",
                                    "lsf8000"),
                                   ("lame_sweep", "lame_transients", "tonal")])
def test_decode_batch_matches_jax(kinds):
    datas = [clip(k) for k in kinds]
    want = mp3tpu.decode_batch(datas)
    got = mp3tpu_torch.decode_batch(datas, device="cpu")
    assert len(got) == len(want)
    for (g, sg), (w, sw) in zip(got, want):
        assert sg == sw
        assert_i16_close(g, w)
    # the batch path agrees with the single-file path of the port
    single, _ = mp3tpu_torch.decode(datas[0], device="cpu")
    assert_i16_close(got[0][0], single)


def test_decode_batch_unported_paths_raise(tmp_path):
    """output="device", the encoder and the sharded path are ported: a wrong
    output= still raises, more processes want a coordinator, and mesh= is an
    argument of encode_batch (None: the unsharded call)."""
    handle = mp3tpu_torch.decode_batch([clip("tonal")], device="cpu",
                                       output="device")
    assert isinstance(handle, mp3tpu_torch.DecodedBatch) and len(handle) == 1
    with pytest.raises(ValueError, match="output"):
        mp3tpu_torch.decode_batch([clip("tonal")], device="cpu", output="hbm")
    with pytest.raises(ValueError, match="coordinator"):
        mp3tpu_torch.init(num_processes=2, device="cpu")
    for name in ("encode", "encode_batch", "transcode_batch"):
        assert callable(getattr(mp3tpu_torch, name))
    pcm = [0.1 * np.sin(np.arange(2000) / 7.0)]
    assert mp3tpu_torch.encode_batch(pcm, 44100, mesh=None, device="cpu") == \
        mp3tpu_torch.encode_batch(pcm, 44100, device="cpu")


@pytest.fixture
def small_config():
    """Chunks of 4 streams, windows of 16 granules, in the port's config."""
    def set_decode(**kw):
        set_active(resolve(decode={"batch_chunk_streams": 4,
                                   "window_granules": 16, **kw}))
    yield set_decode
    set_active(resolve())


@requires_native
@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_d2h_segments_bit_identical(small_config, monkeypatch, k):
    """decode.d2h_segments = K: the window loop in K segments, each copied
    to the host behind its event; the state carries through, so the PCM is
    that of one segment. 1.2 s is 6 windows of 16: K = 4 gives uneven
    segments, K = 7 more segments than windows."""
    datas = [clip("tonal"), fixtures.own_fixture("transients", seconds=1.2),
             clip("sweep"), clip("lsf22050")]
    small_config(d2h_segments=1)
    ref = mp3tpu_torch.decode_batch(datas, device="cpu")
    small_config(d2h_segments=k)
    copies = []
    real = tpl.HostCopy
    monkeypatch.setattr(tpl, "HostCopy", lambda t, **kw:
                        copies.append(t.shape[1]) or real(t, **kw))
    got = mp3tpu_torch.decode_batch(datas, device="cpu")
    # the setting is read: a chunk of 6 windows at 44.1 kHz, one of 3 at 22.05
    assert len(copies) == min(k, 6) + min(k, 3)
    assert sum(copies) == (6 + 3) * 16 * 576
    monkeypatch.undo()
    handle = mp3tpu_torch.decode_batch(datas, device="cpu", output="device")
    for (a, ra), (b, rb), (c, rc) in zip(ref, got, handle.numpy()):
        assert ra == rb == rc
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("n,k,want", [
    (24, 4, [(0, 6), (6, 12), (12, 18), (18, 24)]),
    (6, 4, [(0, 1), (1, 3), (3, 4), (4, 6)]),
    (3, 7, [(0, 1), (1, 2), (2, 3)]), (5, 1, [(0, 5)]), (1, 0, [(0, 1)])])
def test_window_segments(n, k, want):
    assert window_segments(n, k) == want


@requires_native
@pytest.mark.parametrize("plane_bits", [4, 12])
def test_no_pad_windows(small_config, monkeypatch, plane_bits):
    """_fast_chunk decodes the chunk's live windows and no power-of-two pad:
    a committed 10 s clip is 48 windows of 16 granules with no pad, so a
    prefix of it that leaves 5 live windows (8 with the pad) is decoded in
    5 steps, and its PCM is the first 5 windows' of a run padded to 8 with
    silent windows, bit for bit (the results before the repair)."""
    with open(os.path.join(CLIPS, "tonal.mp3"), "rb") as f:
        data = f.read()
    body = stream_meta(data)[0]
    frames = fr.scan_frames(np.frombuffer(body, np.uint8))
    body = body[: int(frames.offsets[40])]              # 80 granules
    G = probe_granules(body)
    assert -(-G // 16) == 5
    steps = []
    real = tp._packed_step
    monkeypatch.setattr(tp, "_packed_step",
                        lambda *a: steps.append(1) or real(*a))
    small_config(plane_bits=plane_bits)
    [(got, rate)] = mp3tpu_torch.decode_batch([body], gapless=False,
                                              device="cpu")
    assert len(steps) == 5 and got.shape == (G * 576, 2)

    planes, _errs, bits, exp_bytes = unpack_planes([body], [G], 4, 16, plane_bits)
    assert bits == plane_bits and exp_bytes
    keys = ("is12", "esc", "exp", "bt", "mx", "smode")
    per_win = [[t(planes[k][w]) if w < 5 else torch.zeros_like(t(planes[k][0]))
                for w in range(8)] for k in keys]
    padded, _ = tp.decode_windows_scan_i16(
        *per_win, tp.init_state(4, device="cpu"), rate, plane_bits=bits)
    assert len(steps) == 13 and padded.shape[1] == 8 * 16 * 576
    assert np.array_equal(got, padded[0, : G * 576].numpy())


@requires_native
def test_config3_resampled_program_matches_jax():
    """decode_all_windows_flat_resampled_i16 at S=2 (4-bit planes, 48 kHz)."""
    bodies = [stream_meta(clip(k))[0] for k in ("tonal", "transients")]
    Gs = [probe_granules(b) for b in bodies]
    planes, _errs, bits, exp_bytes = unpack_planes(bodies, Gs, 2, 32, 4)
    assert (bits, exp_bytes) == (4, True)
    keys = ("is12", "exp", "esc", "bt", "mx", "smode")
    got, st, rst = tp.decode_all_windows_flat_resampled_i16(
        *(t(planes[k]) for k in keys), tp.init_state(2, device="cpu"),
        tp.init_resample_state(2, 44100, device="cpu"), 44100, 48000, 4)
    want, sj, rsj = kp.decode_all_windows_flat_resampled_i16(
        *(jnp.asarray(planes[k]) for k in keys), kp.init_state(2),
        kp.init_resample_state(2, 44100), 44100, 48000, 4)
    assert_i16_close(got.numpy(), np.asarray(want))
    rel = np.abs(rst.numpy() - np.asarray(rsj)).max() / np.abs(np.asarray(rsj)).max()
    assert rel <= 1e-5
    assert np.abs(st["hist"].numpy() - np.asarray(sj["hist"])).max() <= \
        1e-5 * np.abs(np.asarray(sj["hist"])).max()
