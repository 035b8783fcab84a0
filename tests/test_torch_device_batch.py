"""The device-resident batch handle of the PyTorch port on the CPU:
mp3tpu_torch.decode_batch(..., output="device") -> DecodedBatch, and
levels_batch / segment_batch / split over it, held against the port's own
output="pcm" (bit for bit) and against the JAX package on the same bytes.
Small streams, chunks of 4 streams, windows of 16 granules, one torch thread
(test_torch_decode sets it)."""
import contextlib
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

import fixtures
import mp3tpu
import mp3tpu_torch
from mp3tpu import config as jax_config
from mp3tpu_torch import config as port_config
from mp3tpu_torch import metrics as port_metrics
from mp3tpu_torch import pipeline as tpl
from mp3tpu_torch.bitstream import native
from test_torch_decode import assert_i16_close  # noqa: F401  (one thread)

jax_pipeline = importlib.import_module("mp3tpu.pipeline")
requires_native = pytest.mark.skipif(not native.available(),
                                     reason="native unpacker unavailable")
SMALL = {"batch_chunk_streams": 4, "window_granules": 16}
HOP_S = 576 / 44100.0
# levels of the two packages on the same streams: the same formula in
# float32 on PCM that differs by at most 1 LSB in under 2% of the samples
LEVEL_TOL_DB = 0.05
BOOKS = ("frames_ok", "frames_error", "granules_muted", "resyncs")


@contextlib.contextmanager
def both_configs(**decode):
    """The same decode settings in both packages' active configs."""
    jax_config.set_active(jax_config.resolve(decode=decode))
    port_config.set_active(port_config.resolve(decode=decode))
    try:
        yield
    finally:
        jax_config.set_active(jax_config.resolve())
        port_config.set_active(port_config.resolve())


@pytest.fixture(scope="module")
def streams():
    """Stereo and mono at 44.1 kHz (one chunk of 4 and one of 2), bursts with
    pauses, and an MPEG-2 rate (a chunk of its own)."""
    from mp3tpu.encoder import encode_pcm
    return [
        fixtures.own_fixture("tonal"),
        encode_pcm(fixtures.tone_sweep(1.0, 44100, 1), 44100, bitrate=96),
        encode_pcm(fixtures.bursts(2.0, 44100, 2), 44100),
        fixtures.own_fixture("transients", seconds=1.2),
        fixtures.lsf_fixture(22050),
        fixtures.own_fixture("sweep"),
    ]


@pytest.fixture(scope="module")
def loud_tail_mp3():
    """A quiet second whose last 2205 samples are a full-scale burst, with
    the LAME tag rewritten to call that tail encoder padding: the burst is
    on the decoded timeline and not playable (tests/test_device_batch.py)."""
    from mp3tpu.encoder import encode_pcm
    sr = 44100
    t = np.arange(sr) / sr
    sig = 0.08 * np.sin(2 * np.pi * 440 * t)
    sig[-2205:] = 0.95 * np.sin(2 * np.pi * 1000 * t[:2205])
    mp3 = encode_pcm(np.stack([sig, sig], 1), sr, bitrate=128)
    i = mp3.find(b"LAME3.100")
    assert i > 0
    v = int.from_bytes(mp3[i + 21:i + 24], "big")
    v = (v & ~0xFFF) | 4095
    return mp3[:i + 21] + v.to_bytes(3, "big") + mp3[i + 24:]


def assert_levels_close(got, want, tol=LEVEL_TOL_DB):
    assert len(got) == len(want)
    for (ld, pk), (ld1, pk1) in zip(got, want):
        assert abs(ld - ld1) <= tol, (ld, ld1)
        assert abs(pk - pk1) <= tol, (pk, pk1)


def assert_segments_close(got, want, sr=44100):
    """Equal in count, each boundary within one envelope hop."""
    assert len(got) == len(want)
    for (a, b), (a1, b1) in zip(got, want):
        assert abs(a - a1) <= 576 / sr and abs(b - b1) <= 576 / sr


@requires_native
@pytest.mark.parametrize("gapless", [True, False])
def test_handle_numpy_matches_pcm(streams, gapless):
    """Bit for bit the port's output="pcm" (the same window loop, the same
    trims), and within 1 LSB, at least 98% exact, of the JAX handle."""
    with both_configs(**SMALL):
        ref = mp3tpu_torch.decode_batch(streams, gapless=gapless, device="cpu")
        handle = mp3tpu_torch.decode_batch(streams, gapless=gapless,
                                           device="cpu", output="device")
        want = mp3tpu.decode_batch(streams, gapless=gapless,
                                   output="device").numpy()
    assert isinstance(handle, mp3tpu_torch.DecodedBatch)
    assert len(handle) == len(streams)
    assert handle.sample_rates == [r for _, r in ref]
    got = handle.numpy()
    for (p0, r0), (p1, r1), (pj, rj) in zip(ref, got, want):
        assert r0 == r1 == rj
        assert np.array_equal(p0, p1)
        assert_i16_close(p1, pj)
    p, r = handle.numpy(1)
    assert np.array_equal(p, ref[1][0]) and r == ref[1][1]


@requires_native
def test_handle_device_residency(streams):
    """device_pcm gives (chunk, row, lo, hi, nch): one torch tensor shared by
    all records of a chunk, and chunk[row, lo:hi, :nch] is the stream."""
    with both_configs(**SMALL):
        handle = mp3tpu_torch.decode_batch(streams, device="cpu",
                                           output="device")
    chunks = {}
    for i in range(len(handle)):
        chunk, row, lo, hi, nch = handle.device_pcm(i)
        assert isinstance(chunk, torch.Tensor) and chunk.dtype == torch.int16
        assert chunk.shape[0] == 4 and chunk.shape[2] == 2
        assert chunk.shape[1] % (16 * 576) == 0      # whole live windows
        assert hi > lo and nch in (1, 2)
        chunks.setdefault(id(chunk), []).append(row)
        assert np.array_equal(chunk[row, lo:hi, :nch].numpy(),
                              handle.numpy(i)[0])
    # 5 streams at 44.1 kHz in chunks of 4 and 1, one at 22.05 kHz
    assert sorted(len(r) for r in chunks.values()) == [1, 1, 4]
    assert all(sorted(r) == list(range(len(r))) for r in chunks.values())


@requires_native
def test_numpy_copies_each_chunk_once(streams, monkeypatch):
    """Going through the streams copies each chunk to the host once."""
    made = []
    real = tpl.HostCopy

    def spy(t, **kw):
        made.append(tuple(t.shape))
        return real(t, **kw)

    with both_configs(**SMALL):
        handle = mp3tpu_torch.decode_batch(streams, device="cpu",
                                           output="device")
    monkeypatch.setattr(tpl, "HostCopy", spy)
    handle.numpy()
    handle.numpy()
    for i in range(len(handle)):
        handle.numpy(i)
    assert len(made) == 3


@requires_native
@pytest.mark.parametrize("views", [False, True])
def test_envelope_reduced_once_per_chunk(streams, monkeypatch, views):
    """levels() and segments() reduce each chunk once, also where every
    record holds its own view of the chunk."""
    with both_configs(**SMALL):
        handle = mp3tpu_torch.decode_batch(streams, device="cpu",
                                           output="device")
    want = handle.levels()
    if views:
        handle = tpl.DecodedBatch([dataclasses.replace(r, dev=r.dev[:])
                                   for r in handle._recs])
        assert len({id(r.dev) for r in handle._recs}) == len(streams)
    calls = []
    real = tpl._env_batch
    monkeypatch.setattr(tpl, "_env_batch",
                        lambda *a: calls.append(1) or real(*a))
    assert handle.levels() == want
    assert len(calls) == 3
    handle.segments()
    assert len(calls) == 6


@requires_native
def test_levels_match_jax_and_single(streams):
    with both_configs(**SMALL):
        got = mp3tpu_torch.decode_batch(streams, gapless=False, device="cpu",
                                        output="device").levels()
        want = mp3tpu.decode_batch(streams, gapless=False,
                                   output="device").levels()
        assert_levels_close(got, want)
        assert_levels_close(mp3tpu_torch.levels_batch(streams, device="cpu"),
                            mp3tpu.levels_batch(streams))
        # the trim does not move the levels: they are the playable range's
        trimmed = mp3tpu_torch.decode_batch(streams, gapless=True,
                                            device="cpu",
                                            output="device").levels()
    assert trimmed == got
    for mp3, (ld, pk) in zip(streams, got):
        ld1, pk1 = mp3tpu_torch.levels(mp3, device="cpu")
        assert abs(ld - ld1) < 0.6, (ld, ld1)
        # batch peaks are of the int16 PCM, clamped at full scale, single
        # peaks of float32: compare below 0 dBFS, as normalization does
        assert abs(min(pk, 0.0) - min(pk1, 0.0)) < 0.3, (pk, pk1)


@requires_native
def test_mono_stream_in_stereo_chunk(streams):
    """Channel 1 of a mono stream's row does not count."""
    mono = streams[1]
    with both_configs(**SMALL):
        handle = mp3tpu_torch.decode_batch(streams[:4], gapless=False,
                                           device="cpu", output="device")
        chunk, row, lo, hi, nch = handle.device_pcm(1)
        assert nch == 1 and handle.numpy(1)[0].shape[1] == 1
        want = handle.levels()[1]
        chunk[row, :, 1] = 12345  # whatever the decode left there
        assert handle.levels()[1] == want
    ld1, pk1 = mp3tpu_torch.levels(mono, device="cpu")
    assert abs(want[0] - ld1) < 0.6 and abs(want[1] - pk1) < 0.3


@requires_native
@pytest.mark.parametrize("gapless", [True, False])
def test_segments_match_jax_and_single(streams, gapless):
    with both_configs(**SMALL):
        got = mp3tpu_torch.decode_batch(streams, gapless=False, device="cpu",
                                        output="device").segments(gapless=gapless)
        want = mp3tpu.decode_batch(streams, gapless=False,
                                   output="device").segments(gapless=gapless)
        batch = mp3tpu_torch.segment_batch(streams, gapless=gapless,
                                           device="cpu")
        want_batch = mp3tpu.segment_batch(streams, gapless=gapless)
    assert len(got[2]) == 3                      # the bursts
    for g, w, b, wb, mp3 in zip(got, want, batch, want_batch, streams):
        assert_segments_close(g, w)
        assert_segments_close(b, wb)
        assert b == g
        assert_segments_close(g, mp3tpu_torch.segment(mp3, gapless=gapless,
                                                      device="cpu"))


def test_host_record_route(streams):
    """With the C++ unpacker off the handle holds the scheduler's host PCM,
    and every method behaves as on the fast route."""
    with both_configs(**SMALL):
        fast = mp3tpu_torch.decode_batch(streams, device="cpu", output="device")
        fast_levels, fast_segs = fast.levels(), fast.segments()
    with both_configs(use_native=False, **SMALL):
        ref = mp3tpu_torch.decode_batch(streams, device="cpu")
        handle = mp3tpu_torch.decode_batch(streams, device="cpu",
                                           output="device")
        want = mp3tpu.decode_batch(streams, output="device")
        assert_levels_close(handle.levels(), want.levels())
        for g, w in zip(handle.segments(), want.segments()):
            assert_segments_close(g, w)
    for i, ((p0, r0), (p1, r1)) in enumerate(zip(ref, handle.numpy())):
        assert r0 == r1 and np.array_equal(p0, p1)
        arr, row, lo, hi, nch = handle.device_pcm(i)
        assert isinstance(arr, np.ndarray) and row == 0
        assert np.array_equal(arr[row, lo:hi, :nch], p0)
    if native.available():
        # the scheduler's PCM is trimmed: the tail outside the playable
        # range is not in the loudness frames, the peak is the same
        for (ld, pk), (ld1, pk1) in zip(handle.levels(), fast_levels):
            assert abs(ld - ld1) < 0.6 and abs(pk - pk1) < 0.3
        for g, w in zip(handle.segments(), fast_segs):
            assert_segments_close(g, w)


@pytest.mark.parametrize("use_native", [True, False])
def test_numpy_returns_owned_copy(streams, use_native):
    """Changing a result does not change the handle's PCM."""
    if use_native and not native.available():
        pytest.skip("native unpacker unavailable")
    with both_configs(use_native=use_native, **SMALL):
        handle = mp3tpu_torch.decode_batch(streams[:2], device="cpu",
                                           output="device")
    p0, _ = handle.numpy(0)
    orig = p0.copy()
    p0[:] = 0
    p1, _ = handle.numpy(0)
    assert np.array_equal(p1, orig) and np.abs(orig).max() > 0


@requires_native
def test_over_budget_streams(streams, monkeypatch):
    """Chunks over batch_max_mb: decode_batch's handle takes the scheduler's
    host records; levels_batch and segment_batch take the per-file envelope
    scan and decode no PCM for the host."""
    with both_configs(**SMALL):
        ref = mp3tpu_torch.decode_batch(streams, device="cpu")
        ref_lv = mp3tpu_torch.levels_batch(streams, device="cpu")
        ref_sg = mp3tpu_torch.segment_batch(streams, device="cpu")
    per_file = []
    real = tpl.track_levels
    monkeypatch.setattr(tpl, "track_levels", lambda d, **kw:
                        per_file.append(1) or real(d, **kw))
    from mp3tpu_torch.player import scheduler
    monkeypatch.setattr(scheduler, "decode_batch_streams", None)
    with both_configs(batch_max_mb=0, **SMALL):
        got_lv = mp3tpu_torch.levels_batch(streams, device="cpu")
        got_sg = mp3tpu_torch.segment_batch(streams, device="cpu")
        want_lv = mp3tpu.levels_batch(streams)
    assert len(per_file) == len(streams)
    assert_levels_close(got_lv, want_lv)
    for (l0, p0), (l1, p1) in zip(ref_lv, got_lv):
        assert abs(l0 - l1) < 0.6
        assert abs(min(p0, 0.0) - min(p1, 0.0)) < 0.3
    for g, w in zip(got_sg, ref_sg):
        assert_segments_close(g, w)
    monkeypatch.undo()
    with both_configs(batch_max_mb=0, **SMALL):
        handle = mp3tpu_torch.decode_batch(streams, device="cpu",
                                           output="device")
    assert all(r.dev is None for r in handle._recs)
    for (p0, r0), (p1, r1) in zip(ref, handle.numpy()):
        assert r0 == r1
        assert_i16_close(p0, p1)


@requires_native
def test_hop_s_checked_and_kwargs_kept(streams):
    kw = {"hop_s": HOP_S}
    with both_configs(**SMALL):
        res = mp3tpu_torch.segment_batch(streams[:3], device="cpu", **kw)
        assert kw == {"hop_s": HOP_S}
        assert res == mp3tpu_torch.segment_batch(streams[:3], device="cpu")
        with pytest.raises(ValueError, match="fixed 576-sample"):
            mp3tpu_torch.segment_batch(streams[:3], device="cpu", hop_s=0.02)
        # 576 samples are another time at 22.05 kHz: the same kwargs are
        # checked against every stream's rate
        with pytest.raises(ValueError, match="22050 Hz"):
            mp3tpu_torch.segment_batch(streams, device="cpu", **kw)
        handle = mp3tpu_torch.decode_batch(streams[:1], device="cpu",
                                           output="device")
        with pytest.raises(ValueError, match="hop_s"):
            handle.segments(hop_s=0.02)


@requires_native
def test_playable_peak_excludes_trimmed_tail(loud_tail_mp3):
    (ld_b, pk_b), = mp3tpu_torch.levels_batch([loud_tail_mp3], device="cpu")
    ld_s, pk_s = mp3tpu_torch.levels(loud_tail_mp3, device="cpu")
    (ld_j, pk_j), = mp3tpu.levels_batch([loud_tail_mp3])
    assert abs(pk_b - pk_s) < 0.3 and abs(ld_b - ld_s) < 0.6
    assert abs(pk_b - pk_j) <= LEVEL_TOL_DB and abs(ld_b - ld_j) <= LEVEL_TOL_DB
    full = mp3tpu_torch.decode(loud_tail_mp3, output="float32", gapless=False,
                               device="cpu")[0]
    assert 20 * np.log10(np.abs(full).max()) > pk_b + 10.0
    # a handle of trimmed PCM (gapless=True) masks on the same timeline
    (_, pk_t), = mp3tpu_torch.decode_batch([loud_tail_mp3], device="cpu",
                                           output="device").levels()
    assert pk_t == pk_b


def books_of(fn):
    before = dict(port_metrics.GLOBAL.to_dict())
    out = fn()
    after = port_metrics.GLOBAL.to_dict()
    return out, {k: after[k] - before.get(k, 0) for k in BOOKS}


@requires_native
def test_fault_books_commit_once(streams, monkeypatch):
    """Both output modes book the same faults, once; a batch whose second
    chunk no plane holds goes to the scheduler whole and keeps the
    scheduler's books alone."""
    bad = bytearray(streams[0])
    bad[len(bad) // 2: len(bad) // 2 + 40] = os.urandom(40)
    datas = [bytes(bad)] + list(streams[1:])
    with both_configs(**SMALL):
        _, pcm_books = books_of(
            lambda: mp3tpu_torch.decode_batch(datas, device="cpu"))
        _, dev_books = books_of(
            lambda: mp3tpu_torch.decode_batch(datas, device="cpu",
                                              output="device"))
        assert dev_books == pcm_books and pcm_books["frames_ok"] > 0
        calls = []
        real = tpl.unpack_planes

        def second_fails(*a, **kw):
            calls.append(1)
            return real(*a, **kw) if len(calls) == 1 else None

        monkeypatch.setattr(tpl, "unpack_planes", second_fails)
        handle, fallback_books = books_of(
            lambda: mp3tpu_torch.decode_batch(datas, device="cpu",
                                              output="device"))
        monkeypatch.undo()
        assert len(calls) == 2 and all(r.dev is None for r in handle._recs)
        from mp3tpu_torch.player import decode_batch_streams
        _, sched_books = books_of(
            lambda: decode_batch_streams(datas, device="cpu"))
    assert fallback_books == sched_books


@requires_native
def test_split_wav_matches_jax_and_mp3_raises(streams, tmp_path):
    src = tmp_path / "bursts.mp3"
    src.write_bytes(streams[2])
    got = mp3tpu_torch.split(str(src), str(tmp_path / "port"), device="cpu")
    want = mp3tpu.split(str(src), str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        [f"bursts-{i:03d}.wav" for i in (1, 2, 3)]
    for g, w in zip(got, want):
        with open(g, "rb") as f, open(w, "rb") as h:
            a, b = f.read(), h.read()
        assert a[:44] == b[:44]                  # the same WAV header
        assert_i16_close(np.frombuffer(a[44:], "<i2"),
                         np.frombuffer(b[44:], "<i2"))
    clips = mp3tpu_torch.split(streams[2], str(tmp_path / "bytes"),
                               device="cpu", stem="s", gapless=False)
    assert [os.path.basename(p) for p in clips] == \
        [f"s-{i:03d}.wav" for i in (1, 2, 3)]
    # the encoder is not ported: refused before anything is written
    out = tmp_path / "mp3"
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        mp3tpu_torch.split(str(src), str(out), fmt="mp3", device="cpu")
    assert not out.exists()
    with pytest.raises(ValueError, match="fmt"):
        mp3tpu_torch.split(str(src), str(out), fmt="ogg", device="cpu")


# ------------------------------------------------------------ on the card

def card_clips():
    clips = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_clips")
    out = []
    for name in ("sweep", "transients", "tonal"):
        with open(os.path.join(clips, f"{name}.mp3"), "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4, 24])
def test_cuda_d2h_segments_bit_identical(k):
    """On the card the K segments' copies run on the copy stream beside the
    next segment's kernels: the PCM of 16 streams x 10 s is that of the CPU
    within 1 LSB, and the same bits for every K, five times over (a buffer
    reused under a copy in flight would show only sometimes)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    batch = card_clips() * 5 + card_clips()[:1]
    port_config.set_active(port_config.resolve(
        decode={"batch_chunk_streams": 16, "d2h_segments": 1}))
    try:
        ref = mp3tpu_torch.decode_batch(batch, device="cuda")
        port_config.set_active(port_config.resolve(
            decode={"batch_chunk_streams": 16, "d2h_segments": k}))
        for _ in range(5):
            got = mp3tpu_torch.decode_batch(batch, device="cuda")
            for (a, _), (b, _) in zip(ref, got):
                assert np.array_equal(a, b)
        handle = mp3tpu_torch.decode_batch(batch, device="cuda",
                                           output="device")
        assert handle.device_pcm(0)[0].is_cuda
        for (a, _), (b, _) in zip(ref, handle.numpy()):
            assert np.array_equal(a, b)
        cpu = mp3tpu_torch.decode_batch(batch[:3], device="cpu")
        for (a, _), (b, _) in zip(ref, cpu):
            assert_i16_close(a, b)
    finally:
        port_config.set_active(port_config.resolve())


@pytest.mark.cuda
def test_cuda_handle_levels_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    batch = card_clips()
    got = mp3tpu_torch.levels_batch(batch, device="cuda")
    want = mp3tpu_torch.levels_batch(batch, device="cpu")
    assert_levels_close(got, want)
    assert mp3tpu_torch.segment_batch(batch, device="cuda") == \
        mp3tpu_torch.segment_batch(batch, device="cpu")
