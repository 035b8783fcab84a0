"""The port's batched encoder and transcode path end to end on the CPU
(mp3tpu_torch.encode_batch, encode, transcode_batch), about 1 s of audio and
at most 3 streams a call.

Across packages (float32 searches that flip at quantization boundaries):
every stream of encode_batch has the JAX package's number of frames and
bytes, and decodes within 0.5 dB of its SNR and within 3 dB of encode_pcm's.
Within the port, byte for byte: a rerun; int16 staging with labels from the
device's float64 energies against float32 staging with host labels, and
input that is not int16-origin against the same; a reused staging buffer;
the Python reference mux against the C++ mux; any row-block size;
encode(device_loops=True)
against encode_batch; transcode from a DecodedBatch against encode_batch of
the handle's PCM.
"""
import numpy as np
import pytest
import torch

import fixtures
import mp3tpu_torch
from mp3tpu.encoder import encode_batch as jax_encode_batch
from mp3tpu_torch.container import frames as fr
from mp3tpu_torch.encoder import device as tdev
from mp3tpu_torch.encoder import encode_pcm, mux_packed, vloop_device

torch.set_num_threads(1)
SR = 44100


def i16_origin(sig):
    return np.round(np.clip(sig, -1, 1) * 32767) / 32768.0


@pytest.fixture(scope="module")
def pcms():
    rng = np.random.default_rng(7)
    t = np.arange(int(1.0 * SR)) / SR
    tone = np.stack([np.sin(2 * np.pi * 330 * t) * 0.5,
                     np.sin(2 * np.pi * 440 * t) * 0.4], 1)
    return [i16_origin(tone), i16_origin(fixtures.transients(0.9, SR)),
            i16_origin(0.25 * rng.standard_normal((len(t) // 2, 2)))]


def snr_db(mp3, ref):
    dec, sr = mp3tpu_torch.decode(bytes(mp3), output="float32", device="cpu")
    assert sr == SR and len(dec) == len(ref)      # the gapless round trip
    err = dec.astype(np.float64) - ref.reshape(dec.shape)
    return 10 * np.log10((ref ** 2).mean() / max((err ** 2).mean(), 1e-30))


def n_frames(mp3):
    return int(fr.scan_frames(np.frombuffer(mp3, np.uint8)).n_frames)


@pytest.fixture(scope="module")
def encoded(pcms):
    return mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cpu")


def test_encode_batch_across_packages(pcms, encoded):
    """Frames and bytes equal in number to the JAX package's streams (CBR);
    SNR within 0.5 dB of its and within 3 dB of the host encode_pcm's
    (measured 0.00-0.02 dB and 0.1-0.6 dB); floors: the tone above 45 dB."""
    want = jax_encode_batch(pcms, SR, bitrate=128)
    assert len(encoded) == len(want) == 3
    for got, ref, pcm in zip(encoded, want, pcms):
        assert len(got) == len(ref) and n_frames(got) == n_frames(ref)
        s, sj = snr_db(got, pcm), snr_db(ref, pcm)
        sh = snr_db(encode_pcm(pcm, SR, bitrate=128, device="cpu"), pcm)
        assert abs(s - sj) <= 0.5 and abs(s - sh) <= 3.0, (s, sj, sh)
    assert snr_db(encoded[0], pcms[0]) > 45.0


def test_rerun_gives_the_same_bytes(pcms, encoded):
    assert mp3tpu_torch.encode_batch(pcms, SR, bitrate=128,
                                     device="cpu") == encoded


def test_int16_staging_bit_identical(pcms, encoded, monkeypatch):
    monkeypatch.setattr(tdev, "FORCE_F32_STAGE", True)
    assert mp3tpu_torch.encode_batch(pcms, SR, bitrate=128,
                                     device="cpu") == encoded


def test_python_mux_equals_the_native_mux(pcms, encoded, monkeypatch):
    """With no C++ library, the Python reference mux (mux_packed's
    _assemble_python) gives the bytes of the C++ mux; the rows come from
    the device emitter either way."""
    monkeypatch.setenv("MP3TPU_NO_NATIVE", "1")
    monkeypatch.setattr(mux_packed, "FORCE_PYTHON_MUX", True)
    from mp3tpu_torch.bitstream import native
    monkeypatch.setattr(native, "_checked", False)
    monkeypatch.setattr(native, "_lib", None)
    assert mp3tpu_torch.encode_batch(pcms, SR, bitrate=128,
                                     device="cpu") == encoded
    monkeypatch.setattr(native, "_checked", False)


def test_row_block_size_does_not_matter(pcms, encoded, monkeypatch):
    monkeypatch.setitem(vloop_device.ROW_BLOCK, "cpu", 37)
    assert mp3tpu_torch.encode_batch(pcms, SR, bitrate=128,
                                     device="cpu") == encoded


def test_a_stream_alone_equals_the_stream_in_its_batch(pcms, encoded):
    """On the CPU the float stages give a stream the same bits whatever
    batch it is in; encode(device_loops=True) is that batch of one."""
    one = mp3tpu_torch.encode_batch([pcms[1]], SR, bitrate=128, device="cpu")
    assert one[0] == encoded[1]
    assert mp3tpu_torch.encode(pcms[1], SR, bitrate=128, device_loops=True,
                               device="cpu") == encoded[1]


@pytest.mark.parametrize("kw", [
    dict(reservoir=False), dict(noise_shaping=False),
    dict(noise_shaping=False, reservoir=False, short_blocks=False),
    dict(bitrate=64, joint_stereo=False)], ids=str)
def test_options(pcms, kw):
    """The no-reservoir path, the plain rate loop and other bitrates:
    conformant streams of the JAX package's sizes, SNR within 0.5 dB."""
    kw = dict(dict(bitrate=128), **kw)
    got = mp3tpu_torch.encode_batch(pcms[:2], SR, device="cpu", **kw)
    want = jax_encode_batch(pcms[:2], SR, **kw)
    for g, w, pcm in zip(got, want, pcms):
        assert len(g) == len(w) and n_frames(g) == n_frames(w)
        assert abs(snr_db(g, pcm) - snr_db(w, pcm)) <= 0.5


def test_mono_and_mixed_channels(pcms):
    mono = [p[:, 0] for p in pcms[:2]]
    got = mp3tpu_torch.encode_batch(mono, SR, bitrate=96, device="cpu")
    want = jax_encode_batch(mono, SR, bitrate=96)
    for g, w, pcm in zip(got, want, mono):
        assert len(g) == len(w)
        assert abs(snr_db(g, pcm[:, None]) - snr_db(w, pcm[:, None])) <= 0.5
    # mixed channel counts fall back to encode_pcm, stream by stream
    mixed = mp3tpu_torch.encode_batch([mono[0][:8000], pcms[2][:8000]], SR,
                                      bitrate=96, device="cpu")
    assert mixed[0] == encode_pcm(mono[0][:8000], SR, bitrate=96, device="cpu")


def test_rejects_what_the_jax_package_rejects(pcms):
    with pytest.raises(ValueError, match="bitrate"):
        mp3tpu_torch.encode_batch(pcms, SR, bitrate=100, device="cpu")
    with pytest.raises(ValueError, match="sample rate"):
        mp3tpu_torch.encode_batch(pcms, 22050, device="cpu")
    with pytest.raises(ValueError, match="CBR only"):
        mp3tpu_torch.encode(pcms[0], SR, vbr_quality=4, device_loops=True,
                            device="cpu")


def test_encode_profile_and_iteration_histogram(pcms, monkeypatch, capsys):
    """MP3TPU_ENCODE_PROFILE=1 prints the phase walls; MP3TPU_ITER_HIST=1
    counts every row's outer iterations."""
    from mp3tpu_torch.encoder import batch
    monkeypatch.setenv("MP3TPU_ENCODE_PROFILE", "1")
    monkeypatch.setenv("MP3TPU_ITER_HIST", "1")
    vloop_device.ITER_STATS.clear()
    mp3tpu_torch.encode_batch(pcms[1:2], SR, bitrate=128, device="cpu")
    assert "MP3TPU_ENCODE_PROFILE" in capsys.readouterr().out
    prof = batch.LAST_PROFILE
    for phase in ("host_prep", "stage", "transform_psy", "energies", "prep",
                  "passA_walk", "passA", "passB", "emit", "mux"):
        assert prof[phase] >= 0.0, phase
    assert prof["stage_int16"] == 1 and prof["total_rows"] > 0
    hist = vloop_device.ITER_STATS
    assert set(hist) <= {"long", "switched", "short"} and "short" in hist
    assert sum(int(h.sum()) for h in hist.values()) >= prof["total_rows"]


# ---- int16 staging and labels from the device's float64 energies

def transient_streams(nch):
    """Int16-origin clicks and bursts at two unequal lengths: short blocks."""
    sig = fixtures.transients(0.7, SR, nch)
    out = [i16_origin(sig[:26000]), i16_origin(np.roll(sig, 9000, 0)[:17000])]
    return [p[:, 0] for p in out] if nch == 1 else out


def short_granules(mp3):
    from mp3tpu_torch.pipeline import load_symbols
    st, _info, _index = load_symbols(mp3)
    return int((st.block_type == 2).sum())


@pytest.fixture
def spans(monkeypatch):
    """Span recording on, TOTALS empty; yields TOTALS."""
    from mp3tpu_torch.utils import profiling
    monkeypatch.setenv("MP3TPU_SPANS", "1")
    monkeypatch.setattr(profiling, "_ON", profiling._ON)
    saved = dict(profiling.TOTALS)
    profiling.TOTALS.clear()
    yield profiling.TOTALS
    profiling.TOTALS.clear()
    profiling.TOTALS.update(saved)


def f32_route(pcms, monkeypatch, **kw):
    """encode_batch through the float32 staging and the float64 host labels."""
    with monkeypatch.context() as m:
        m.setattr(tdev, "FORCE_F32_STAGE", True)
        return mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cpu",
                                         **kw)


@pytest.mark.parametrize("nch", [1, 2])
def test_int16_route_equals_the_f32_route_on_transients(nch, monkeypatch,
                                                        spans):
    """Int16 staging with labels from the device's energies gives the bytes
    of float32 staging with float64 host labels, short blocks included."""
    pcms = transient_streams(nch)
    got = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cpu")
    assert spans["mp3tpu.encode.labels/device"]["items"] == 2
    assert got == f32_route(pcms, monkeypatch)
    assert spans["mp3tpu.encode.labels/host"]["items"] == 2
    assert all(short_granules(m) > 0 for m in got)


@pytest.mark.parametrize("how", ["gain 0.37", "k/2^15 + 1e-12"])
def test_input_not_int16_origin_takes_the_f32_route(how, monkeypatch, spans):
    pcms = transient_streams(2)
    pcms[1] = pcms[1] * 0.37 if how == "gain 0.37" else pcms[1] + 1e-12
    got = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cpu")
    assert spans["mp3tpu.encode.labels/host"]["items"] == 2
    assert "mp3tpu.encode.labels/device" not in spans
    assert got == f32_route(pcms, monkeypatch)
    assert short_granules(got[0]) > 0


def test_the_reused_staging_buffer_gives_fresh_bytes(pcms, monkeypatch):
    """A larger batch after a smaller, then a smaller again: each call's
    bytes are those of a call on a fresh staging buffer, and the buffer
    grows once and is then reused."""
    calls = [[pcms[2][:9000]], [p[:22000] for p in pcms],
             [pcms[1][:20000], pcms[0][:5000]]]
    fresh = []
    for c in calls:
        with monkeypatch.context() as m:
            m.setattr(tdev, "_STAGE", {"buf": None, "copied": None})
            fresh.append(mp3tpu_torch.encode_batch(c, SR, bitrate=128,
                                                   device="cpu"))
    monkeypatch.setattr(tdev, "_STAGE", {"buf": None, "copied": None})
    bufs = []
    for c, want in zip(calls, fresh):
        assert mp3tpu_torch.encode_batch(c, SR, bitrate=128,
                                         device="cpu") == want
        bufs.append(tdev._STAGE["buf"])
    assert bufs[1] is bufs[2] and bufs[0] is not bufs[1]


# ---- transcode: the DecodedBatch straight into the encoder

@pytest.fixture(scope="module")
def mp3s():
    return [fixtures.own_fixture("tonal", seconds=0.8),
            fixtures.own_fixture("transients", seconds=1.0),
            fixtures.own_fixture("sweep", seconds=0.6)]


def host_pcms(handle):
    return [p.astype(np.float64) / 32768.0 for p, _sr in handle.numpy()]


@pytest.mark.parametrize("short_blocks", [False, True])
def test_transcode_equals_encode_of_the_handles_pcm(mp3s, short_blocks):
    """Byte for byte: the gather's dequantization is the int16 staging's,
    and the labels from float64 sub-block energies are the host's."""
    handle = mp3tpu_torch.decode_batch(mp3s, output="device", device="cpu")
    got = mp3tpu_torch.encode_batch(handle, bitrate=112,
                                    short_blocks=short_blocks)
    ref = mp3tpu_torch.encode_batch(host_pcms(handle), SR, bitrate=112,
                                    short_blocks=short_blocks, device="cpu")
    assert got == ref
    if short_blocks:
        from mp3tpu_torch.pipeline import load_symbols
        st, _info, _index = load_symbols(got[1])
        assert (st.block_type == 2).any()    # the transients switched


def test_transcode_labels_equal_the_host_labels_of_its_pcm(mp3s, monkeypatch,
                                                          spans):
    """The labels the transcode decides from the device's float64 energies
    equal block_type_sequence of the handle's .numpy() PCM exactly."""
    from mp3tpu_torch.encoder import batch
    from mp3tpu_torch.encoder.psymodel import (align_to_mdct,
                                               block_type_sequence)
    handle = mp3tpu_torch.decode_batch(mp3s, output="device", device="cpu")
    labels = []
    decide = batch.block_types_from_subblock_energy
    monkeypatch.setattr(batch, "block_types_from_subblock_energy",
                        lambda e: labels.append(decide(e)) or labels[-1])
    mp3tpu_torch.encode_batch(handle, bitrate=112)
    assert spans["mp3tpu.encode.labels/device"]["items"] == len(mp3s)
    assert len(labels) == len(mp3s)
    for got, pcm in zip(labels, host_pcms(handle)):
        padded = np.zeros((len(got) * 576, pcm.shape[1]))
        padded[: len(pcm)] = pcm
        assert np.array_equal(got, block_type_sequence(align_to_mdct(padded),
                                                       SR))
    assert any((g == 2).any() for g in labels)


def test_transcode_mono_and_host_records(monkeypatch):
    from mp3tpu_torch import config
    mono = [mp3tpu_torch.encode(fixtures.tone_sweep(0.7, SR, 1)[:, 0], SR,
                                bitrate=96, device="cpu"),
            mp3tpu_torch.encode(fixtures.tone_sweep(0.7, SR, 1)[:, 0] * 0.5,
                                SR, bitrate=128, device="cpu")]
    handle = mp3tpu_torch.decode_batch(mono, output="device", device="cpu")
    assert handle.device_pcm(0)[4] == 1
    assert all(isinstance(handle.device_pcm(i)[0], torch.Tensor)
               for i in range(2))
    got = mp3tpu_torch.encode_batch(handle, bitrate=96)
    assert got == mp3tpu_torch.encode_batch(host_pcms(handle), SR, bitrate=96,
                                            device="cpu")
    # host-fallback records (the scheduler's, with the C++ unpacker off)
    config.set_active(config.resolve(decode={"use_native": False}))
    try:
        slow = mp3tpu_torch.decode_batch(mono, output="device", device="cpu")
    finally:
        config.set_active(config.resolve())
    assert isinstance(slow.device_pcm(0)[0], np.ndarray)
    assert mp3tpu_torch.encode_batch(slow, bitrate=96, device="cpu") == got


def test_transcode_batch_roundtrip(mp3s):
    """api.transcode_batch: valid streams of the inputs' lengths and of the
    JAX package's sizes, within 0.5 dB of its SNR against the inputs' decode
    (128 -> 96 kbps; measured 27.50 / 7.51 / 20.37 dB against the JAX
    package's 27.50 / 7.53 / 20.37: plain SNR is low on the transients,
    whose noise is shaped under the masking threshold)."""
    import mp3tpu
    outs = mp3tpu_torch.transcode_batch(mp3s, bitrate=96, device="cpu")
    want = mp3tpu.transcode_batch(mp3s, bitrate=96)
    assert len(outs) == len(mp3s)
    for src, out, ref in zip(mp3s, outs, want):
        assert len(out) == len(ref)
        a, _ = mp3tpu_torch.decode(src, output="float32", device="cpu")
        a = a.astype(np.float64)
        assert abs(snr_db(out, a) - snr_db(ref, a)) <= 0.5
    assert snr_db(outs[0], mp3tpu_torch.decode(
        mp3s[0], output="float32", device="cpu")[0].astype(np.float64)) > 25.0
    with pytest.raises(ValueError, match="sample_rate"):
        mp3tpu_torch.encode_batch(
            mp3tpu_torch.decode_batch(mp3s, output="device", device="cpu"),
            48000)
