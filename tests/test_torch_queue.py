"""The PyTorch port's PlayQueue and the envelope scans behind it
(track_levels, loudness, segment) on the CPU, held against the JAX
package's on the same files."""
import numpy as np
import pytest

import fixtures
import mp3tpu
import mp3tpu_torch
from mp3tpu.player import PlayQueue as JaxQueue
from mp3tpu_torch.player import PlayQueue
from test_torch_decode import assert_i16_close


@pytest.fixture(scope="module")
def two_tracks():
    pytest.importorskip("lameref")
    return [fixtures.lame_fixture("sweep", ch=2, bitrate=128, mode="jstereo"),
            fixtures.lame_fixture("tonal", seconds=1.2, bitrate=160)]


def decode_concat(paths):
    return np.concatenate([mp3tpu_torch.decode(p, device="cpu")[0]
                           for p in paths])


def test_queue_gapless_equals_decode_concat(two_tracks):
    q = PlayQueue(two_tracks, device="cpu")
    q.play()
    assert np.array_equal(q.sink.pcm, decode_concat(two_tracks))
    assert q.current == 1
    j = JaxQueue(two_tracks)
    j.play()
    assert_i16_close(q.sink.pcm, j.sink.pcm)


def test_queue_snapshot_resume(two_tracks):
    q1 = PlayQueue(two_tracks, device="cpu")
    q1.play(tracks=1)
    q1.seek(0.4)
    q1.player.play(max_samples=32 * 576)
    blob = q1.snapshot()
    q2 = PlayQueue(two_tracks, device="cpu")
    q2.restore(blob)
    assert q2.current == 1
    q2.play()
    start = int(round(0.4 * 44100)) + 32 * 576
    want = mp3tpu_torch.decode(two_tracks[1], device="cpu")[0][start:]
    assert np.array_equal(q2.sink.pcm, want)


def test_levels_loudness_match_jax():
    """track_levels' loudness and playable peak within 0.01 dB of the JAX
    package's; loudness() is the first of them."""
    pytest.importorskip("lameref")
    files = [fixtures.lame_fixture("tonal", seconds=1.2, bitrate=160),
             fixtures.lame_fixture("bursts", seconds=2.0, bitrate=128),
             fixtures.lame_fixture("sweep", ch=1, bitrate=96, mode="mono")]
    for f in files:
        ld, pk = mp3tpu_torch.levels(f, device="cpu")
        jld, jpk = mp3tpu.levels(f)
        assert abs(ld - jld) < 0.01 and abs(pk - jpk) < 0.01, (ld, jld, pk, jpk)
        assert mp3tpu_torch.loudness(f, device="cpu") == ld


def test_queue_normalize_gain_matches_jax():
    """normalize=True: each track's gain within 0.01 dB of the JAX
    queue's, and tracks mastered 12 dB apart come out matched."""
    pytest.importorskip("lameref")
    import lameref
    sig = np.clip(fixtures.tonal_stereo(1.2, 44100), -1, 1)
    files = [lameref.encode(sig, 44100, bitrate=160),
             lameref.encode(0.25 * sig, 44100, bitrate=160)]
    q, j = PlayQueue(files, normalize=True, device="cpu"), JaxQueue(files, normalize=True)
    gains = []
    for _ in files:
        assert abs(q.player.gain_db - j.player.gain_db) < 0.01
        gains.append(q.player.gain_db)
        q.next(), j.next()
    assert gains[1] - gains[0] > 10.0
    q = PlayQueue(files, normalize=True, device="cpu")
    q.play()
    n0 = len(mp3tpu_torch.decode(files[0], device="cpu")[0])
    rms = [np.sqrt(np.mean((x / 32768.0) ** 2))
           for x in (q.sink.pcm[:n0], q.sink.pcm[n0:])]
    assert abs(20 * np.log10(rms[0] / rms[1])) < 2.0


def test_segment_matches_jax():
    pytest.importorskip("lameref")
    bursts = fixtures.lame_fixture("bursts", seconds=2.0, bitrate=128)
    got = mp3tpu_torch.segment(bursts, device="cpu")
    assert len(got) == 3
    assert np.allclose(got, mp3tpu.segment(bursts), atol=1e-9)
    with pytest.raises(ValueError, match="fixed 576-sample"):
        mp3tpu_torch.segment(bursts, device="cpu", hop_s=0.02)
