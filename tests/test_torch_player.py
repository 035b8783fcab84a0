"""The PyTorch port's Player on the CPU: held against the JAX package's
Player on the same file (gain changes and EQ included, and a JAX snapshot
resumed in the port), and to its own bit-identity contracts: play ==
decode, seek + play == decode-then-slice, loop repeats, snapshot/restore
continuation, stop between the blocks of one emit."""
import numpy as np
import pytest

import fixtures
import mp3tpu_torch
from mp3tpu.player import Player as JaxPlayer
from mp3tpu_torch.player import CallbackSink, Player
from mp3tpu_torch.player.engine import GAIN_RAMP, GROUP_WINDOWS, WINDOW_GRANULES
from test_torch_decode import assert_i16_close

EQ = [6.0, 3.0, 0.0, -3.0, -6.0, 0.0, 3.0, 0.0, -2.0, 1.0]
GSPAN = GROUP_WINDOWS * WINDOW_GRANULES * 576


@pytest.fixture(scope="module")
def mp3():
    """4 s: two groups of windows, so seeks and loops cross a group."""
    pytest.importorskip("lameref")
    return fixtures.lame_fixture("sweep", ch=2, bitrate=128, mode="jstereo",
                                 seconds=4.0)


@pytest.fixture(scope="module")
def ref(mp3):
    return mp3tpu_torch.decode(mp3, gapless=False, device="cpu")[0]


def port(mp3, **kw):
    return Player(mp3, apply_gapless=False, device="cpu", **kw)


def test_play_matches_jax_player(mp3):
    """Gapless play, then a gain change mid-track (the ramp) with the EQ
    on: within 1 LSB of the JAX Player, 98% exact."""
    outs = []
    for P, kw in ((Player, {"device": "cpu"}), (JaxPlayer, {})):
        p = P(mp3, eq_gains_db=EQ, **kw)
        p.play(max_samples=3 * 18432 + 1000)
        p.gain_db = -7.5
        p.play()
        outs.append(p.sink.pcm)
    assert len(outs[0]) > 150000
    assert_i16_close(*outs)
    plain = [P(mp3, **kw) for P, kw in ((Player, {"device": "cpu"}),
                                       (JaxPlayer, {}))]
    for p in plain:
        p.play()
    assert_i16_close(plain[0].sink.pcm, plain[1].sink.pcm)


@pytest.mark.parametrize("kind", ["mono", "lsf22050"])
def test_play_mono_and_lsf(kind):
    """One channel, and an MPEG-2 rate (one granule per frame): play ==
    decode in the port, within 1 LSB of the JAX Player."""
    data = (fixtures.lame_fixture("sweep", ch=1, bitrate=96, mode="mono")
            if kind == "mono" else fixtures.lsf_fixture(22050))
    p = Player(data, device="cpu")
    p.play()
    assert p.sink.pcm.shape[1] == 1
    assert np.array_equal(p.sink.pcm, mp3tpu_torch.decode(data, device="cpu")[0])
    j = JaxPlayer(data)
    j.play()
    assert_i16_close(p.sink.pcm, j.sink.pcm)


def test_play_equals_decode(mp3, ref):
    p = port(mp3)
    p.play()
    assert np.array_equal(p.sink.pcm, ref)


@pytest.mark.parametrize("t", [0.73, (GSPAN + 9000) / 44100])
def test_seek_equals_slice(mp3, ref, t):
    """Within group 0, and into group 1, where the one-window pre-roll
    rebuilds the decoder state."""
    p = port(mp3)
    p.seek(t)
    start = int(round(t * 44100))
    p.play(until_sample=start + 20000)
    assert len(p.sink.pcm) == 20000
    assert np.array_equal(p.sink.pcm, ref[start:start + 20000])


def test_loop_repeats_across_a_group_boundary(mp3):
    p = port(mp3)
    b = (GSPAN + 30000) / 44100
    a = b - 1.2
    p.loop(a, b, times=3)
    seg = int(round(b * 44100)) - int(round(a * 44100))
    got = p.sink.pcm
    assert len(got) == 3 * seg
    assert np.array_equal(got[:seg], got[seg:2 * seg])
    assert np.array_equal(got[:seg], got[2 * seg:])


@pytest.mark.parametrize("eq", [None, EQ])
def test_snapshot_restore_continues(mp3, eq):
    p1 = port(mp3, eq_gains_db=eq)
    p1.play(until_sample=50000)
    blob = p1.snapshot()
    p1.play(until_sample=160000)
    p2 = port(mp3, eq_gains_db=eq)
    p2.restore(blob)
    p2.play(until_sample=160000)
    assert np.array_equal(p1.sink.pcm[50000:], p2.sink.pcm)


def test_stop_mid_multiblock_resumes_exact(mp3, ref):
    chunks = []

    def cb(pcm):
        chunks.append(np.array(pcm))
        if len(chunks) == 2:  # between two blocks of one emit
            p.stop()

    p = Player(mp3, CallbackSink(cb), apply_gapless=False, device="cpu")
    p.play()
    assert p.stopped and len(chunks) == 2
    p.play()
    assert np.array_equal(np.concatenate(chunks), ref)


def test_paced_play_and_gain_ramp(mp3, ref):
    """Sub-block reads take the host path and stay bit-identical; a gain
    change ramps over GAIN_RAMP samples, then holds the new gain."""
    p = port(mp3)
    while p.play(max_samples=5000):
        pass
    assert np.array_equal(p.sink.pcm, ref)
    flt = mp3tpu_torch.decode(mp3, gapless=False, output="float32",
                              device="cpu")[0]
    p = port(mp3)
    n0 = 36864
    p.play(max_samples=n0)
    p.gain_db = -12.0
    p.play(max_samples=n0)
    got = p.sink.pcm.astype(np.float32) / 32768.0
    assert np.array_equal(p.sink.pcm[:n0], ref[:n0])
    g1 = 10.0 ** (-12.0 / 20.0)
    steady = slice(n0 + 4 * GAIN_RAMP, 2 * n0)
    assert np.abs(got[steady] - flt[steady] * g1).max() <= 1.5 / 32768


def test_jax_snapshot_resumes_in_port(mp3):
    """A JAX Player's snapshot (decoder state, EQ tail, gain) restored into
    the port continues within 1 LSB of the JAX Player's continuation."""
    j = JaxPlayer(mp3, apply_gapless=False, eq_gains_db=EQ, gain_db=-3.0)
    j.play(until_sample=GSPAN + 5000)
    blob = j.snapshot()
    j.play()
    p = port(mp3, eq_gains_db=EQ)
    p.restore(blob)
    assert p.gain_db == -3.0 and p._eq_state is not None
    p.play()
    assert len(p.sink.pcm) > 20000
    assert_i16_close(p.sink.pcm, j.sink.pcm[GSPAN + 5000:])


def test_gain_and_eq_match_jax():
    """dsp.gain.apply_gain and the streaming GraphicEQ against the JAX
    package's on the same PCM; the EQ fed in two pieces equals one shot."""
    import jax.numpy as jnp
    import torch
    from mp3tpu.dsp import eq as jeq
    from mp3tpu.dsp import gain as jgain
    from mp3tpu_torch.dsp.eq import GraphicEQ
    from mp3tpu_torch.dsp.gain import apply_gain
    x = (0.3 * np.random.default_rng(3).standard_normal((5000, 2))).astype(np.float32)
    for db, prev in ((-6.0, None), (-6.0, 3.0)):
        got = apply_gain(torch.from_numpy(x), db, prev).numpy()
        want = np.asarray(jgain.apply_gain(jnp.asarray(x), db, prev))
        assert np.abs(got - want).max() <= 1e-6
    teq, jq = GraphicEQ(EQ, 44100, device="cpu"), jeq.GraphicEQ(EQ, 44100)
    assert np.array_equal(teq.h.numpy(), np.asarray(jq.h))
    one, _ = teq(torch.from_numpy(x))
    want, _ = jq(jnp.asarray(x))
    assert np.abs(one.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(want).max()
    a, st = teq(torch.from_numpy(x[:1234]))
    b, _ = teq(torch.from_numpy(x[1234:]), st)
    assert np.abs(torch.cat([a, b]).numpy() - one.numpy()).max() <= 1e-6


def test_segments_and_practice(mp3):
    """Player.segments() equals the JAX Player's; practice() replays each
    segment with gaps of silence."""
    pytest.importorskip("lameref")
    bursts = fixtures.lame_fixture("bursts", seconds=2.0, bitrate=128)
    p = Player(bursts, device="cpu")
    segs = p.segments()
    assert len(segs) == 3
    want = JaxPlayer(bursts).segments()
    assert np.allclose(segs, want, atol=0.021)
    out = p.practice(times=2, gap_s=0.1, stop=1)
    a, b = out[0]
    seg = int(round(b * 44100)) - int(round(a * 44100))
    assert len(p.sink.pcm) == 2 * (seg + 4410)
