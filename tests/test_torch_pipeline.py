"""The PyTorch port's granule chain, int16 rounding, plane decode, arenas
and resampler, held against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mp3tpu.dsp import resample as jrs
from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch.bitstream import native
from mp3tpu_torch.dsp.resample import Resampler
from mp3tpu_torch.kernels import pipeline as tp
from mp3tpu_torch.pipeline import (_unpack_chunk, load_symbols, probe_granules,
                                   stream_meta)

# float32 both sides, sums in another order (the 512-term synthesis FIR, the
# 171-term resample blocks): a few ulp of the largest value
REL_TOL = 1e-5

requires_native = pytest.mark.skipif(not native.available(),
                                     reason="native unpacker unavailable")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max(), what


def window_symbols(rng, S, G):
    """Random symbols at music-like magnitudes, every block type."""
    is_ = rng.integers(-6, 7, (S, G, 2, 576)).astype(np.int16)
    is_[:, :, :, 300:] = 0
    exp = rng.integers(-60, -20, (S, G, 2, 64)).astype(np.int16)
    bt = rng.integers(0, 4, (S, G, 2)).astype(np.int8)
    mixed = (rng.random((S, G, 2)) < 0.3) & (bt == 2)
    smode = rng.integers(0, 144, (S, G, 64)).astype(np.uint8)
    return is_, exp, bt, mixed, smode


def test_granule_decoder_matches_jax_over_two_windows():
    rng = np.random.default_rng(11)
    S, G, sr = 2, 32, 44100
    run = kp._jitted_for(sr)
    dec = tp.decoder_for(sr, "cpu")
    sj, st = kp.init_state(S), tp.init_state(S, device="cpu")
    real = load_symbols(fixtures.own_fixture("transients"))[0]
    for w in range(2):
        args = list(window_symbols(rng, S, G))
        for a, name in zip(args, ("is_", "exp", "block_type", "mixed", "smode")):
            a[1] = getattr(real, name)[w * G:(w + 1) * G]  # stream 1: real
        pj, sj = run(*(jnp.asarray(a) for a in args), sj)
        pt, st = dec(*(t(a) for a in args), st)
        assert_close(pt.numpy(), pj, f"pcm window {w}")
        for k in ("overlap", "hist"):
            assert_close(st[k].numpy(), sj[k], f"{k} window {w}")


def test_decode_window_group_matches_jax():
    rng = np.random.default_rng(12)
    args = window_symbols(rng, 1, 64)
    pj, sj = kp.decode_window_group(*(jnp.asarray(a) for a in args),
                                    kp.init_state(1), 44100, 2)
    pt, st = tp.decode_window_group(*(t(a) for a in args),
                                    tp.init_state(1, device="cpu"), 44100, 2)
    assert_close(pt.numpy(), pj)
    assert_close(st["hist"].numpy(), sj["hist"])


def test_quantize_i16_bit_exact_with_ties():
    k = np.arange(-32770, 32770, dtype=np.float64)
    vals = np.concatenate([k, k + 0.5, k - 0.5, k + 0.4999, k + 0.5001]) / 32768.0
    vals = np.concatenate([vals, [-1.5, 1.5, 0.0, -0.0]]).astype(np.float32)
    want = np.asarray(kp.quantize_i16(jnp.asarray(vals)))
    got = tp.quantize_i16(t(vals)).numpy()
    assert got.dtype == np.int16 and np.array_equal(got, want)
    # a tie rounds away from zero, where torch.round would go to even
    assert tp.quantize_i16(torch.tensor([2.5 / 32768, -2.5 / 32768])).tolist() == [3, -3]


def pack4(v):
    """numpy 4-bit plane + two-level sideband of int rows [..., 576]."""
    flat = v.reshape(-1, 576)
    is4 = np.zeros((len(flat), 288), np.uint8)
    esc = np.zeros((len(flat), 80), np.int8)
    for r, row in enumerate(flat):
        nib = np.where(np.abs(row) <= 7, row + 7, 15).astype(np.uint8)
        is4[r] = nib[0::2] | (nib[1::2] << 4)
        ev = row[np.abs(row) > 7]
        deep = ev[np.abs(ev) > 127]
        esc[r, :len(ev)] = np.where(np.abs(ev) > 127, -128, ev)
        esc[r, 64:64 + len(deep)] = (deep & 255).astype(np.uint8).view(np.int8)
        esc[r, 72:72 + len(deep)] = (deep >> 8).astype(np.int8)
    return is4.reshape(v.shape[:-1] + (288,)), esc.reshape(v.shape[:-1] + (80,))


def test_unpack4_deep_escapes_bit_exact():
    rng = np.random.default_rng(13)
    v = rng.integers(-7, 8, (3, 4, 576))
    for row in v.reshape(-1, 576):
        pos = rng.choice(576, rng.integers(0, 65), replace=False)
        row[pos] = rng.integers(-127, 128, len(pos))
        row[pos[:8]] = rng.choice([-1, 1], len(pos[:8])) * rng.integers(128, 8207, len(pos[:8]))
    is4, esc = pack4(v)
    got = tp.unpack4(t(is4), t(esc)).numpy()
    assert np.array_equal(got, v)
    assert np.array_equal(got, np.asarray(kp.unpack4(jnp.asarray(is4), jnp.asarray(esc))))


@requires_native
@pytest.mark.parametrize("plane_bits,exp_bytes", [(4, True), (8, False), (12, False)])
def test_plane_decode_on_native_planes(plane_bits, exp_bytes):
    """unpack4/8/12 and _exp_decode on the C++ unpacker's planes: bit-exact
    against the JAX functions and against the int16 symbols."""
    mp3 = fixtures.own_fixture("transients")
    body = stream_meta(mp3)[0]
    G = probe_granules(body)
    got = _unpack_chunk([body], [G], 1, 32, plane_bits, exp_bytes)
    assert got is not None
    b, _errs = got
    st = native.unpack_native(body)
    iv = tp._plane_decode(plane_bits, t(b["is12"]), t(b["esc"])).numpy()
    ivj = np.asarray(kp._plane_decode(plane_bits, jnp.asarray(b["is12"]),
                                      jnp.asarray(b["esc"])))
    assert np.array_equal(iv, ivj)
    flat = iv.reshape(-1, 2, 576)[:G]
    assert np.array_equal(flat, st.is_)
    ex = tp._exp_decode(t(b["exp"])).numpy()
    assert np.array_equal(ex, np.asarray(kp._exp_decode(jnp.asarray(b["exp"]))))
    # the byte plane fills the unused band slots 61-63, the int16 plane zeros them
    assert np.array_equal(ex.reshape(-1, 2, 64)[:G, :, :61], st.exp[..., :61])


@requires_native
def test_window_arena_split_bit_exact():
    bodies = [stream_meta(fixtures.own_fixture(n))[0] for n in ("transients", "tonal")]
    Gs = [probe_granules(b) for b in bodies]
    b, _ = _unpack_chunk(bodies, Gs, 2, 32, 4, True)
    wb, layout = tp.window_arena_layout(2, 32)
    assert (wb, layout) == kp.window_arena_layout(2, 32)
    arena = tp.pack_window_arenas(b, 2, 32)[1]
    ours = tp._split_window_arena(t(arena), 2, 32)
    ref = kp._split_window_arena(jnp.asarray(arena), 2, 32)
    for k, _off, _shp, dt in layout:
        assert ours[k].numpy().dtype == dt
        assert np.array_equal(ours[k].numpy(), np.asarray(ref[k])), k
        assert np.array_equal(ours[k].numpy(), b[k][1]), k


@requires_native
def test_decode_window_arenas_matches_scan_and_jax():
    """The arena program equals the per-plane program bit for bit, and the
    JAX arena program within 1 LSB."""
    bodies = [stream_meta(fixtures.own_fixture(n))[0] for n in ("transients", "tonal")]
    Gs = [probe_granules(b) for b in bodies]
    b, _ = _unpack_chunk(bodies, Gs, 2, 32, 4, True)
    n_win = b["is12"].shape[0]
    arenas = tp.pack_window_arenas(b, 2, 32)
    got, st = tp.decode_window_arenas_i16(list(t(arenas)), tp.init_state(2, device="cpu"),
                                          44100, 2, 32)
    keys = ("is12", "esc", "exp", "bt", "mx", "smode")
    plain, _ = tp.decode_windows_scan_i16(*([t(b[k][w]) for w in range(n_win)] for k in keys),
                                          tp.init_state(2, device="cpu"), 44100, 4)
    assert torch.equal(got, plain)
    want, sj = kp.decode_window_arenas_i16([jnp.asarray(a) for a in arenas],
                                           kp.init_state(2), 44100, 2, 32)
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.98
    assert_close(st["overlap"].numpy(), sj["overlap"])


def test_resampler_one_shot_and_flush():
    rng = np.random.default_rng(14)
    x = (0.5 * rng.standard_normal((5000, 2))).astype(np.float32)
    jr, tr = jrs.Resampler(44100, 48000), Resampler(44100, 48000, device="cpu")
    assert (tr.L, tr.M, tr.n_taps, tr.state_len, tr.block_width) == \
        (jr.L, jr.M, jr.n_taps, jr.state_len, jr.block_width)
    assert np.array_equal(tr.block_w.numpy(), np.asarray(jr.block_w))
    yj, sj = jr(jnp.asarray(x))
    yt, st = tr(t(x))
    assert_close(yt.numpy(), yj)
    assert st[1:] == (sj[1], sj[2])
    assert_close(tr.flush(st).numpy(), jr.flush(sj))


def test_resampler_chunked_equals_one_shot():
    """Chained calls with uneven chunks continue the one-shot output grid."""
    rng = np.random.default_rng(15)
    x = (0.5 * rng.standard_normal((6001, 2))).astype(np.float32)
    tr = Resampler(44100, 48000, device="cpu")
    one, s1 = tr(t(x))
    one = torch.cat([one, tr.flush(s1)])
    parts, st = [], None
    for lo, hi in ((0, 7), (7, 1500), (1500, 1501), (1501, 6001)):
        y, st = tr(t(x[lo:hi]), st)
        parts.append(y)
    parts.append(tr.flush(st))
    chunked = torch.cat(parts)
    assert chunked.shape[0] == tr.total_out(len(x))
    assert_close(chunked.numpy(), one.numpy())
    yj = jrs.resample(jnp.asarray(x), 44100, 48000)
    assert_close(chunked.numpy(), yj)
