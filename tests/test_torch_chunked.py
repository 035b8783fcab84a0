"""mp3tpu_torch.pipeline.decode_symbols_chunked (the halo-chunked decode of
one long stream as a batch of rows) on the CPU, held against the port's
decode_file as tests/test_faults.py holds the JAX one, and against
mp3tpu.pipeline.decode_symbols_chunked on the same symbols."""
import importlib

import numpy as np
import pytest
import torch

import fixtures
from mp3tpu_torch import pipeline as tpl
from mp3tpu_torch.config import resolve, set_active
from mp3tpu_torch.kernels import pipeline as tp
from test_torch_decode import clip

jax_pipeline = importlib.import_module("mp3tpu.pipeline")


@pytest.fixture(scope="module")
def mp3():
    return fixtures.own_fixture("transients", seconds=3.0)


@pytest.fixture
def segments_single():
    def set_k(k):
        set_active(resolve(decode={"d2h_segments_single": k}))
    yield set_k
    set_active(resolve())


def lsb(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d == 0).mean())


def quantize(x):
    return tp.quantize_i16(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("chunk_granules", [32, 48, 128])
def test_chunked_matches_sequential(mp3, chunk_granules):
    """At most 1 LSB and over 99.9% exact against decode_file, for float32
    (quantized here) and for output="int16" (quantized in the call)."""
    st, _info, _ = tpl.load_symbols(mp3)
    ref, _ = tpl.decode_file(mp3, gapless=False, device="cpu")
    par = tpl.decode_symbols_chunked(st, chunk_granules=chunk_granules,
                                     device="cpu")
    assert par.dtype == np.float32 and par.shape == ref.shape
    worst, exact = lsb(ref, quantize(par))
    assert worst <= 1 and exact > 0.999
    par16 = tpl.decode_symbols_chunked(st, chunk_granules=chunk_granules,
                                       output="int16", device="cpu")
    assert par16.dtype == np.int16
    worst, exact = lsb(ref, par16)
    assert worst <= 1 and exact > 0.999
    assert np.array_equal(par16, quantize(par))  # quantizing is elementwise


@pytest.mark.parametrize("kind", ["transients3", "lsf22050", "mono"])
@pytest.mark.parametrize("output", ["float32", "int16"])
def test_chunked_matches_jax(mp3, kind, output):
    """The same symbols through both packages: int16 within 1 LSB (over 98%
    exact), float32 within 1e-5 of the largest sample."""
    if kind == "mono":
        from mp3tpu.encoder import encode_pcm
        data = encode_pcm(fixtures.tone_sweep(1.0, 44100, 1), 44100, bitrate=96)
    else:
        data = mp3 if kind == "transients3" else clip(kind)
    st, _info, _ = tpl.load_symbols(data)
    stj, _infoj, _ = jax_pipeline.load_symbols(data)
    got = tpl.decode_symbols_chunked(st, chunk_granules=32, output=output,
                                     device="cpu")
    want = jax_pipeline.decode_symbols_chunked(stj, chunk_granules=32,
                                               output=output)
    assert got.shape == want.shape == (st.n_granules * 576, st.channels)
    if output == "int16":
        worst, exact = lsb(got, want)
        assert worst <= 1 and exact >= 0.98
    else:
        assert np.abs(want).max() > 0
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_d2h_segments_single_bit_identical(mp3, segments_single, monkeypatch, k):
    """decode.d2h_segments_single = K splits the rows into K calls where
    they split evenly and there are at least 2K; the rows are independent,
    so the PCM is the single call's. 3 s is 230 granules: 8 rows of 32."""
    st, _info, _ = tpl.load_symbols(mp3)
    segments_single(1)
    ref = tpl.decode_symbols_chunked(st, chunk_granules=32, output="int16",
                                     device="cpu")
    rows = []
    real = tp.decode_window_i16
    monkeypatch.setattr(tp, "decode_window_i16", lambda *a:
                        rows.append(a[0].shape[:2]) or real(*a))
    segments_single(k)
    got = tpl.decode_symbols_chunked(st, chunk_granules=32, output="int16",
                                     device="cpu")
    assert np.array_equal(got, ref)
    want_calls = k if k in (1, 2, 4) else 1       # 8 rows do not split in 3
    assert rows == [(8 // want_calls, 34)] * want_calls


def test_gather_is_the_loop(mp3):
    """The rows handed to the decode are those of the JAX package's
    per-granule loop: row c holds granules [c*chunk - halo, (c+1)*chunk),
    zeros outside the stream."""
    st, _info, _ = tpl.load_symbols(mp3)
    seen = {}
    real = tp.decode_window

    def spy(is_, exp, bt, mixed, smode, state, rate):
        seen.update(is_=is_.numpy(), smode=smode.numpy(), mixed=mixed.numpy())
        return real(is_, exp, bt, mixed, smode, state, rate)

    import unittest.mock
    set_active(resolve(decode={"d2h_segments_single": 1}))
    try:
        with unittest.mock.patch.object(tp, "decode_window", spy):
            tpl.decode_symbols_chunked(st, chunk_granules=100, halo=2,
                                       device="cpu")
    finally:
        set_active(resolve())
    G, W = st.n_granules, 102
    S = -(-G // 100)
    for key, a in (("is_", st.is_), ("smode", st.smode), ("mixed", st.mixed)):
        want = np.zeros((S, W) + a.shape[1:], a.dtype)
        for c in range(S):
            for w in range(W):
                g = c * 100 - 2 + w
                if 0 <= g < G:
                    want[c, w] = a[g]
        assert seen[key].dtype == a.dtype and np.array_equal(seen[key], want)
