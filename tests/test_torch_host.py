"""The port's own host modules (src/mp3tpu_torch/{container,bitstream,tables,
oracle}, config.py) held against the JAX package's on the CPU, on the
fixtures of test_oracle_mpg123 (LAME: mono, MS, short blocks, VBR/Xing, LSF),
test_intensity (crafted intensity and MS+intensity, MPEG-1 and LSF),
test_blocks (crafted short and mixed blocks) and test_lsf (self-hosted LSF
at every LSF rate); the committed clips of tests/torch_clips/, which
chip_smoke.py decodes, re-encoded byte for byte by the JAX package's
encoder and by the port's; and the port's copies of the encoder's host
modules (src/mp3tpu_torch/encoder/, bitstream/bitwriter.py, the C++
mux), each held to its original on the same inputs, up to
encode_pcm's float64 host path byte for byte in every configuration.

    python tests/test_torch_host.py --write    # (re)writes tests/torch_clips/
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

import fixtures
from mp3tpu.bitstream import native as jax_native
from mp3tpu.bitstream import unpack as jax_unpack
from mp3tpu.config import resolve as jax_resolve
from mp3tpu.container import frames as jax_frames
from mp3tpu.container import id3 as jax_id3
from mp3tpu.container import xing as jax_xing
from mp3tpu.oracle import decoder as jax_oracle
from mp3tpu_torch.bitstream import native
from mp3tpu_torch.bitstream import unpack
from mp3tpu_torch.config import resolve
from mp3tpu_torch.container import frames, id3, xing
from mp3tpu_torch.kernels import build
from mp3tpu_torch.oracle import decoder as oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = os.path.join(REPO, "tests", "torch_clips")
CLIP_S, TRACK_S, SR = 10.0, 60.0, 44100


# ---- the committed clips: the inputs of chip_smoke.py and mp3tpu_torch.bench,
# as the encoder made them

def bench_signal() -> np.ndarray:
    """bench.py's 10 s stereo signal (bench.py:58-65, bench_configs._signal),
    clipped as bench.py:66 clips it for its fixture."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_configs", os.path.join(REPO, "bench_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return np.clip(mod._signal(CLIP_S), -0.99, 0.99)


def clip_pcm(name: str) -> tuple:
    """(PCM, encode_pcm keyword arguments) of one committed clip."""
    cbr = {"bitrate": 128, "noise_shaping": False}
    if name == "track60":  # 20 s each of the three clips' signals
        third = TRACK_S / 3
        sig = np.concatenate([fixtures.tone_sweep(third, SR),
                              fixtures.transients(third, SR),
                              fixtures.tonal_stereo(third, SR)])
        return sig, {**cbr, "short_blocks": True, "joint_stereo": True}
    if name.startswith("bench_"):
        # mp3tpu_torch.bench's decode inputs (bench.py's CBR 128k joint
        # stereo fixture and bench_configs.py's VBR joint stereo one, made
        # here instead of by LAME), noise shaping on as LAME's is
        rate = {"bitrate": 128} if name == "bench_cbr128" else {"vbr_quality": 4}
        return bench_signal(), {**rate, "joint_stereo": True,
                                "noise_shaping": True}
    return {"sweep": (fixtures.tone_sweep(CLIP_S, SR), cbr),
            "transients": (fixtures.transients(CLIP_S, SR),
                           {**cbr, "short_blocks": True}),
            "tonal": (fixtures.tonal_stereo(CLIP_S, SR),
                      {**cbr, "joint_stereo": True})}[name]


def encode_clip(name: str) -> bytes:
    from mp3tpu.encoder import encode_pcm
    sig, kw = clip_pcm(name)
    return encode_pcm(sig, SR, device_transform=False, device_loops=False, **kw)


CLIP_NAMES = ("sweep", "transients", "tonal", "track60", "bench_cbr128",
              "bench_vbr")


@pytest.mark.parametrize("name", CLIP_NAMES)
def test_committed_clip_reencodes_byte_identical(name):
    with open(os.path.join(CLIPS, f"{name}.mp3"), "rb") as f:
        assert encode_clip(name) == f.read()


@pytest.mark.parametrize("name", CLIP_NAMES)
def test_port_reencodes_committed_clip_byte_identical(name):
    """mp3tpu_torch.encode on the CPU (the float64 host path) reproduces
    each committed clip."""
    import mp3tpu_torch
    sig, kw = clip_pcm(name)
    with open(os.path.join(CLIPS, f"{name}.mp3"), "rb") as f:
        assert mp3tpu_torch.encode(sig, SR, device="cpu", device_loops=False,
                                   **kw) == f.read()


# ---- fixtures covering every stereo mode, block flavor and LSF rate

def _lame(name, **kw):
    pytest.importorskip("lameref")
    return fixtures.lame_fixture(name, **kw)


def _intensity(mode_ext):
    from test_intensity import POS, _ch0, _ch1_sf
    craft = pytest.importorskip("craft")
    return craft.craft_stream_stereo((_ch0(10), _ch1_sf(POS)), mode=1,
                                     mode_ext=mode_ext)


def _lsf_intensity(mode_ext):
    from test_intensity import _lsf_ch0, _lsf_ch1
    craft = pytest.importorskip("craft")
    return craft.craft_stream_lsf_stereo(
        (_lsf_ch0(), _lsf_ch1([1, 2, 3, 4, 0, 5, 6] + [1] * 14, 0)), mode=1,
        mode_ext=mode_ext)


def _block(mixed):
    from test_blocks import PAIRS_30
    craft = pytest.importorskip("craft")
    return craft.craft_stream(craft.GranuleSpec(
        part2_3_length=len(PAIRS_30), big_values=30, window_switching=1,
        block_type=2, mixed_block_flag=mixed, subblock_gain=(1, 2, 0),
        table_select=(1, 1, 0), main_bits=PAIRS_30))


def _tagged(data):
    """ID3v2 (TIT2, TPE1) ahead of the stream and an ID3v1 tag after it."""
    def frame(fid, text):
        body = b"\x03" + text.encode()
        return fid + len(body).to_bytes(4, "big") + b"\x00\x00" + body
    body = frame(b"TIT2", "Clip") + frame(b"TPE1", "Port") + bytes(64)
    n = len(body)
    size = bytes((n >> s) & 0x7F for s in (21, 14, 7, 0))
    v1 = (b"TAG" + b"Title".ljust(30, b"\0") + b"Artist".ljust(30, b"\0")
          + b"Album".ljust(30, b"\0") + b"2026" + bytes(30) + b"\x0c")
    return b"ID3\x03\x00\x00" + size + body + data + v1


STREAMS = {
    "lame_mono": lambda: _lame("sweep", ch=1, bitrate=128, mode="mono"),
    "lame_ms": lambda: _lame("tonal", bitrate=96, mode="jstereo", force_ms=True),
    "lame_short_blocks": lambda: _lame("transients", ch=2, bitrate=128,
                                       mode="jstereo"),
    "lame_vbr_xing": lambda: _lame("sweep", ch=2, vbr=True, mode="jstereo"),
    "lame_lsf_22050": lambda: _lame("sweep", ch=2, bitrate=64,
                                    mode="jstereo", sr=22050),
    "intensity": lambda: _intensity(0b01),
    "ms_intensity": lambda: _intensity(0b11),
    "lsf_intensity": lambda: _lsf_intensity(0b01),
    "short_block": lambda: _block(0),
    "mixed_block": lambda: _block(1),
    "lsf_11025": lambda: fixtures.lsf_fixture(sample_rate=11025, frames=12),
    "lsf_16000": lambda: fixtures.lsf_fixture(sample_rate=16000, frames=12),
    "lsf_8000": lambda: fixtures.lsf_fixture(sample_rate=8000, frames=12),
    "own_tagged": lambda: _tagged(fixtures.own_fixture("tonal")),
}


@pytest.fixture(params=sorted(STREAMS))
def stream(request):
    return STREAMS[request.param]()


def as_dict(obj):
    """A dataclass (or tuple of them) as plain values, arrays as lists."""
    if dataclasses.is_dataclass(obj):
        return {k: as_dict(v) for k, v in vars(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [as_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: as_dict(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.tolist())
    return obj


def assert_symbols_equal(got, want):
    assert type(got).__module__.startswith("mp3tpu_torch.")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_container_scan_and_tags(stream):
    buf = np.frombuffer(stream, np.uint8)
    tag, want_tag = id3.parse_id3v2(stream), jax_id3.parse_id3v2(stream)
    assert as_dict(tag) == as_dict(want_tag)
    assert id3.parse_id3v1(stream) == jax_id3.parse_id3v1(stream)
    got = frames.scan_frames(buf, start=tag.size)
    want = jax_frames.scan_frames(buf, start=tag.size)
    assert as_dict(got) == as_dict(want)
    off, h = int(got.offsets[0]), got.headers[0]
    info = xing.parse_stream_info(stream, off, h)
    want_info = jax_xing.parse_stream_info(
        stream, int(want.offsets[0]), want.headers[0])
    assert as_dict(info) == as_dict(want_info)
    assert xing.is_metadata_frame(info) == jax_xing.is_metadata_frame(want_info)


def test_python_unpack(stream):
    body = stream[id3.parse_id3v2(stream).size:]
    assert_symbols_equal(unpack.unpack(body), jax_unpack.unpack(body))


def test_native_unpack(stream):
    if build.cxx_path() is None:
        pytest.skip("no g++ to build the port's C++ unpacker")
    body = stream[id3.parse_id3v2(stream).size:]
    want = jax_native.unpack_native(body)
    got = native.unpack_native(body)
    assert (got is None) == (want is None)
    if want is not None:
        assert_symbols_equal(got, want)
        assert_symbols_equal(got, unpack.unpack(body))


def test_oracle_pcm(stream):
    body = stream[id3.parse_id3v2(stream).size:]
    st, want_st = unpack.unpack(body), jax_unpack.unpack(body)
    got = oracle.decode_symbols(st)
    assert got.dtype == np.float64 and got.shape[0] > 0
    assert np.array_equal(got, jax_oracle.decode_symbols(want_st))


@pytest.mark.parametrize("env", [
    {},
    {"MP3TPU_DECODE_USE_NATIVE": "0", "MP3TPU_DECODE_PLANE_BITS": "8"},
    {"MP3TPU_DECODE_BATCH_CHUNK_STREAMS": "16", "MP3TPU_PLAYER_EQ_GAINS_DB":
     "1.5,-2,0", "MP3TPU_SCHEDULER_N_SLOTS": "8"},
])
def test_resolve_same_config(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = {"decode": {"gapless": False}, "player": {"speed": 0.75}}
    want = dataclasses.asdict(jax_resolve(**kw))
    # the port emits every row on the device, so it has no switch for it
    del want["encode"]["device_emit"]
    assert dataclasses.asdict(resolve(**kw)) == want


# ---- the encoder's host modules: each copy against its original

def _enc(pkg, mod):
    import importlib
    return importlib.import_module(f"{pkg}.encoder.{mod}")


def _enc_signal(seconds=0.3, ch=2, seed=0):
    """A tone, noise and a click: long, start, short and stop granules."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    sig = (0.3 * np.sin(2 * np.pi * 440 * t)[:, None] * np.array([1.0, 0.7])
           + 0.02 * rng.standard_normal((n, 2)))
    sig[n // 2: n // 2 + 200] += 0.6 * rng.standard_normal((200, 2))
    return sig[:, :ch]


def _quant_rows(rng, R=24):
    ix = np.zeros((R, 576), np.int32)
    for r in range(R):
        n = rng.integers(10, 300)
        pos = rng.choice(500, n, replace=False)
        ix[r, pos] = np.round(rng.standard_normal(n) *
                              rng.choice([1, 1, 2, 3, 8, 40])).astype(np.int32)
    return ix


def test_encoder_filterbank_and_transform():
    for fn in ("analysis_fir", "mdct_matrices", "forward_alias_matrices"):
        assert np.array_equal(getattr(_enc("mp3tpu_torch", "filterbank"), fn)(),
                              getattr(_enc("mp3tpu", "filterbank"), fn)()), fn
    x = _enc_signal()[: 12 * 576, 0]
    bts = np.array([0, 0, 1, 2, 2, 3, 0, 0, 1, 2, 3, 0])
    assert np.array_equal(
        _enc("mp3tpu_torch", "transform").granule_spectra(x, bts, SR),
        _enc("mp3tpu", "transform").granule_spectra(x, bts, SR))


@pytest.mark.parametrize("sr", [44100, 48000, 32000])
def test_encoder_psymodel(sr):
    port, orig = _enc("mp3tpu_torch", "psymodel"), _enc("mp3tpu", "psymodel")
    x = _enc_signal()[: 12 * 576]
    assert np.array_equal(port.align_to_mdct(x), orig.align_to_mdct(x))
    bts = port.block_type_sequence(port.align_to_mdct(x), sr)
    assert np.array_equal(bts, orig.block_type_sequence(orig.align_to_mdct(x), sr))
    assert (bts == 2).any()
    got = port.get_model(sr).analyze(x[:, 0], bts)
    want = orig.get_model(sr).analyze(x[:, 0], bts)
    assert np.array_equal(got.ratio_l, want.ratio_l)
    assert np.array_equal(got.ratio_s, want.ratio_s)
    e = np.random.default_rng(1).random(12 * 9) ** 8
    assert np.array_equal(port.block_types_from_subblock_energy(e),
                          orig.block_types_from_subblock_energy(e))


def test_encoder_bitwriter_huffcode_and_count():
    from mp3tpu.bitstream.bitwriter import BitWriter as JaxWriter
    from mp3tpu_torch.bitstream.bitwriter import BitWriter
    rng = np.random.default_rng(2)
    vals, lens = rng.integers(0, 1 << 12, 50), rng.integers(12, 20, 50)
    a, b = BitWriter(), JaxWriter()
    for w in (a, b):
        w.put(5, 3)
        w.put_array(vals, lens)
    assert a.bits == b.bits and a.to_bytes() == b.to_bytes()
    ix = _quant_rows(rng)
    port, orig = _enc("mp3tpu_torch", "huffcode"), _enc("mp3tpu", "huffcode")
    pv, ov = _enc("mp3tpu_torch", "vcount"), _enc("mp3tpu", "vcount")
    for bt in (0, 1, 2, 3):
        bits, sel = pv.count_bits_rows_full(ix, SR, bt)
        jbits, jsel = ov.count_bits_rows_full(ix, SR, bt)
        assert np.array_equal(bits, jbits)
        assert all(np.array_equal(sel[k], jsel[k]) for k in jsel)
        for r in range(0, len(ix), 4):
            g = port.encode_granule(ix[r], 180, SR, bt)
            j = orig.encode_granule(ix[r], 180, SR, bt)
            assert g.bits.bits == j.bits.bits and g.part2_3_length == bits[r]
            assert dataclasses.asdict(g).keys() == dataclasses.asdict(j).keys()
            assert (g.big_values, g.table_select, g.region0_count,
                    g.region1_count, g.count1table_select) == \
                (j.big_values, j.table_select, j.region0_count,
                 j.region1_count, j.count1table_select)


def test_encoder_loops():
    """The scalar loops of quantize and the numpy lockstep loops of vloop."""
    rng = np.random.default_rng(3)
    xr = rng.standard_normal((6, 576)) * np.exp(-np.arange(576) / 120)[None] \
        * rng.uniform(0.05, 1.0, (6, 1))
    budg = rng.integers(600, 2500, 6).astype(np.int64)
    en = (xr ** 2).sum(1) / 576
    xl = en[:, None] * rng.uniform(0.002, 0.3, (6, 21))
    xs = en[:, None, None] * rng.uniform(0.002, 0.3, (6, 3, 12))
    pq, oq = _enc("mp3tpu_torch", "quantize"), _enc("mp3tpu", "quantize")
    pv, ov = _enc("mp3tpu_torch", "vloop"), _enc("mp3tpu", "vloop")
    same = lambda a, b: all(np.array_equal(x, y) for x, y in zip(a, b))
    assert same(pq.inner_rate_loop(xr[0], int(budg[0]), SR),
                oq.inner_rate_loop(xr[0], int(budg[0]), SR))
    assert same(pq.outer_distortion_loop(xr[1], xl[1], int(budg[1]), SR),
                oq.outer_distortion_loop(xr[1], xl[1], int(budg[1]), SR))
    assert same(pq.outer_distortion_loop_short(xr[2], xs[2], int(budg[2]), SR),
                oq.outer_distortion_loop_short(xr[2], xs[2], int(budg[2]), SR))
    for bt in (0, 2):
        assert same(pv.inner_rate_rows(xr, budg, SR, bt),
                    ov.inner_rate_rows(xr, budg, SR, bt))
    assert same(pv.outer_rows(xr, xl, budg, SR, block_type=1),
                ov.outer_rows(xr, xl, budg, SR, block_type=1))
    assert same(pv.outer_rows_short(xr, xs, budg, SR),
                ov.outer_rows_short(xr, xs, budg, SR))
    assert pq.GG_WINDOW == oq.GG_WINDOW and pq.sf_jump_default()


def _coded_rows(rng, need):
    pv = _enc("mp3tpu_torch", "vcount")
    ix = _quant_rows(rng, 3 * need)
    bt = rng.choice([0, 0, 0, 2, 1, 3], len(ix))
    bits = np.array([pv.count_bits_rows(ix[i:i + 1], SR, int(bt[i]))[0]
                     for i in range(len(ix))])
    keep = np.nonzero(bits < 800)[0][:need]
    ix, bt = ix[keep], bt[keep]
    tsel = np.zeros((need, 3), np.int64)
    c1t = np.zeros(need, np.int64)
    for i in range(need):
        _b, sel = pv.count_bits_rows_full(ix[i:i + 1], SR, int(bt[i]))
        tsel[i] = (sel["t0"][0], sel["t1"][0], sel["t2"][0])
        c1t[i] = sel["c1table"][0]
    return ix, bt, tsel, c1t


@pytest.mark.parametrize("nch", [1, 2])
def test_encoder_mux_native_python_and_reservoir_mux(nch):
    """assemble_stream through the C++ mux == its Python version == the
    CodedGranule/ReservoirMux path == the JAX package's assemble_stream."""
    from mp3tpu.encoder import mux_packed as orig
    from mp3tpu_torch.encoder import mux_packed as port
    from mp3tpu_torch.encoder.huffcode import encode_granule
    from mp3tpu_torch.encoder.mux import FrameSizer, ReservoirMux
    rng = np.random.default_rng(5)
    n_frames = 12
    need = n_frames * 2 * nch
    ix, bt, tsel, c1t = _coded_rows(rng, need)
    gg = rng.integers(100, 250, need)
    coded = [encode_granule(ix[i], int(gg[i]), SR, int(bt[i]), tsel=tsel[i],
                            c1table=int(c1t[i])) for i in range(need)]
    ms_f = (rng.random(n_frames) < 0.5) & (nch == 2)
    mux = ReservoirMux(nch, 0, 9, FrameSizer(SR, 128000))
    for f in range(n_frames):
        mux.add_frame([[coded[f * 2 * nch + gr * nch + c] for c in range(nch)]
                       for gr in range(2)], bool(ms_f[f]))
    ref = mux.finish()
    bits_bytes = np.zeros((need, 520), np.uint8)
    for i, g in enumerate(coded):
        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
        bits_bytes[i, : len(row)] = row
    f = lambda k: np.array([getattr(g, k) for g in coded], np.int64)
    args = (bits_bytes, f("part2_3_length"), f("big_values"), gg,
            f("scalefac_compress"), bt, tsel, np.zeros((need, 3), np.int64),
            f("region0_count"), f("region1_count"), c1t, ms_f, nch, 0, 9, SR,
            128)
    assert port._assemble_native(*args) == ref
    assert port._assemble_python(*args) == ref
    assert port.assemble_stream(*args, require_native=True) == ref
    assert orig.assemble_stream(*args) == ref


ENCODE_CASES = {
    "cbr": dict(),
    "no_reservoir": dict(reservoir=False),
    "no_shaping": dict(noise_shaping=False, seconds=0.5),
    "long_only": dict(short_blocks=False),
    "plain_stereo": dict(joint_stereo=False, bitrate=192, noise_shaping=False),
    "mono": dict(ch=1, bitrate=64),
    "48k": dict(sr=48000, noise_shaping=False, seconds=0.5),
    "32k": dict(sr=32000, bitrate=96),
    "no_tag": dict(gapless_tag=False, noise_shaping=False),
    "vbr2": dict(vbr_quality=2),
    "vbr7": dict(vbr_quality=7, ch=1),
}


@pytest.mark.parametrize("case", ENCODE_CASES)
def test_encode_pcm_host_path_byte_identical(case):
    """encode_pcm's float64 host path (device_loops and device_transform
    off) gives the JAX package's bytes."""
    from mp3tpu.encoder import encode_pcm as jax_encode_pcm
    from mp3tpu_torch.encoder import encode_pcm
    kw = dict(ENCODE_CASES[case])
    sig = _enc_signal(kw.pop("seconds", 0.3), kw.pop("ch", 2))
    sr = kw.pop("sr", SR)
    want = jax_encode_pcm(sig, sr, device_loops=False, device_transform=False,
                          **kw)
    assert encode_pcm(sig, sr, device="cpu", **kw) == want
    assert len(frames.scan_frames(np.frombuffer(want, np.uint8)).offsets) >= 10


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    os.makedirs(CLIPS, exist_ok=True)
    for name in CLIP_NAMES:
        data = encode_clip(name)
        with open(os.path.join(CLIPS, f"{name}.mp3"), "wb") as f:
            f.write(data)
        print(name, len(data))
