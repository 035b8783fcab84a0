"""The port's own host modules (src/mp3tpu_torch/{container,bitstream,tables,
oracle}, config.py) held against the JAX package's on the CPU, on the
fixtures of test_oracle_mpg123 (LAME: mono, MS, short blocks, VBR/Xing, LSF),
test_intensity (crafted intensity and MS+intensity, MPEG-1 and LSF),
test_blocks (crafted short and mixed blocks) and test_lsf (self-hosted LSF
at every LSF rate); and the committed clips of tests/torch_clips/, which
chip_smoke.py decodes, re-encoded byte for byte by the JAX package's
encoder.

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

CLIPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_clips")
CLIP_S, TRACK_S, SR = 10.0, 60.0, 44100


# ---- the committed clips: chip_smoke.py's inputs, as the encoder made them

def clip_pcm(name: str) -> tuple:
    """(PCM, encode_pcm keyword arguments) of one committed clip."""
    if name == "track60":  # 20 s each of the three clips' signals
        third = TRACK_S / 3
        sig = np.concatenate([fixtures.tone_sweep(third, SR),
                              fixtures.transients(third, SR),
                              fixtures.tonal_stereo(third, SR)])
        return sig, {"short_blocks": True, "joint_stereo": True}
    return {"sweep": (fixtures.tone_sweep(CLIP_S, SR), {}),
            "transients": (fixtures.transients(CLIP_S, SR),
                           {"short_blocks": True}),
            "tonal": (fixtures.tonal_stereo(CLIP_S, SR),
                      {"joint_stereo": True})}[name]


def encode_clip(name: str) -> bytes:
    from mp3tpu.encoder import encode_pcm
    sig, kw = clip_pcm(name)
    return encode_pcm(sig, SR, bitrate=128, noise_shaping=False,
                      device_transform=False, device_loops=False, **kw)


CLIP_NAMES = ("sweep", "transients", "tonal", "track60")


@pytest.mark.parametrize("name", CLIP_NAMES)
def test_committed_clip_reencodes_byte_identical(name):
    with open(os.path.join(CLIPS, f"{name}.mp3"), "rb") as f:
        assert encode_clip(name) == f.read()


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
    assert (dataclasses.asdict(resolve(**kw))
            == dataclasses.asdict(jax_resolve(**kw)))


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    os.makedirs(CLIPS, exist_ok=True)
    for name in CLIP_NAMES:
        data = encode_clip(name)
        with open(os.path.join(CLIPS, f"{name}.mp3"), "wb") as f:
            f.write(data)
        print(name, len(data))
