"""Fuzzing and sanitizing the port's native code (mp3tpu_torch/sanitize.py;
counterpart of tests/test_fuzz_native.py and tools/mux_asan_fuzz.py): the
C++ unpacker parses untrusted bytes and must never crash or scribble, and
its copy in the port must agree with the port's Python unpacker and with the
JAX package's native unpacker on garbage. The ASan/UBSan builds of
kernels/build.py run here on the CPU; the device cases of the sanitizer run
here through the plain versions, held to the JAX package's XLA path."""
import faulthandler
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.bitstream import native as jax_native
from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch import sanitize
from mp3tpu_torch.bitstream import native
from mp3tpu_torch.bitstream.unpack import unpack
from mp3tpu_torch.container import frames as fr
from mp3tpu_torch.kernels import build
from mp3tpu_torch.kernels import fused_z as fz
from mp3tpu_torch.kernels import synth as sy
from mp3tpu_torch.kernels.tables import build_tables
from test_torch_fused_z import Z_REL_TOL
from test_torch_synth import TOL as SYNTH_TOL

faulthandler.enable()
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(REPO, "tests", "torch_clips", "sweep.mp3")
FIELDS = ("is_", "exp", "block_type", "mixed", "smode", "errors",
          "huff_slack", "lines_used")
no_gxx = pytest.mark.skipif(build.cxx_path() is None, reason="no g++")


@pytest.fixture(scope="module")
def builds():
    """The four g++ builds these tests run (the fuzz harness, the sanitized
    and the production library, the profiler), all at once: about 25 s
    from nothing, the sanitized library the longest."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as ex:
        prof = ex.submit(build.build_tool, "prof_main.cpp")
        sanitize.build_host()
        prof.result()


def clip_head(n_frames: int = 120) -> bytes:
    """The first `n_frames` frames of the committed sweep clip (joint
    stereo, 128 kbps, made by mp3tpu's encoder)."""
    with open(CLIP, "rb") as f:
        data = f.read()
    idx = fr.scan_frames(np.frombuffer(data, np.uint8))
    return data[:int(idx.offsets[n_frames])]


@pytest.mark.skipif(not native.available(), reason="native unpacker unavailable")
def test_fuzz_random_bytes():
    rng = np.random.default_rng(42)
    for _ in range(50):
        n = int(rng.integers(8, 20000))
        junk = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        st = native.unpack_native(junk)   # None or a valid SymbolTensors
        if st is not None:
            assert st.n_granules >= 1


@pytest.mark.skipif(not native.available(), reason="native unpacker unavailable")
@pytest.mark.parametrize("other", ["port Python", "JAX package native"])
def test_fuzz_mutated_stream_parity(other):
    """Byte-flipped real streams: the port's native unpacker agrees field
    for field with the port's Python unpacker, and with the JAX package's
    native unpacker, even on garbage (the same error policy)."""
    if other == "JAX package native" and not jax_native.available():
        pytest.skip("the JAX package's native unpacker is unavailable")
    base = bytearray(clip_head())
    rng = np.random.default_rng(7)
    compared = 0
    for trial in range(8):
        bad = bytearray(base)
        for _ in range(40):
            i = int(rng.integers(0, len(bad)))
            bad[i] ^= int(rng.integers(1, 256))
        data = bytes(bad)
        if other == "port Python":
            try:
                a = unpack(data)
            except ValueError:
                continue
        else:
            a = jax_native.unpack_native(data)
            if a is None:
                assert native.unpack_native(data) is None
                continue
        b = native.unpack_native(data)
        assert b is not None
        for f in FIELDS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), (trial, f)
        compared += 1
    assert compared >= 4


def test_crc_detection():
    """CRC-protected frames with corrupted side info must fail the port's
    check (ISO §2.4.3.1); craft one, as tests/test_fuzz_native.py does."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from craft import GranuleSpec, craft_frame
    frame = bytearray(craft_frame(GranuleSpec()))
    frame[1] &= 0xFE    # protection bit on (bit 16 of the header)
    # a CRC16 placeholder after the header (the frame grows by 2)
    protected = bytes(frame[:4]) + b"\x12\x34" + bytes(frame[4:-2])
    buf = np.frombuffer(protected, np.uint8)
    h = fr.parse_header(int.from_bytes(protected[:4], "big"))
    assert h.crc_protected
    assert not fr.check_crc16(buf, 0, h)  # the placeholder CRC must fail


@no_gxx
def test_asan_fuzz_driver(builds):
    """csrc/fuzz_main.cpp built under ASan/UBSan from csrc/ alone and run
    on random bytes and a mutated real stream, in all four plane modes."""
    rep = sanitize.fuzz_unpacker(clip_head(), iters=100)
    assert rep["iters"] == 100
    exe = build.build_tool("fuzz_main.cpp")
    assert exe.parent == build.build_dir()
    assert "-fsanitize=address,undefined" in build.TOOL_FLAGS["fuzz_main.cpp"]


@no_gxx
@pytest.mark.parametrize("kind", ["mux", "encode_rows"])
def test_sanitized_library_fuzz(kind, builds):
    """300 trials of mp3tpu_mux_stream (tools/mux_asan_fuzz.py's scheme) or
    of mp3tpu_encode_rows through the ASan/UBSan library in a child with
    the runtime preloaded: no report, every result in bounds and equal to
    the production library's."""
    fn = {"mux": sanitize.fuzz_mux, "encode_rows": sanitize.fuzz_encode_rows}
    rep = fn[kind](trials=300)
    assert rep["kind"] == kind and rep["trials"] == 300
    if kind == "mux":
        assert rep["ok"] + rep["refused"] == 300 and rep["refused"] > 0
    else:
        assert rep["rows"] > 300 and 0 < rep["overflowed"] < rep["rows"]


@no_gxx
def test_sanitized_builds_leave_the_production_library(builds):
    """The sanitized library and the harnesses build into the build directory
    under names of their own; the production library's flags carry no
    sanitizer and its name is the one bitstream/native.py loads."""
    asan, prod = build.build_sanitized(), build.build("unpack.cpp")
    assert asan.parent == prod.parent == build.build_dir()
    assert asan.name.startswith("unpack-asan-") and asan != prod
    assert not any("sanitize" in f for f in build.CXX_FLAGS)
    assert build.SANITIZE_FLAGS == ("-O1", "-g", "-std=c++17", "-fPIC",
                                    "-fsanitize=address,undefined")
    assert str(prod) == native._load()._name


BROKEN = {
    "asan": ("int main() { int* p = new int[4]; p[4] = 1; "
             "int r = p[0]; delete[] p; return r; }",
             "heap-buffer-overflow"),
    "ubsan": ("#include <climits>\n#include <cstdlib>\n"
              "int main(int c, char**) { int x = INT_MAX - 1 + c; "
              "return (x + c) > 0 ? 0 : 1; }",
              "runtime error"),
}


@no_gxx
@pytest.mark.parametrize("what", sorted(BROKEN))
def test_a_sanitizer_report_fails_the_run(what, tmp_path):
    """run_sanitized fails a program whose sanitizer reports (a heap
    overflow; a signed overflow, on which UBSan alone would carry on), with
    the report in the error."""
    code, words = BROKEN[what]
    src, exe = tmp_path / "broken.cpp", tmp_path / "broken"
    src.write_text(code)
    subprocess.run([build.cxx_path(), "-O0", "-g", "-fsanitize=address,undefined",
                    "-o", str(exe), str(src)], check=True)
    with pytest.raises(sanitize.SanitizerError, match=words):
        sanitize.run_sanitized([str(exe)], what)


@no_gxx
def test_section_profiler(builds):
    """csrc/prof_main.cpp with the unpacker's cycle counters: every named
    section and the per-table fast-LUT rates, for a few iterations."""
    rep = sanitize.profile(iters=3)
    assert rep["iters"] == 3 and rep["granules"] > 0
    names = [s["name"] for s in rep["sections"]]
    assert set(sanitize.SECTIONS) <= set(names)
    shares = sum(s["share"] for s in rep["sections"] if s["name"] != "spec_total(outer)")
    assert 99.0 <= shares <= 101.0
    assert {t["table"] for t in rep["tables"]} >= {32}
    assert all(0.0 <= t["fast_hit"] <= 100.0 for t in rep["tables"])


# compute-sanitizer's own words, as it printed them on an H100 it refused,
# and the summaries it prints
SANITIZER_TEXT = {
    "unsupported": ("========= COMPUTE-SANITIZER\n========= Error: Device not "
                    "supported. Please refer to the \"Supported Devices\" section"
                    " of the sanitizer documentation\n=========\n", 9, None),
    "clean": ("========= COMPUTE-SANITIZER\n========= ERROR SUMMARY: 0 errors\n",
              0, 0),
    "errors": ("========= Invalid __global__ read of size 4 bytes\n"
               "========= ERROR SUMMARY: 3 errors\n", 86, None),
    "racecheck": ("========= RACECHECK SUMMARY: 1 hazard displayed (1 error, "
                  "0 warnings)\n", 86, None),
    "no summary": ("Traceback (most recent call last):\n", 1, None),
}


@pytest.mark.parametrize("case", sorted(SANITIZER_TEXT))
def test_parse_sanitizer(case):
    text, rc, want = SANITIZER_TEXT[case]
    if case == "unsupported":
        with pytest.raises(sanitize.SanitizerUnavailable,
                           match="Device not supported. Please refer"):
            sanitize.parse_sanitizer("memcheck", "fused_z", rc, text)
    elif want is None:
        with pytest.raises(sanitize.SanitizerError):
            sanitize.parse_sanitizer("racecheck", "synth", rc, text)
    else:
        assert sanitize.parse_sanitizer("memcheck", "decode", rc, text) == want


# the device cases at the domain's extremes, through the plain versions on
# the CPU, against the JAX package's XLA path
FAMILIES = [(torch.int16, torch.int16), (torch.int32, torch.int32),
            (torch.int32, torch.int16)]


@pytest.mark.parametrize("beyond", [False, True], ids=["extremes",
                                                       "beyond the palette"])
@pytest.mark.parametrize("name", ["fused_z", "fused_frontend"])
def test_extreme_symbols_match_xla(name, beyond, monkeypatch):
    """Symbols and exponents at the extremes csrc/unpack.cpp writes, block
    types 0-3 with mixed flags of any byte, stereo bytes at the palette's
    end or beyond it: the port's plain version (with the palette padded by
    zero rows, which is what the kernel computes there) within Z_REL_TOL of
    the XLA path, whose one-hot stereo matrix gives zeros there too."""
    args = sanitize.extreme_symbols(3, 8, seed=2, types=(torch.int32, torch.int32),
                                    bt_dtype=torch.int8, device="cpu",
                                    beyond_palette=beyond)
    assert int(args[0].abs().max()) == sanitize.IS_MAX
    assert {int(args[1].min()), int(args[1].max())} == {sanitize.EXP_MIN,
                                                         sanitize.EXP_MAX}
    tables = build_tables(44100, "cpu")
    plain = (sanitize.padded_palette(tables) if beyond else tables)
    a = [t.numpy() for t in args]
    a[3] = a[3].astype(bool)
    plain_fn = {"fused_z": fz.fused_pipeline_z_reference,
                "fused_frontend": fz.fused_frontend_reference}[name]
    got = plain_fn(*args, plain).numpy()
    if name == "fused_z":
        monkeypatch.setattr(kp, "_backend", lambda z, state, tables, S, G: (z, state))
    else:
        monkeypatch.setattr(kp, "_imdct_and_backend", lambda v, *rest: v)
    want = kp._granule_pipeline_xla(*(jnp.asarray(x) for x in a),
                                    kp.init_state(3), kp.build_tables(44100))
    want = np.asarray(want[0] if name == "fused_z" else want).reshape(got.shape)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= Z_REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("types", FAMILIES, ids=lambda t: "/".join(
    str(x).replace("torch.", "") for x in t))
def test_extreme_symbols_same_in_every_family(types):
    """The extremes fit every plane family the kernel reads: each gives the
    int32 family's plain output exactly."""
    tables = build_tables(44100, "cpu")
    ref = sanitize.extreme_symbols(2, 4, seed=3, types=(torch.int32, torch.int32),
                                   bt_dtype=torch.int32, device="cpu")
    args = sanitize.extreme_symbols(2, 4, seed=3, types=types,
                                    bt_dtype=torch.int8, device="cpu")
    plain = fz.fused_pipeline_z_reference
    assert torch.equal(plain(*args, tables), plain(*ref, tables))


@pytest.mark.parametrize("label", ["3x3", "3x4", "3x5", "2x32 at 1e9"])
def test_synth_cases_match_jax(label):
    """The synthesis cases around the kernel's tile of 4 granules and at
    the loudest z: the plain version within the synthesis tests' TOL of the
    JAX package's _backend."""
    z, st = next((z, st) for lab, z, st in sanitize.synth_cases("cpu")
                 if lab == label)
    S, G = z.shape[:2]
    pcm, new = sy.synth_backend(z, st, build_tables(44100, "cpu"))
    want, new_j = kp._backend(jnp.asarray(z.numpy()),
                              {k: jnp.asarray(v.numpy()) for k, v in st.items()},
                              kp.build_tables(44100), S, G)
    want = np.asarray(want)
    assert np.abs(pcm.numpy() - want).max() <= SYNTH_TOL * np.abs(want).max()
    for k in ("overlap", "hist"):
        w = np.asarray(new_j[k])
        assert np.abs(new[k].numpy() - w).max() <= SYNTH_TOL * np.abs(w).max()


def test_ring_cases_straddle_grid_times_stages():
    """The pair counts of the ring cases sit at the persistent grid times
    its stages, minus one, exactly, plus one: where the ring wraps and a
    block's last load into a consumed stage is skipped."""
    cases = sanitize.fused_cases("cpu")
    for name in ("fused_z", "fused_frontend"):
        ring = sanitize.FZ_STAGES * sanitize.persistent_grid(name, "cpu")
        counts = sorted(c[2][0].shape[0] for c in cases
                        if c[0] == name and "pairs (grid" in c[1])
        assert counts == [ring - 1, ring, ring + 1]
    labels = {c[1] for c in cases if c[0] == "fused_z"}
    for S, G in sanitize.FUSED_SHAPES:
        assert sum(f" {S}x{G}" in lab for lab in labels) == 6  # every family


def test_decode_case_streams():
    """The whole-path case's streams: three clean clips, one of each of
    soak.py's corruptions, a junk stream the scan takes; salted random
    bytes have no frame the scan takes."""
    streams = sanitize.decode_streams()
    assert len(streams) == 7
    junk = dict(streams)["junk 60 frames"]
    assert fr.scan_frames(np.frombuffer(junk, np.uint8)).n_frames == 60
    with pytest.raises(ValueError):
        fr.scan_frames(np.frombuffer(sanitize.salted_bytes(20000, 4), np.uint8))


@pytest.mark.parametrize("stray", ["none", "before", "after", "unwritten"])
def test_guards_catch_stray_and_missing_writes(stray):
    """A guarded output passes only when every value of it was written and
    no word of either guard band was."""
    buf, out = sanitize.guarded((3, 2, 5), "cpu")
    out.fill_(0.5)
    n, g = out.numel(), sanitize.GUARD
    if stray == "before":
        buf[g - 1] = 0
    elif stray == "after":
        buf[g + n] = 0
    elif stray == "unwritten":
        out[1, 1, 4] = torch.tensor(sanitize.GUARD_BITS, dtype=torch.int32).view(
            torch.float32)
    if stray == "none":
        sanitize.check_guards(buf, n, "clean")
    else:
        with pytest.raises(AssertionError, match="outside the output|never written"):
            sanitize.check_guards(buf, n, stray)
    assert out.data_ptr() % 16 == 0 and out.is_contiguous()


@pytest.mark.cuda
def test_device_cases_on_card():
    """The sanitizer's kernel and whole-path cases on the card: guarded,
    rerun bit-identical, each within its tolerance of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    recs = sanitize.run_device_cases("cuda")
    assert all(r.get("worst_over_tol", 0.0) <= 1.0 for r in recs)
    assert {r.get("kernel") for r in recs} >= {"fused_z", "fused_frontend", "synth"}
