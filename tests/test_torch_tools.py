"""The port's measurement tools (mp3tpu_torch.tools) on the CPU at tiny
sizes: each tool's main prints lines whose keys are its JAX counterpart's
in tools/ (read from that file's source: its main's dict literals) plus the
port's own, named ones; each tool's own checks hold; and where the two
packages compare, the port against the JAX package on the same bytes:
bench_repeat's granules decoded by one pass and by N equal the JAX Player's,
segment_batch of 4 streams within one envelope hop of the JAX package's
(tests/test_torch_device_batch.py's tolerance), d2h_segments 1 and 2
bit-identical, rate_loop_hist's summarize equal to the JAX tool's. The
inputs are the committed bench clip cut to its first frames
(bench.SIZES["frames"]) and a short bench.signal()."""
import ast
import contextlib
import dataclasses
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import mp3tpu
from mp3tpu.player import Player as JaxPlayer
from mp3tpu_torch import bench, config
from mp3tpu_torch.tools import (EXTRA_KEYS, CheckFailed, bench_repeat,
                                bench_segment, d2h_overlap_timing,
                                device_huffman_spike, encode_single_profile,
                                rate_loop_hist)
from test_torch_device_batch import assert_segments_close

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 30          # the bench clip's first audio frames: about 0.8 s
SEGMENT = (0.2, 0.6)  # bench_repeat's loop on the cut clip


@pytest.fixture
def cut(monkeypatch):
    monkeypatch.setitem(bench.SIZES, "frames", FRAMES)
    monkeypatch.setattr(bench_repeat, "SEGMENT", SEGMENT)


def run_main(mod, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv + ["--device", "cpu"]) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def jax_patterns(name: str) -> list:
    """The keys of the dict literals in tools/<name>.py's main, as regular
    expressions (an f-string key's fields match digits)."""
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    pats = []
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    pats.append(re.escape(k.value))
                elif isinstance(k, ast.JoinedStr):
                    pats.append("".join(
                        re.escape(v.value) if isinstance(v, ast.Constant)
                        else r"\d+" for v in k.values))
    return pats


def assert_keys_are_jax(name: str, mod, line: dict, own=()):
    """The line has its tool's KEYS; its keys and its detail's are the JAX
    tool's, every one of which it has, but for EXTRA_KEYS and `own`."""
    assert set(line) == set(mod.KEYS)
    pats = jax_patterns(name)
    keys = set(line) | set(line.get("detail", {}))
    extra = {k for k in keys if not any(re.fullmatch(p, k) for p in pats)}
    assert extra == set(EXTRA_KEYS) | set(own), extra
    for p in pats:
        assert any(re.fullmatch(p, k) for k in keys), p
    assert line["device"] == "cpu" and line["card"] is None


def test_bench_repeat_cache_matches_jax_player(cut):
    [line] = run_main(bench_repeat, ["--times", "3"])
    assert_keys_are_jax("bench_repeat", bench_repeat, line)
    d = line["detail"]
    assert d["times"] == 3 and d["segment_s"] == pytest.approx(0.4)
    assert d["granules_decoded_times3"] == d["granules_decoded_times1"] > 0
    data = bench.fixture("cbr")
    for times in (1, 3):
        p = JaxPlayer(data, gain_db=bench_repeat.GAIN_DB)
        p.loop(*SEGMENT, times=times)
        assert p.metrics.granules_decoded == d[f"granules_decoded_times{times}"]
    with pytest.raises(ValueError):
        bench_repeat.measure(1, "cpu")


def test_bench_segment_matches_jax(cut):
    """The 4 streams are copies of one clip: the first's segments (all of
    them, under 3) within one envelope hop of the JAX package's for every
    stream of the same batch."""
    [line] = run_main(bench_segment, ["--streams", "4"])
    assert_keys_are_jax("bench_segment", bench_segment, line)
    d = line["detail"]
    assert d["streams"] == 4
    pcm, sr = mp3tpu.decode(bench.fixture("cbr"))
    assert d["audio_seconds"] == 4 * len(pcm) / sr
    want = mp3tpu.segment_batch([bench.fixture("cbr")] * 4)
    assert d["segments_per_file"] == len(d["first"]) < 3
    for w in want:
        assert_segments_close(d["first"], w)


def test_d2h_overlap_k1_and_k2_bit_identical(cut):
    caller = config.get_active()
    lines = run_main(d2h_overlap_timing, ["--reps", "2", "--streams", "2",
                                          "--ks", "1,2"])
    assert config.get_active() is caller       # the caller's settings back
    assert [ln["d2h_segments"] for ln in lines] == [1, 2]
    for ln in lines:
        assert_keys_are_jax("d2h_overlap_timing", d2h_overlap_timing, ln)
        assert len(ln["walls_s"]) == 2 and ln["best_x"] >= ln["median_x"] > 0
    assert lines[0]["audio_s"] == lines[1]["audio_s"] > 0


def test_d2h_overlap_raises_when_k_changes_the_pcm(cut, monkeypatch):
    """The check itself: PCM that differs at one K fails the run."""
    from mp3tpu_torch import pipeline
    real = pipeline.decode_files

    def drifting(paths, **kw):
        out = real(paths, **kw)
        if config.get_active().decode.d2h_segments == 2:
            out[0] = (out[0][0] + 1, out[0][1])
        return out

    monkeypatch.setattr(pipeline, "decode_files", drifting)
    with pytest.raises(CheckFailed, match="d2h_segments=2"):
        d2h_overlap_timing.measure(1, 1, (1, 2), "cpu")


def test_encode_single_profile(monkeypatch):
    """On the CPU encode_pcm takes the float64 host path (no phases); with
    the device loops asked for in the config, the device encoder at B=1 and
    its phase walls."""
    before = os.environ.get("MP3TPU_ENCODE_PROFILE")
    [line] = run_main(encode_single_profile, ["--reps", "1", "--seconds", "1"])
    assert os.environ.get("MP3TPU_ENCODE_PROFILE") == before  # restored
    assert_keys_are_jax("encode_single_profile", encode_single_profile, line,
                        own=("route",))
    assert line["route"] == "host" and line["phases_best"] == {}
    assert line["mp3_bytes"] > 0 and len(line["walls_s"]) == 1
    caller = config.get_active()
    monkeypatch.setattr(config, "_ACTIVE", dataclasses.replace(
        caller, encode=dataclasses.replace(caller.encode, device_loops="on")))
    line = encode_single_profile.measure(1, 1.0, "cpu")
    assert line["route"] == "device_loops"
    assert {"stage", "passA", "passB", "mux"} <= set(line["phases_best"])


def test_rate_loop_hist():
    [line] = run_main(rate_loop_hist, ["--streams", "2", "--seconds", "1"])
    assert_keys_are_jax("rate_loop_hist", rate_loop_hist, line)
    assert line["B"] == 2 and set(line["classes"]) >= {"long"}
    assert {"passA", "passB"} <= set(line["prof"])
    for c in line["classes"].values():
        assert c["rows"] == sum(c["hist"]) and c["p50"] <= c["p90"] <= c["max"]
    assert "MP3TPU_ITER_HIST" not in os.environ


def jax_summarize():
    """tools/rate_loop_hist.py's summarize, compiled from its source (the
    module sets environment variables when imported)."""
    with open(os.path.join(REPO, "tools", "rate_loop_hist.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "summarize")
    ns = {"np": np}
    exec(compile(ast.Module([fn], []), "rate_loop_hist.py", "exec"), ns)
    return ns["summarize"]


@pytest.mark.parametrize("hist", [[0, 8, 0, 6, 16, 66, 60, 3], [0, 0, 5], [],
                                  [1]])
def test_summarize_matches_jax(hist):
    want = jax_summarize()(hist)
    got = rate_loop_hist.summarize(hist)
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    assert round(got["mean"], 2) == want["mean"]
    assert round(got["at_max_frac"], 4) == want["at_max_frac"]
    assert {k: v for k, v in got.items() if k not in ("mean", "at_max_frac")} \
        == {k: v for k, v in want.items() if k not in ("mean", "at_max_frac")}


def test_device_huffman_spike():
    """One case on the CPU with the host profile: the JAX tool's figures,
    the plain version's counts (the kernel is not there), the host's
    Huffman sections, and no device figure."""
    [line] = run_main(device_huffman_spike, [
        "--rows", "64", "--bits", "264", "--table", "24", "--reps", "2",
        "--host-iters", "2"])
    assert set(line) == set(device_huffman_spike.KEYS)
    assert line["device"] == "cpu" and line["card"] is None
    assert (line["table"], line["rows"], line["bits"], line["n_states"]) == \
        (24, 64, 264, 265)
    assert line["completed"] > 0 and len(line["walls_ms"]) == 2
    assert line["ms_steady"] == min(line["walls_ms"])
    for k in ("kernel_ms", "bound_ms", "bound_share", "sm_clock_mhz"):
        assert line[k] is None                  # measured on a card only
    host = line["host"]
    assert host["iters"] == 2 and host["huff_big_values_cycles_per_stream"] > 0
    assert line["host_section_ms_per_stream"] == \
        host["huff_big_values_ms_per_stream"] > 0
    assert line["host_over_chain"] > 0


def test_spike_cases_and_bench_shape():
    """Without --rows and --bits: the JAX tool's case (131,072 x 256 bits,
    256 streams) and the bench's shape, 256 x the clip's 1,536
    granule-channels at its mean part2_3_length rounded up to 32 bits."""
    shape = device_huffman_spike.bench_shape()
    assert shape["granule_channels"] == 1536
    assert shape["bits"] % 32 == 0
    assert shape["bits"] - 32 < shape["mean_part2_3_length"] <= shape["bits"]
    cases = device_huffman_spike.cases()
    assert cases[0] == ("default", "count1a", 131072, 256, 256.0)
    assert [c[1] for c in cases[1:]] == ["count1a", 13, 24]
    assert all(c[0] == "bench" and c[2:] == (256 * 1536, shape["bits"], 256)
               for c in cases[1:])
