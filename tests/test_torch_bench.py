"""mp3tpu_torch.bench, the port's counterpart of bench.py and bench_configs.py,
on the CPU at cut sizes: config 3's int16 PCM against the JAX package's
decode_all_windows_flat_resampled_i16 on the same planes, in the 4-bit arena
family and in a forced 12-bit staging; the headline's keys; one JSON line a
configuration under bench_configs.py's names; the checks are live."""
import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch import bench
from mp3tpu_torch import config as port_config
from test_torch_decode import assert_i16_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 4 streams, windows of 8 granules, the clips cut to 120 frames (3.1 s), 2
# streams for the API figures, encode batches of 2 and 3 streams of 0.3 s
CUT = {"streams": 4, "win": 8, "api_streams": 2, "batches": (2, 3),
       "seconds": 0.3, "frames": 120}
CONFIGS = ("1_single_file_cbr_decode", "2_vbr_joint_stereo_decode",
           "3_batched_256_resample48k", "4_player_seek_gapless_dsp",
           "5_encode_path_single", "5_encode_batch_aggregate",
           "5_encode_batch_64")
HEADLINE_DETAIL = ("streams", "audio_seconds", "pipeline_s", "host_unpack_s",
                   "stage_s", "device_s", "host_x", "device_x",
                   "device_compute_only_x", "upload_gbps", "plane_bits",
                   "exp_bytes", "api_decode_batch_x", "api_decode_batch_s",
                   "api_device_batch_x", "api_device_batch_s", "protocol",
                   "runs_x", "spread", "card", "torch", "cuda")


@contextlib.contextmanager
def cut_sizes():
    """The bench at CUT, and decode_files in chunks of 4 streams (its chunks
    of 64 would decode 62 silent rows on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "SIZES", dict(CUT))
        port_config.set_active(port_config.resolve(
            decode={"batch_chunk_streams": 4}))
        try:
            yield
        finally:
            port_config.set_active(port_config.resolve())


@pytest.fixture
def cut():
    with cut_sizes():
        yield


def run_lines(main, argv) -> list:
    """The JSON lines main(argv) prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.fixture(scope="module")
def configs_run():
    with cut_sizes():
        return run_lines(bench.main, ["--device", "cpu", "--reps", "2",
                                      "--configs"])


def test_signal_is_bench_configs_signal():
    """The encode lines' input is bench_configs.py's signal, sample for
    sample (bench.py's fixture signal is the same formula)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_configs", os.path.join(REPO, "bench_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert np.array_equal(bench.signal(10.0), mod._signal(10.0))
    q = bench.q16(bench.signal(1.0))
    assert np.array_equal(q * 32768.0, np.rint(q * 32768.0))


@pytest.mark.parametrize("plane_bits", [4, 12])
def test_config3_matches_jax(cut, plane_bits):
    """Config 3 at S=4, windows of 8 granules: the bench's int16 PCM at 48
    kHz within 1 LSB and at least 98% exact of the JAX package's program on
    the same window-major planes; the clip lands in the 4-bit family (one
    arena a window), and plane_bits=12 stages the six planes apart."""
    c3, runs, first, _inputs, checks = bench.measure_config3(
        bench.fixture("cbr"), 4, 8, 1, "cpu", plane_bits)
    if plane_bits == 4:
        assert (c3.bits, c3.exp_bytes) == (4, True) and c3.arena is not None
    else:
        assert c3.bits == 12 and c3.arena is None
        assert c3.staged_bytes == sum(a.nbytes for a in c3.planes.values())
    assert c3.planes["bt"].shape[:3] == (c3.n_win, 4, 8) and c3.n_win == 30
    want, _, _ = kp.decode_all_windows_flat_resampled_i16(
        *(jnp.asarray(c3.planes[k]) for k in bench.PLANES), kp.init_state(4),
        kp.init_resample_state(4, 44100), 44100, 48000, c3.bits)
    assert_i16_close(first.numpy(), np.asarray(want))
    assert len(runs) == 1 and set(runs[0]) == {
        "host_unpack_s", "stage_s", "device_s", "device_compute_only_s"}
    assert checks["reruns_bit_identical"] == 1
    assert checks["against_cpu"]["streams"] == [0, 3]
    assert checks["against_cpu"]["peak"] > 0


def test_headline_keys(configs_run):
    head = configs_run[0]
    assert head["metric"] == "aggregate_decode_realtime_factor"
    assert list(head) == ["metric", "value", "unit", "checked", "detail"]
    assert head["checked"] is True and head["value"] > 0
    d = head["detail"]
    assert set(HEADLINE_DETAIL) <= set(d)
    assert d["streams"] == 4 and d["plane_bits"] == 4 and d["exp_bytes"] is True
    assert d["protocol"] == "median-of-2-in-process" and len(d["runs_x"]) == 2
    assert head["value"] in d["runs_x"]
    assert len(d["api_device_batch_runs_s"]) == len(d["api_decode_batch_runs_s"]) == 2
    assert d["device"] == "cpu" and d["card"] is None
    assert d["checks"]["against_cpu"]["max_lsb"] <= 1


def test_configs_lines(configs_run):
    """One line a configuration, under bench_configs.py's names and keys,
    each with its runs, spread and checks."""
    with open(os.path.join(REPO, "bench_configs.py")) as f:
        source = f.read()
    lines = configs_run[1:]
    assert [line["config"] for line in lines] == list(CONFIGS)
    for line in lines:
        assert f'"{line["config"]}"' in source
        assert line["checked"] is True and line["device"] == "cpu"
        assert len(line["runs_x"]) == len(line["runs_s"]) == 2
        assert line["x_realtime"] in line["runs_x"] and line["spread"] >= 0
        assert {"audio_seconds", "wall_seconds", "x_realtime"} <= set(line)
    by = {line["config"]: line for line in lines}
    assert by["3_batched_256_resample48k"]["x_realtime"] == configs_run[0]["value"]
    assert by["4_player_seek_gapless_dsp"]["seeks"] == 1
    assert by["5_encode_path_single"]["input"] == "int16-origin"
    for name, n in (("5_encode_batch_aggregate", 2), ("5_encode_batch_64", 3)):
        assert by[name]["streams"] == n and by[name]["noise_shaping"] is True
        assert by[name]["checks"]["streams_decode_to_input_length"] == n
        assert by[name]["audio_seconds"] == pytest.approx(0.3 * n)
    for name in CONFIGS[:2]:
        assert by[name]["checks"]["against_decode"]["max_lsb"] <= 1


def corrupt_second(fn, spoil):
    """fn, with its second call's result spoiled."""
    calls = []

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        calls.append(1)
        return spoil(out) if len(calls) == 2 else out
    return wrapped


def test_corrupted_config3_rerun_raises(cut, monkeypatch):
    monkeypatch.setattr(bench.Config3, "decode", corrupt_second(
        bench.Config3.decode, lambda pcm: pcm ^ 1))
    with pytest.raises(bench.CheckFailed, match="config 3.*bit-identical"):
        bench.main(["--device", "cpu", "--reps", "2", "--no-api"])


def test_corrupted_chunked_rerun_raises(cut, monkeypatch):
    from mp3tpu_torch import pipeline as pl

    def spoil(pcm):
        pcm = pcm.copy()
        pcm[1000, 0] += 1
        return pcm
    monkeypatch.setattr(pl, "decode_symbols_chunked",
                        corrupt_second(pl.decode_symbols_chunked, spoil))
    with pytest.raises(bench.CheckFailed, match="1_single_file.*bit-identical"):
        bench.config_single("1_single_file_cbr_decode", bench.fixture("cbr"), 2,
                            "cpu", {})


def test_corrupted_encode_rerun_raises(monkeypatch):
    from mp3tpu_torch import api
    monkeypatch.setattr(api, "encode_batch", corrupt_second(
        api.encode_batch, lambda blobs: [blobs[0][:-1] + b"\x01"] + blobs[1:]))
    pcms = [bench.q16(bench.signal(0.2) * s) for s in (0.5, 1.0)]
    with pytest.raises(bench.CheckFailed, match="rerun's bytes differ"):
        bench.config_encode("5_encode_batch_aggregate", pcms, 2, "cpu", {},
                            batch=True)


def test_median_run_and_spread():
    assert bench.median_index([3.0, 1.0, 2.0]) == 2
    assert bench.median_index([5.0, 1.0]) == 1      # the lower middle
    assert bench.spread([2.0, 1.0, 1.5]) == 1.0


def test_outside_a_checkout_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "CLIPS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="checkout"):
        bench.fixture("cbr")


def test_cuda_without_a_card_raises(monkeypatch):
    """--device cuda (the default) on a host without a card raises before it
    measures anything: there is no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda:0", "--configs"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(argv)
