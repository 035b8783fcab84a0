"""The port's command line and the rest of its API on the CPU: every
subcommand of mp3tpu_torch.cli (with --device cpu) prints the JSON of
mp3tpu.cli.main on the same files, key for key; init(); global_metrics()."""
import contextlib
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import fixtures
import mp3tpu_torch
from mp3tpu import config as jax_config
from mp3tpu_torch import config as port_config
from test_torch_decode import assert_i16_close

jax_cli = importlib.import_module("mp3tpu.cli")
port_cli = importlib.import_module("mp3tpu_torch.cli")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# wall-clock fields of Metrics.to_dict(): present in both, never equal
CLOCKS = ("host_seconds", "device_seconds")


@pytest.fixture(autouse=True)
def small_chunks():
    """Chunks of 4 streams in both packages (the Player needs the windows of
    32 granules): the batch subcommands run at [4, 32] on the CPU."""
    for cfg in (jax_config, port_config):
        cfg.set_active(cfg.resolve(decode={"batch_chunk_streams": 4}))
    yield
    for cfg in (jax_config, port_config):
        cfg.set_active(cfg.resolve())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from mp3tpu.encoder import encode_pcm
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for name, data in (
            ("tonal", fixtures.own_fixture("tonal")),
            ("bursts", encode_pcm(fixtures.bursts(2.0, 44100, 2), 44100)),
            ("sweep", fixtures.own_fixture("sweep"))):
        out[name] = str(d / f"{name}.mp3")
        with open(out[name], "wb") as f:
            f.write(data)
    return out


def run(cli, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def assert_same_json(got, want, places=None, path="$"):
    """Equal key for key; floats to the rounding the CLI prints (`places`
    decimals: one unit of it), the clocks only as numbers."""
    assert type(got) is type(want), (path, got, want)
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            if k in CLOCKS:
                assert isinstance(got[k], float)
            else:
                assert_same_json(got[k], want[k], places, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, places, f"{path}[{i}]")
    elif isinstance(want, float) and places is not None:
        assert abs(got - want) <= 1.0001 * 10.0 ** -places, (path, got, want)
    else:
        assert got == want, (path, got, want)


def both(argv, places=None):
    want = json.loads(run(jax_cli, argv))
    got = json.loads(run(port_cli, argv + ["--device", "cpu"]))
    assert_same_json(got, want, places)
    return got


@pytest.mark.parametrize("name", ["tonal", "bursts"])
def test_info(files, name):
    got = both(["info", files[name]])
    assert got["sample_rate"] == 44100 and got["decode_errors"] == 0


def test_loudness(files):
    got = both(["loudness", files["tonal"], files["bursts"], files["sweep"]],
               places=2)
    assert list(got["tracks"]) == [files["tonal"], files["bursts"],
                                   files["sweep"]]
    got = both(["loudness", files["tonal"], "--target", "-20"], places=2)
    assert got["target_db"] == -20.0


def test_segments(files):
    got = both(["segments", files["bursts"], files["tonal"]], places=3)
    assert len(got[files["bursts"]]) == 3


def test_play_segments(files):
    assert len(both(["play", files["bursts"], "--segments"],
                    places=3)["segments"]) == 3


def test_split(files, tmp_path):
    want = json.loads(run(jax_cli, ["split", files["bursts"], "-d",
                                    str(tmp_path / "jax")]))
    got = json.loads(run(port_cli, ["split", files["bursts"], "-d",
                                    str(tmp_path / "port"), "--device", "cpu"]))
    assert list(got) == list(want) == ["clips"]
    assert [os.path.basename(p) for p in got["clips"]] == \
        [os.path.basename(p) for p in want["clips"]]
    for p in got["clips"]:
        assert os.path.getsize(p) > 44
    # -f mp3: the clips re-encoded in one encode_batch call; each decodes to
    # its WAV clip's length (the gapless tag) and sounds like it
    mp3s = json.loads(run(port_cli, [
        "split", files["bursts"], "-f", "mp3", "-b", "96", "-d",
        str(tmp_path / "mp3"), "--device", "cpu"]))["clips"]
    assert [os.path.basename(p)[:-4] for p in mp3s] == \
        [os.path.basename(p)[:-4] for p in got["clips"]]
    for m, w in zip(mp3s, got["clips"]):
        pcm, sr = mp3tpu_torch.decode(m, device="cpu")
        ref = wav_samples(w)
        assert sr == 44100 and pcm.shape == ref.shape
        err = pcm.astype(np.float64) - ref
        assert 10 * np.log10((ref.astype(np.float64) ** 2).mean()
                             / (err ** 2).mean()) > 12.0


def wav_bytes(pcm_i16, sr):
    import struct
    body = np.ascontiguousarray(pcm_i16, "<i2").tobytes()
    ch = pcm_i16.shape[1]
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * 2, ch * 2, 16)
            + b"data" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("extra", [["-b", "96"], ["--vbr-quality", "5"]],
                         ids=["cbr", "vbr"])
def test_encode(tmp_path, extra):
    """`encode` writes the bytes of mp3tpu.cli's `encode` (the float64 host
    path on the CPU) and prints its line up to the realtime factor."""
    sig = fixtures.tonal_stereo(0.4, 44100)
    src = tmp_path / "in.wav"
    src.write_bytes(wav_bytes(np.round(sig * 32767).astype(np.int16), 44100))
    want = run(jax_cli, ["encode", str(src), "-o", str(tmp_path / "j.mp3")]
               + extra)
    got = run(port_cli, ["encode", str(src), "-o", str(tmp_path / "p.mp3"),
                         "--device", "cpu"] + extra)
    assert (tmp_path / "p.mp3").read_bytes() == (tmp_path / "j.mp3").read_bytes()
    assert got.split("(")[0].replace("p.mp3", "j.mp3") == want.split("(")[0]
    assert got.split("(")[1].split(",")[0] == want.split("(")[1].split(",")[0]


def test_transcode(files, tmp_path):
    """`transcode` prints the JAX CLI's keys and writes streams that decode
    to the inputs' lengths."""
    argv = ["transcode", files["tonal"], files["sweep"], "-b", "96", "-d"]
    for d in ("jax", "port"):   # as the JAX CLI, the port makes no directory
        (tmp_path / d).mkdir()
    want = json.loads(run(jax_cli, argv + [str(tmp_path / "jax")]))
    got = json.loads(run(port_cli, argv + [str(tmp_path / "port"),
                                           "--device", "cpu"]))
    assert list(got) == list(want) == ["outputs", "wall_s"]
    assert [os.path.basename(p) for p in got["outputs"]] == \
        [os.path.basename(p) for p in want["outputs"]]
    for out, jout, src in zip(got["outputs"], want["outputs"],
                              (files["tonal"], files["sweep"])):
        assert os.path.getsize(out) == os.path.getsize(jout)
        pcm, _ = mp3tpu_torch.decode(out, device="cpu")
        ref, _ = mp3tpu_torch.decode(src, device="cpu")
        assert pcm.shape == ref.shape


def wav_samples(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF"
    return np.frombuffer(data[44:], "<i2").reshape(-1, 2)


def test_decode(files, tmp_path):
    out = str(tmp_path / "o.wav")
    line = run(port_cli, ["decode", files["tonal"], "-o", out, "--device", "cpu"])
    pcm, sr = mp3tpu_torch.decode(files["tonal"], device="cpu")
    assert line.startswith(f"decoded {len(pcm)} samples @ {sr} Hz -> {out} (")
    assert np.array_equal(wav_samples(out), pcm)
    run(jax_cli, ["decode", files["tonal"], "-o", str(tmp_path / "j.wav")])
    assert_i16_close(wav_samples(out), wav_samples(str(tmp_path / "j.wav")))
    run(port_cli, ["decode", files["tonal"], "-o", out, "--no-gapless",
                   "--device", "cpu"])
    raw, _ = mp3tpu_torch.decode(files["tonal"], gapless=False, device="cpu")
    assert np.array_equal(wav_samples(out), raw)


@pytest.mark.parametrize("extra", [
    ["--loop", "0.2:0.5", "--times", "2"], ["--seek", "0.4"],
    ["--normalize", "--eq", "3,2,1,0,-1,-2,-3,0,1,2"], ["--gain", "-3"]])
def test_play_to_wav(files, tmp_path, extra):
    argv = ["play", files["tonal"]] + extra
    want = json.loads(run(jax_cli, argv + ["-o", str(tmp_path / "j.wav")]))
    got = json.loads(run(port_cli, argv + ["-o", str(tmp_path / "p.wav"),
                                           "--device", "cpu"]))
    assert_same_json(got, want)
    a, b = wav_samples(str(tmp_path / "p.wav")), wav_samples(str(tmp_path / "j.wav"))
    assert len(a) == got["metrics"]["samples_out"] > 0
    assert_i16_close(a, b)


def test_play_segment_at_speed(files):
    got = both(["play", files["bursts"], "--segment", "1", "--times", "2",
                "--speed", "0.8"])
    assert got["metrics"]["samples_out"] > 0


def test_play_queue(files, tmp_path):
    argv = ["play", files["tonal"], files["sweep"], "--normalize"]
    want = json.loads(run(jax_cli, argv + ["-o", str(tmp_path / "j.wav")]))
    got = json.loads(run(port_cli, argv + ["-o", str(tmp_path / "p.wav"),
                                           "--device", "cpu"]))
    assert_same_json(got, want)
    assert got["tracks"] == 2
    assert_i16_close(wav_samples(str(tmp_path / "p.wav")),
                     wav_samples(str(tmp_path / "j.wav")))
    with pytest.raises(SystemExit, match="single input"):
        run(port_cli, argv + ["--seek", "1", "--device", "cpu"])


def test_practice(files, tmp_path):
    argv = ["practice", files["bursts"], "--times", "2", "--gap", "0.1",
            "--start", "1"]
    got = both(argv, places=3)
    assert len(got["sentences"]) == 2 and got["times"] == 2
    run(port_cli, argv + ["-o", str(tmp_path / "p.wav"), "--device", "cpu"])
    assert len(wav_samples(str(tmp_path / "p.wav"))) == \
        got["metrics"]["samples_out"]


def test_device_defaults_to_cuda_and_is_passed_down(files, monkeypatch):
    """--device is cuda unless given, before or after the subcommand, and
    every subcommand hands it to what it calls: with a device no host has,
    each one fails on that device's name (none falls back to the CPU)."""
    seen = {}
    monkeypatch.setattr(port_cli, "_cmd_info",
                        lambda args: seen.update(device=args.device))
    for argv, want in ((["info", "x"], "cuda"),
                       (["--device", "cpu", "info", "x"], "cpu"),
                       (["info", "x", "--device", "cuda:1"], "cuda:1"),
                       (["--device", "cpu", "info", "--device", "cuda:2", "x"],
                        "cuda:2")):
        port_cli.main(argv)
        assert seen["device"] == want, argv
    monkeypatch.undo()
    f = files["tonal"]
    for argv in (["decode", f, "-o", os.devnull], ["play", f],
                 ["play", f, "--segments"], ["play", f, "--normalize"],
                 ["play", f, files["sweep"]], ["practice", f],
                 ["segments", f], ["split", f], ["loudness", f],
                 ["transcode", f], ["bench"]):
        with pytest.raises(RuntimeError, match="(?i)device"):
            run(port_cli, argv + ["--device", "nosuchdevice"])


def test_help_lists_the_subcommands():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "mp3tpu_torch.cli", "--help"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--device" in r.stdout
    assert ("{decode,play,info,practice,segments,encode,transcode,split,"
            "loudness,bench}") in r.stdout


def test_console_script_is_registered():
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["mp3tpu-torch"] == "mp3tpu_torch.cli:main"
    assert scripts["mp3tpu"] == "mp3tpu.cli:main"


# ------------------------------------------------------------------ API

def test_api_surface():
    for name in ("init", "decode", "decode_batch", "segment", "segment_batch",
                 "split", "loudness", "levels", "levels_batch", "encode",
                 "encode_batch", "transcode_batch", "global_metrics", "play",
                 "DecodedBatch"):
        assert callable(getattr(mp3tpu_torch, name)), name
    import mp3tpu.api
    from mp3tpu_torch import api
    public = {n for n in vars(mp3tpu.api) if not n.startswith("_")
              and callable(getattr(mp3tpu.api, n))}
    assert len(public) == 14 and public <= set(vars(api))
    importlib.import_module("mp3tpu_torch.bench")
    assert callable(mp3tpu_torch.bench.main)


def test_bench(monkeypatch):
    """`bench` runs mp3tpu_torch.bench.main in this process (the JAX CLI runs
    the repository's bench.py): at cut sizes on the CPU it prints the
    headline last, with the API figures unless --no-api."""
    from mp3tpu_torch import bench
    from test_torch_bench import CUT, run_lines
    monkeypatch.setattr(bench, "SIZES", dict(CUT))   # chunks of 4: small_chunks
    lines = run_lines(port_cli.main, ["bench", "--device", "cpu", "--reps", "1"])
    assert lines[-1]["metric"] == "aggregate_decode_realtime_factor"
    assert lines[-1]["checked"] is True
    d = lines[-1]["detail"]
    assert d["device"] == "cpu" and d["runs_x"] == [lines[-1]["value"]]
    assert "api_device_batch_x" in d
    lines = run_lines(port_cli.main, ["--device", "cpu", "bench", "--reps", "1",
                                      "--no-api"])
    assert len(lines) == 1 and "api_device_batch_x" not in lines[0]["detail"]


def test_init_cpu_sets_config_and_warms():
    from mp3tpu_torch.kernels import pipeline as tp
    cfg = port_config.resolve(decode={"window_granules": 8})
    try:
        before = dict(tp._DECODERS)
        got = mp3tpu_torch.init(cfg, sample_rates=(22050, 44100), n_streams=3,
                                device="cpu")
        assert got is cfg and port_config.get_active() is cfg
        assert {k[0] for k in tp._DECODERS} >= {22050, 44100}
        # no arguments: the resolved defaults
        assert mp3tpu_torch.init(sample_rates=(), device="cpu") == \
            port_config.resolve()
        # one process: the distributed arguments do nothing
        assert mp3tpu_torch.init(cfg, sample_rates=(), num_processes=1,
                                 process_id=0, device="cpu") is cfg
        del before
    finally:
        port_config.set_active(port_config.resolve())


@pytest.mark.parametrize("n", [2, 8])
def test_init_more_processes_raises(n):
    """More processes initialise a torch.distributed group; one that cannot
    be joined (a coordinator without a port, a rank outside the world) raises
    and leaves the active config as it was."""
    import torch.distributed as dist
    before = port_config.get_active()
    cfg = port_config.resolve(decode={"window_granules": 16})
    bad = ({"distributed_coordinator": "localhost", "process_id": 0} if n == 2
           else {"distributed_coordinator": "localhost:1234", "process_id": n})
    with pytest.raises(ValueError):
        mp3tpu_torch.init(cfg, sample_rates=(), num_processes=n, device="cpu",
                          **bad)
    assert port_config.get_active() is before
    assert not dist.is_initialized()


def test_init_joins_a_process_group():
    """init(distributed_coordinator=...) with one process stands up a gloo
    group of one rank on the CPU: the collectives are identities over it."""
    import socket
    import torch.distributed as dist
    from mp3tpu_torch import parallel as par
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        # a step behind the join fails (no tables for this rate): the group
        # is left again and the active config put back, so init can be retried
        before = port_config.get_active()
        with pytest.raises(Exception):
            mp3tpu_torch.init(port_config.resolve(decode={"window_granules": 16}),
                              sample_rates=(12345,), num_processes=1, process_id=0,
                              distributed_coordinator=f"127.0.0.1:{port}",
                              device="cpu")
        assert not dist.is_initialized()
        assert port_config.get_active() is before
        cfg = mp3tpu_torch.init(sample_rates=(), num_processes=1, process_id=0,
                                distributed_coordinator=f"127.0.0.1:{port}",
                                device="cpu")
        assert cfg == port_config.resolve()
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert par.rank_slice(5) == slice(0, 5)
        x = np.arange(10, dtype=np.int16).reshape(5, 2)
        assert np.array_equal(par.gather_to_host0(x), x)
        assert par.gather_to_host0([b"a", b"bc"]) == [b"a", b"bc"]
        assert par.allreduce_metric(2.5) == 2.5
    finally:
        par.shutdown_distributed()
        port_config.set_active(port_config.resolve())
    assert not dist.is_initialized()


def test_global_metrics_counts_every_path(files):
    g = mp3tpu_torch.global_metrics()
    from mp3tpu_torch import metrics
    assert g is metrics.GLOBAL
    before = g.frames_ok
    mp3tpu_torch.decode(files["tonal"], device="cpu")
    one = g.frames_ok - before
    assert one > 0
    mp3tpu_torch.levels_batch([files["tonal"]] * 2, device="cpu")
    assert g.frames_ok - before == 3 * one
    assert "frames_ok" in json.loads(g.log_line())["mp3tpu_metrics"]
