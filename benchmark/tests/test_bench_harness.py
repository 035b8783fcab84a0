"""The harness: BENCHMARK.json against its contract, cells, mixes and
metrics found by name, the result line, seeded inputs, no fallback to the
CPU, and no JAX in the benchmark's process."""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_its_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"]: w for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in b["end_to_end"]
                                  if w in x.get("workloads", cells)}
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        reported = [m["name"] for m in b["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["source"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_cells_mixes_and_metrics_are_found_by_name():
    from mp3bench import spec
    b = bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert spec.load_entry(cell.entry).prepare
        assert os.path.isfile(spec.traffic_path(w["traffic"]))
        for m in cell.per_layer:
            assert callable(spec.load_metric(m["name"]).read)
    for m in b["per_layer"]:
        assert os.path.isfile(spec.metric_path(m["name"]))


def test_a_new_config_mix_and_metric_are_new_files_only(tmp_path, small):
    """A dummy configuration, traffic mix and per-layer metric, added as new
    files and new entries of BENCHMARK.json in a copy, run whole."""
    from mp3bench import main
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    b = bench()
    cfg = json.loads((tmp_path / "benchmark/configs/cbr320.json").read_text())
    cfg["name"] = "dummy"
    (tmp_path / "benchmark/configs/dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "benchmark/traffic/batch_decode.json").read_text())
    mix["parts_per_stream"] = 1
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/dummy_count.decode.py").write_text(
        "def instrument(probe):\n"
        "    probe.count('dummy', 'mp3tpu_torch.pipeline', 'stream_meta')\n"
        "def read(ctx):\n"
        "    return ctx.probe.counts.get('dummy') or None\n")
    b["configs"].append({"name": "dummy", "source": "https://example.org",
                         "file": "benchmark/configs/dummy.json",
                         "reduced": ["clip_seconds"], "why": "a test"})
    b["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                           "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "decode_x":
            m["workloads"].append("dummy.dummy_mix")
    b["per_layer"].append({"name": "dummy_count.decode", "unit": "calls",
                           "better": "lower", "source": "program_counter",
                           "layer": "Container scan", "moves": "decode_x",
                           "workloads": ["dummy.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = small("dummy.dummy_mix", root=str(tmp_path))
    r = main.measure(cell, 5, 0.5, True, 0.0, device="cpu", log=lambda s: None)
    assert r["correct"] and r["metrics"]["dummy_count.decode"]["value"] >= 8
    assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contract_keys(small, trace):
    from mp3bench import main
    cell = small("cbr320.batch_decode")
    lines = []
    r = main.measure(cell, 2 ** 31 + 99, 0.5, bool(trace), 0.0,
                     device="cpu", log=lines.append)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 8
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    want = ({m["name"] for m in cell.per_layer} if trace
            else {"decode_x", "setup_s"})
    if trace:
        assert set(r["metrics"]) <= want and "device.idle_share.decode" in r["metrics"]
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert all(len(r["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    else:
        assert set(r["metrics"]) == want
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    assert [json.loads(s)["log"] for s in lines] == ["facts", "calls"]


@pytest.mark.parametrize("workload", ["cbr320.batch_decode",
                                      "cbr128.upload_encode",
                                      "cbr320.rendition_transcode"])
def test_seeded_inputs_repeat_exactly(small, workload):
    from mp3bench import spec
    cell = small(workload)
    entry = spec.load_entry(cell.entry)
    a, b, c = (entry.prepare(cell, s) for s in (2 ** 31 + 5, 2 ** 31 + 5, 6))

    def flat(w):
        return [np.asarray(x).tobytes() if not isinstance(x, bytes) else x
                for batch in w.batches for x in batch.inputs]
    assert flat(a) == flat(b) and flat(a) != flat(c)
    # another seed changes the order, not the work
    assert sorted(map(len, flat(a))) == sorted(map(len, flat(c)))


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cbr320.batch_decode", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "does not fall back" in r.stderr


def test_a_checkout_with_only_the_benchmark_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cbr320.batch_decode", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_names_are_compared_whole():
    from mp3bench import main
    saved = {k: sys.modules.get(k) for k in ("mp3tpu", "mp3tpu.x")}
    try:
        assert "mp3tpu" not in main.forbidden_modules()
        sys.modules["mp3tpu.x"] = sys
        assert main.forbidden_modules() == ["mp3tpu"]
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_no_jax_in_the_benchmarks_process():
    """Everything a run loads, and a whole run on the CPU, in a fresh
    process: no module named jax, jaxlib, flax or mp3tpu."""
    code = (
        "import sys, glob, os\n"
        f"sys.path[:0] = [{BENCH!r}, {os.path.join(ROOT, 'src')!r}, "
        f"{os.path.join(BENCH, 'tests')!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from mp3bench import main, spec, faults, trace\n"
        "import mp3bench.reference, mp3bench.reference.audit\n"
        "from mp3bench.entries import decode_files, encode_batch, transcode_batch\n"
        f"for f in glob.glob({os.path.join(BENCH, 'metrics', '*.py')!r}):\n"
        "    spec.load_metric(os.path.basename(f)[:-3])\n"
        "from mp3bench import compose\n"
        "from conftest import cut_clips\n"
        "orig = compose.load_corpus\n"
        "compose.load_corpus = lambda c, r: cut_clips(orig(c, r), 8)\n"
        "cell = spec.load_cell('cbr320.batch_decode')\n"
        "cell.traffic.update(streams_per_call=8, distinct_batches=1, check_streams=2)\n"
        "cell.traffic['warmup'] = {'min_calls': 1, 'max_calls': 1, 'agree_pct': 3}\n"
        "r = main.measure(cell, 3, 0.2, True, 0.0, device='cpu', log=lambda s: None)\n"
        "assert r['correct']\n"
        "print('FORBIDDEN', main.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FORBIDDEN []" in r.stdout


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cbr320.batch_decode", "--seed", str(2 ** 31 + 7),
                        "--seconds", "3", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0


def test_a_trace_reduces_to_busy_time_kernels_and_idle_by_range():
    from mp3bench.peaks import fused_z_per_pair
    from mp3bench.trace import reduce
    fz = "void (anonymous namespace)::fused_z_kernel<int, short, false>(int const*)"
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "bench.scan", "ts": 10, "dur": 30},
          {"ph": "X", "cat": "user_annotation", "name": "mp3tpu.decode_chunk[0:5]",
           "ts": 50, "dur": 40},
          {"ph": "X", "cat": "kernel", "name": fz, "ts": 60, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
           "ts": 45, "dur": 5}]
    r = reduce(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(20e-6)     # the late kernel clipped to 5
    assert r["copies"] == {"HtoD": [1, pytest.approx(5e-6)]}
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"bench.scan": 30e-6, "mp3tpu.decode_chunk": 30e-6,
         "(between ranges)": 20e-6})
    assert ["fused_z_kernel<int, short, false>", pytest.approx(10e-6)] in r["device_ops"]
    # 2 x 576 int32 lines, 2 x 64 int16 exponents, 68 bytes of flags and
    # palette indices in; z [2, 32, 36] float32 out
    assert fused_z_per_pair(fz)[0] == 4608 + 256 + 68 + 9216
