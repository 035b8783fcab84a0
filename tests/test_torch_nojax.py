"""The PyTorch port stands alone: no file of src/mp3tpu_torch, and no line of
chip_smoke.py, imports JAX, the JAX package mp3tpu (any of it) or the test
fixtures, and a process where neither JAX nor mp3tpu can be imported
decodes, batch-decodes (to the host and to the device-resident handle), plays,
scans levels and segments in batches, encodes, transcodes, runs the command
line, the bench, the scheduler soak and a measurement tool with the port, as
on a GPU host without them. The port never imports the repository's tools/
either (the JAX package's harnesses and measurement tools, soak.py among
them), and no runtime module of the port imports its own measurement tools,
mp3tpu_torch.tools."""
import json
import os
import re
import subprocess
import sys

import numpy as np

import fixtures
import mp3tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "mp3tpu_torch")
IMPORT = re.compile(r"^\s*(?:from\s+(\S+)\s+import|import\s+([^#\n]+))", re.M)
# importlib.import_module("...") and __import__("...") by name
DYNAMIC = re.compile(r"""(?:import_module|__import__)\(\s*['"]([^'"]+)['"]""")
# the repository's tools/ are importable by their file names where tests
# run (tests/conftest.py puts tools/ on sys.path)
JAX_TOOLS = tuple(f[:-3] for f in os.listdir(os.path.join(REPO, "tools"))
                  if f.endswith(".py"))
FORBIDDEN = ("jax", "mp3tpu", "fixtures", "tools") + JAX_TOOLS
# "from . import tools", "from .. import x, tools"
TOOLS_BY_NAME = re.compile(r"^\s*from\s+\.+\s+import\s+[^#\n]*\btools\b", re.M)
CLIP = os.path.join(REPO, "tests", "torch_clips", "tonal.mp3")  # 10 s


def imported_modules(path):
    with open(path) as f:
        text = f.read()
    mods = []
    for frm, names in IMPORT.findall(text):
        # "import a.b as c, d" names a.b and d
        mods += [frm] if frm else [n.split()[0] for n in names.split(",")
                                   if n.strip()]
    return mods + DYNAMIC.findall(text)


def test_port_sources_import_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) >= 10
    names = {os.path.relpath(f, PORT) for f in files}
    assert {"cli.py", "bench.py", "soak.py", "sanitize.py", "api.py", "transfer.py",
            os.path.join("utils", "profiling.py"), os.path.join("parallel", "mesh.py"),
            os.path.join("parallel", "distributed.py"),
            os.path.join("kernels", "synth.py"),
            os.path.join("kernels", "huffman_dfa.py")} <= names
    assert {os.path.join("tools", f"{t}.py") for t in (
        "__init__", "device_huffman_spike", "bench_repeat", "bench_segment",
        "d2h_overlap_timing", "encode_single_profile", "rate_loop_hist")} <= names
    assert {"soak", "device_huffman_spike", "rate_loop_hist"} <= set(JAX_TOOLS)
    assert {os.path.join("encoder", f) for f in (
        "__init__.py", "batch.py", "device.py", "psy_device.py",
        "vloop_device.py", "emit_device.py", "tables.py",
        "mux_packed.py")} <= names
    for path in files:
        for mod in imported_modules(path):
            assert not any(mod == b or mod.startswith(b + ".")
                           for b in FORBIDDEN), (path, mod)


def test_runtime_modules_import_no_measurement_tool():
    """Only chip_smoke.py and mp3tpu_torch.tools itself import
    mp3tpu_torch.tools: the decode, encode and kernel paths never do."""
    tools = os.path.join(PORT, "tools")
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py") and not d.startswith(tools)]
    assert len(files) >= 60
    for path in files:
        with open(path) as f:
            assert not TOOLS_BY_NAME.search(f.read()), path
        for mod in imported_modules(path):
            name = mod.lstrip(".") if mod.startswith(".") else mod
            assert not (name == "tools" or name.startswith("tools.")
                        or mod.startswith("mp3tpu_torch.tools")), (path, mod)


def test_decodes_without_jax(tmp_path):
    data = fixtures.own_fixture("tonal")
    src = tmp_path / "clip.mp3"
    src.write_bytes(data)
    code = (
        "import sys; sys.modules['jax'] = sys.modules['mp3tpu'] = None\n"
        "import numpy as np, mp3tpu_torch\n"
        f"pcm, sr = mp3tpu_torch.decode({str(src)!r}, device='cpu')\n"
        f"[(b, _)] = mp3tpu_torch.decode_batch([{str(src)!r}], device='cpu')\n"
        f"np.save({str(tmp_path / 'pcm.npy')!r}, pcm)\n"
        f"np.save({str(tmp_path / 'batch.npy')!r}, b)\n"
        f"p = mp3tpu_torch.play({str(src)!r}, device='cpu', speed=0.75)\n"
        "p.play(); assert len(p.sink.pcm) > len(pcm)\n"
        f"mp3tpu_torch.levels({str(src)!r}, device='cpu')\n"
        f"[lv] = mp3tpu_torch.levels_batch([{str(src)!r}], device='cpu')\n"
        f"[sg] = mp3tpu_torch.segment_batch([{str(src)!r}], device='cpu')\n"
        "assert len(lv) == 2 and len(sg) >= 1\n"
        f"h = mp3tpu_torch.decode_batch([{str(src)!r}], device='cpu', "
        "output='device')\n"
        "assert isinstance(h, mp3tpu_torch.DecodedBatch)\n"
        "assert np.array_equal(h.numpy(0)[0], b)\n"
        "tone = 0.4 * np.sin(np.arange(12000) / 7.0)\n"
        "mp3 = mp3tpu_torch.encode(tone, 44100, device='cpu')\n"
        "assert len(mp3tpu_torch.decode(mp3, device='cpu')[0]) == 12000\n"
        "[one] = mp3tpu_torch.encode_batch([tone], 44100, device='cpu')\n"
        "assert mp3tpu_torch.encode(tone, 44100, device='cpu', "
        "device_loops=True) == one\n"
        f"[tc] = mp3tpu_torch.transcode_batch([{str(src)!r}], bitrate=96, "
        "device='cpu')\n"
        "assert mp3tpu_torch.decode(tc, device='cpu')[0].shape == pcm.shape\n"
        f"open({str(tmp_path / 'tc.mp3')!r}, 'wb').write(tc)\n"
        "from mp3tpu_torch import cli\n"
        f"cli.main(['info', {str(src)!r}, '--device', 'cpu'])\n"
        "from mp3tpu_torch import bench\n"
        "bench.SIZES.update(streams=2, win=8, frames=40)\n"
        "cli.main(['bench', '--device', 'cpu', '--reps', '1', '--no-api'])\n"
        "from mp3tpu_torch import soak\n"
        f"rep = soak.run_soak(total_audio_s=3.0, device='cpu', "
        f"pool=[open({CLIP!r}, 'rb').read()])\n"
        "assert rep['n_streams'] == rep['clean_streams_checked'] == 1\n"
        "[[_, kind, sink, want, got]] = rep['accounting']\n"
        "assert (kind, sink) == ('clean', 'check') and want == got > 0\n"
        "assert rep['clean_max_abs_lsb'] == 0 and rep['clean_misaligned'] == 0\n"
        "assert rep['card'] == 'cpu' and rep['steps'] > 0\n"
        "from mp3tpu_torch.tools import device_huffman_spike as spike\n"
        "spike.main(['--rows', '16', '--bits', '40', '--table', '31', "
        "'--reps', '1', '--host-iters', '0', '--device', 'cpu'])\n"
        "assert sys.modules['jax'] is None and sys.modules['mp3tpu'] is None\n"
        "print('ok', sr)\n")
    # one OpenMP thread, like the test workers (test_torch_decode.py)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    info, head, spike, ok = r.stdout.strip().splitlines()
    spike = json.loads(spike)
    assert (spike["table"], spike["rows"], spike["card"]) == (31, 16, None)
    assert json.loads(info)["sample_rate"] == 44100
    head = json.loads(head)
    assert head["metric"] == "aggregate_decode_realtime_factor" and head["checked"]
    assert ok.split() == ["ok", "44100"]
    want, _ = mp3tpu_torch.decode(data, device="cpu")
    assert np.array_equal(np.load(tmp_path / "pcm.npy"), want)
    wantb = mp3tpu_torch.decode_batch([data], device="cpu")[0][0]
    assert np.array_equal(np.load(tmp_path / "batch.npy"), wantb)
    [tc] = mp3tpu_torch.transcode_batch([data], bitrate=96, device="cpu")
    assert (tmp_path / "tc.mp3").read_bytes() == tc
