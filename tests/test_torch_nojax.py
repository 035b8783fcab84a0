"""The PyTorch port needs no JAX: no file of src/mp3tpu_torch imports it or
the JAX-bound parts of mp3tpu, and a process where JAX cannot be imported
decodes a file with it, as on a GPU host without JAX."""
import os
import re
import subprocess
import sys

import numpy as np

import fixtures
import mp3tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "mp3tpu_torch")
IMPORT = re.compile(r"^\s*(?:from\s+(\S+)\s+import|import\s+([^\s,]+))", re.M)
JAX_BOUND = ("mp3tpu.kernels", "mp3tpu.pipeline", "mp3tpu.dsp", "mp3tpu.player",
             "mp3tpu.parallel", "mp3tpu.api")


def imported_modules(path):
    with open(path) as f:
        return [a or b for a, b in IMPORT.findall(f.read())]


def test_port_sources_import_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) >= 10
    for path in files:
        for mod in imported_modules(path):
            assert mod != "jax" and not mod.startswith("jax."), (path, mod)
            assert not any(mod == b or mod.startswith(b + ".") for b in JAX_BOUND), \
                (path, mod)


def test_decodes_without_jax(tmp_path):
    data = fixtures.own_fixture("tonal")
    src = tmp_path / "clip.mp3"
    src.write_bytes(data)
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, mp3tpu_torch\n"
        f"pcm, sr = mp3tpu_torch.decode({str(src)!r}, device='cpu')\n"
        f"[(b, _)] = mp3tpu_torch.decode_batch([{str(src)!r}], device='cpu')\n"
        f"np.save({str(tmp_path / 'pcm.npy')!r}, pcm)\n"
        f"np.save({str(tmp_path / 'batch.npy')!r}, b)\n"
        f"p = mp3tpu_torch.play({str(src)!r}, device='cpu', speed=0.75)\n"
        "p.play(); assert len(p.sink.pcm) > len(pcm)\n"
        f"mp3tpu_torch.levels({str(src)!r}, device='cpu')\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok', sr)\n")
    # one OpenMP thread, like the test workers (test_torch_decode.py)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", "44100"]
    want, _ = mp3tpu_torch.decode(data, device="cpu")
    assert np.array_equal(np.load(tmp_path / "pcm.npy"), want)
    wantb = mp3tpu_torch.decode_batch([data], device="cpu")[0][0]
    assert np.array_equal(np.load(tmp_path / "batch.npy"), wantb)
