"""Stream sharding of the PyTorch port (mp3tpu_torch.parallel) on the CPU:
the mesh and its sharding rule, the sharded decode steps against the
unsharded rows (and the JAX package's), the sharded encode_batch byte for
byte against the unsharded call and, across packages, against
mp3tpu.encoder.encode_batch over the 8-device mesh; the collectives with no
process group, and two gloo ranks spawned as child processes that meet on a
loopback port."""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp3tpu_torch
from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch import parallel as par
from mp3tpu_torch.bitstream import native
from mp3tpu_torch.container import frames as fr
from mp3tpu_torch.kernels import pipeline as tp
from mp3tpu_torch.parallel import mesh as pm
from mp3tpu_torch.pipeline import (load_symbols, probe_granules, stream_meta,
                                   unpack_planes)
from test_torch_decode import assert_i16_close, clip

torch.set_num_threads(1)
SR = 44100
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
requires_native = pytest.mark.skipif(not native.available(),
                                     reason="native unpacker unavailable")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_sharded_rows(got: np.ndarray, ref: np.ndarray):
    """What the JAX package holds its sharded steps to
    (tests/test_parallel.py): at most 1 LSB, over 99.9% exact."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.int16
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() > 0.999


# ---- the mesh and the rule

def test_mesh_creation():
    mesh = par.make_stream_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis_name == "streams"
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert par.make_stream_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="need"):
        par.make_stream_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        par.make_stream_mesh(2, device="meta")


@pytest.mark.parametrize("S,sizes", [(8, [1] * 8), (5, [1] * 5 + [0] * 3),
                                     (1, [1] + [0] * 7), (19, [3, 3, 3, 2, 2, 2, 2, 2])])
def test_stream_sharding_rule(S, sizes):
    """Contiguous, balanced, in stream order; empty shards when S < size."""
    sl = par.stream_sharding(par.make_stream_mesh(8, device="cpu")).slices(S)
    assert [s.stop - s.start for s in sl] == sizes
    assert sl[0].start == 0 and sl[-1].stop == S
    assert all(a.stop == b.start for a, b in zip(sl, sl[1:]))
    assert sl == [pm.shard_slice(S, 8, i) for i in range(8)]


@pytest.mark.parametrize("axis", (0, 1))
@pytest.mark.parametrize("S", (8, 5, 1))
def test_shard_batch_round_trip(S, axis):
    rng = np.random.default_rng(S)
    shape = (S, 3) if axis == 0 else (4, S, 3)
    tree = (rng.integers(-9, 9, shape).astype(np.int16),
            {"a": torch.from_numpy(rng.standard_normal(shape + (2,)).astype(np.float32)),
             "b": [rng.integers(0, 255, shape).astype(np.uint8)]})
    mesh = par.make_stream_mesh(8, device="cpu")
    parts = par.shard_batch(mesh, tree, axis=axis)
    assert len(parts) == 8
    sizes = [p[0].shape[axis] for p in parts]
    assert sum(sizes) == S and max(sizes) - min(sizes) <= 1
    assert all(isinstance(p[0], torch.Tensor) and p[1]["a"].shape[axis] == n
               for p, n in zip(parts, sizes))
    back = par.unshard(parts, axis=axis)
    assert torch.equal(back[0], torch.from_numpy(tree[0]))
    assert torch.equal(back[1]["a"], tree[1]["a"])
    assert torch.equal(back[1]["b"][0], torch.from_numpy(tree[1]["b"][0]))
    with pytest.raises(ValueError, match="different lengths"):
        par.shard_batch(mesh, (tree[0], tree[0][..., :0].reshape((0,) + shape[1:])
                               if axis == 0 else np.zeros((4, S + 1, 3))), axis=axis)


def test_unshard_numpy_and_skipped_shards():
    a, b = np.arange(6).reshape(3, 2), np.arange(4).reshape(2, 2)
    assert np.array_equal(par.unshard([a, None, b]), np.concatenate([a, b]))
    with pytest.raises(ValueError, match="no shard"):
        par.unshard([None])


# ---- the sharded decode steps

def symbols_batch(S: int, G: int = 32):
    """S streams of G granules: the three clips at different offsets."""
    sts = [load_symbols(clip(k))[0] for k in ("sweep", "transients", "tonal")]
    rows = []
    for s in range(S):
        st, off = sts[s % 3], 3 * (s // 3)
        rows.append([a[off:off + G] for a in (st.is_, st.exp, st.block_type,
                                              st.mixed, st.smode)])
    return tuple(np.stack([r[i] for r in rows]) for i in range(5))


@pytest.mark.parametrize("S,n_shards", [(8, 8), (5, 8), (8, 3)])
def test_sharded_decode_window_matches_unsharded(S, n_shards):
    batch = symbols_batch(S)
    ref, ref_state = tp.decode_window_i16(*map(t, batch),
                                          tp.init_state(S, device="cpu"), SR)
    mesh = par.make_stream_mesh(n_shards, device="cpu")
    got, state = par.sharded_decode_step(
        mesh, tp.decode_window_i16, batch, (tp.init_state(S, device="cpu"),), SR)
    assert_sharded_rows(got.numpy(), ref.numpy())
    for k in ("overlap", "hist"):
        assert state[k].shape == ref_state[k].shape
        assert torch.allclose(state[k], ref_state[k], rtol=0, atol=1e-6)
    # the same step written out, as a caller without the helper writes it
    parts = par.shard_batch(mesh, (batch, tp.init_state(S, device="cpu")))
    outs = [tp.decode_window_i16(*b, st, SR) if st["hist"].shape[0] else None
            for b, st in parts]
    assert torch.equal(par.unshard(outs)[0], got)
    # and the JAX package's unsharded step on the same symbols
    want, _ = kp.decode_window_i16(*map(jnp.asarray, batch), kp.init_state(S), SR)
    assert_i16_close(got.numpy(), np.asarray(want))


@requires_native
def test_sharded_packed_scan_resample_matches_unsharded():
    """The packed 4-bit planes -> window loop -> resample to 48 kHz step
    (what the multichip phase of chip_smoke.py runs), window-major planes cut
    along axis 1."""
    S, win = 8, 8
    bodies = [stream_meta(clip(k))[0] for k in ("tonal", "transients")] * 4
    Gs = [probe_granules(b) for b in bodies]
    planes, _errs, bits, _exp_bytes = unpack_planes(bodies, Gs, S, win, 4)
    keys = ("is12", "exp", "esc", "bt", "mx", "smode")
    args = tuple(planes[k] for k in keys)
    ref, _, ref_rs = tp.decode_all_windows_flat_resampled_i16(
        *map(t, args), tp.init_state(S, device="cpu"),
        tp.init_resample_state(S, SR, device="cpu"), SR, 48000, bits)
    mesh = par.make_stream_mesh(8, device="cpu")
    got, state, rs = par.sharded_decode_step(
        mesh, tp.decode_all_windows_flat_resampled_i16, args,
        (tp.init_state(S, device="cpu"), tp.init_resample_state(S, SR, device="cpu")),
        SR, 48000, bits, axis=1)
    assert got.shape[0] == S and state["hist"].shape[0] == S
    assert_sharded_rows(got.numpy(), ref.numpy())
    assert torch.allclose(rs, ref_rs, rtol=0, atol=1e-6)
    want, _, _ = kp.decode_all_windows_flat_resampled_i16(
        *map(jnp.asarray, args), kp.init_state(S), kp.init_resample_state(S, SR),
        SR, 48000, bits)
    assert_i16_close(got.numpy(), np.asarray(want))


# ---- the sharded encode

def tones(n: int, seconds: float = 0.3):
    rng = np.random.default_rng(3)
    tt = np.arange(int(seconds * SR)) / SR
    return [(0.3 * np.sin(2 * np.pi * (260 + 45 * i) * tt)
             + 0.02 * rng.standard_normal(len(tt))).astype(np.float32)
            for i in range(n)]


@pytest.fixture(scope="module")
def encoded8():
    pcms = tones(8)
    return pcms, mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cpu")


@pytest.mark.parametrize("n_shards", (8, 3))
def test_sharded_encode_batch_matches_unsharded(encoded8, n_shards):
    """Byte for byte: a stream's bytes do not depend on the batch it is in."""
    pcms, ref = encoded8
    mesh = par.make_stream_mesh(n_shards, device="cpu")
    got = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, mesh=mesh)
    assert [len(b) for b in got] == [len(b) for b in ref]
    assert all(a == b for a, b in zip(ref, got))


def test_sharded_encode_batch_unequal_lengths():
    """Streams of different lengths pad to their shard's longest, not the
    batch's: the bytes stay those of the unsharded call."""
    pcms = [p[: int((0.18 + 0.04 * i) * SR)] for i, p in enumerate(tones(4))]
    ref = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cpu")
    got = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cpu",
                                    mesh=par.make_stream_mesh(3, device="cpu"))
    assert got == ref


def snr_db(mp3, ref):
    dec, sr = mp3tpu_torch.decode(bytes(mp3), output="float32", device="cpu")
    assert sr == SR and len(dec) == len(ref)
    err = dec.astype(np.float64).reshape(-1) - ref.reshape(-1)
    return 10 * np.log10((ref.astype(np.float64) ** 2).mean()
                         / max((err ** 2).mean(), 1e-30))


def test_sharded_encode_batch_across_packages(encoded8):
    """The cross-package encoder contract under sharding: each stream has the
    size and the number of frames of the JAX package's sharded encode_batch,
    and decodes within 0.5 dB of its SNR (float32 searches flip at
    quantization boundaries; bytes are not compared across packages)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of the JAX package's mesh")
    from mp3tpu.encoder import encode_batch as jax_encode_batch
    from mp3tpu.parallel.mesh import make_stream_mesh as jax_mesh
    pcms, _ = encoded8
    got = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128,
                                    mesh=par.make_stream_mesh(8, device="cpu"))
    want = jax_encode_batch(pcms, SR, bitrate=128, mesh=jax_mesh(8))
    for g, w, pcm in zip(got, want, pcms):
        assert len(g) == len(w)
        assert (fr.scan_frames(np.frombuffer(g, np.uint8)).n_frames
                == fr.scan_frames(np.frombuffer(w, np.uint8)).n_frames)
        assert abs(snr_db(g, pcm) - snr_db(w, pcm)) <= 0.5


def test_encode_batch_mesh_and_device_must_agree():
    mesh = par.make_stream_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="not one of the mesh"):
        mp3tpu_torch.encode_batch(tones(2, 0.1), SR, mesh=mesh, device="cuda")


def test_sharded_encode_batch_mixed_channel_counts():
    """Mono beside stereo takes the stream-by-stream route: with a mesh each
    stream is encoded on its shard's device (here the CPU, with no `device`
    given), and the bytes are those of the unsharded call."""
    mono = tones(3, 0.15)
    pcms = [mono[0], np.stack([mono[1], mono[2]], axis=1), mono[2]]
    ref = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128, device="cpu")
    got = mp3tpu_torch.encode_batch(pcms, SR, bitrate=128,
                                    mesh=par.make_stream_mesh(2, device="cpu"))
    assert got == ref


def test_encode_batch_decoded_batch_with_mesh_goes_through_the_host():
    data = [clip("tonal"), clip("transients")]
    handle = mp3tpu_torch.decode_batch(data, device="cpu", output="device")
    ref = mp3tpu_torch.encode_batch(
        [p.astype(np.float64) / 32768.0 for p, _ in handle.numpy()], SR,
        bitrate=128, device="cpu")
    got = mp3tpu_torch.encode_batch(handle, bitrate=128,
                                    mesh=par.make_stream_mesh(2, device="cpu"))
    assert got == ref


# ---- the collectives

def test_collectives_with_no_group():
    x = np.arange(12, dtype=np.int16).reshape(6, 2)
    assert par.gather_to_host0(x) is x
    blobs = [b"ab", b"c"]
    assert par.gather_to_host0(blobs) is blobs
    assert par.rank_slice(7) == slice(0, 7)
    mesh = par.make_stream_mesh(8, device="cpu")
    assert par.allreduce_metric(123.5, mesh) == pytest.approx(123.5, rel=1e-6)
    assert par.allreduce_metric(0.75) == 0.75
    assert par.reduce_shards([torch.tensor(3.0), torch.tensor(7.5),
                              torch.tensor(-1.0)], "max") == 7.5
    assert par.reduce_shards([1, 2, 3]) == 6.0
    with pytest.raises(ValueError, match="op"):
        par.reduce_shards([1.0], "mean")
    par.shutdown_distributed()      # no group: nothing to leave
    assert par.init_distributed() == 0
    assert par.init_distributed(None, 1, 0, device="cpu") == 0
    with pytest.raises(ValueError, match="coordinator"):
        par.init_distributed(None, 2, 0, device="cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


RANK = r"""
import json, sys
sys.modules["jax"] = sys.modules["mp3tpu"] = None
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np, torch
torch.set_num_threads(1)
import mp3tpu_torch
from mp3tpu_torch import parallel as par
mp3tpu_torch.init(sample_rates=(), distributed_coordinator="127.0.0.1:" + port,
                  num_processes=2, process_id=rank, device="cpu")
paths = json.load(open(work + "/paths.json"))
sl = par.rank_slice(len(paths))
mine = mp3tpu_torch.decode_batch(paths[sl], device="cpu")
pcm = par.gather_to_host0(np.concatenate([p for p, _ in mine]))
lens = par.gather_to_host0([len(p) for p, _ in mine])
tones = np.load(work + "/tones.npy")
blobs = par.gather_to_host0(mp3tpu_torch.encode_batch(
    list(tones[par.rank_slice(len(tones))]), 44100, bitrate=128, device="cpu"))
mean = par.allreduce_metric(float(rank + 1))
peak = par.reduce_shards([torch.tensor(float(np.abs(p).max())) for p, _ in mine], "max")
if rank == 0:
    np.save(work + "/pcm.npy", pcm)
    with open(work + "/mp3.bin", "wb") as f:
        f.write(b"".join(blobs))
    json.dump({"lens": lens, "sizes": [len(b) for b in blobs], "mean": mean,
               "peak": peak, "slice": [sl.start, sl.stop]},
              open(work + "/out.json", "w"))
par.shutdown_distributed()
print("rank", rank, "done")
"""


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Two ranks under gloo, spawned with subprocess, meeting on a free
    loopback port: each decodes and encodes its rank_slice on the CPU, the
    gathers equal a single-process run, and the metric is the ranks' mean."""
    paths = []
    for i, k in enumerate(("tonal", "transients", "sweep")):
        p = tmp_path / f"{i}.mp3"
        p.write_bytes(clip(k))
        paths.append(str(p))
    pcms = np.stack(tones(3, 0.2))
    json.dump(paths, open(tmp_path / "paths.json", "w"))
    np.save(tmp_path / "tones.npy", pcms)
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), port,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    res = json.load(open(tmp_path / "out.json"))
    single = mp3tpu_torch.decode_batch(paths, device="cpu")
    assert res["slice"] == [0, 2] and res["lens"] == [len(p) for p, _ in single]
    assert np.array_equal(np.load(tmp_path / "pcm.npy"),
                          np.concatenate([p for p, _ in single]))
    ref = mp3tpu_torch.encode_batch(list(pcms), SR, bitrate=128, device="cpu")
    assert res["sizes"] == [len(b) for b in ref]
    assert (tmp_path / "mp3.bin").read_bytes() == b"".join(ref)
    assert res["mean"] == 1.5
    assert res["peak"] == float(max(np.abs(p).max() for p, _ in single))
