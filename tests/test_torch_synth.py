"""C6-C7 of the PyTorch port (kernels/synth.py: overlap-add, frequency
inversion, polyphase synthesis) held against the JAX package's _backend on
the same seeded numpy inputs, on the CPU, where synth_backend runs its plain
version; the factored form that csrc/synth.cu computes (matrixing and
16-tap window, synth_backend_factored_reference) against the same and
against the float64 oracle. The CUDA kernel is held to both plain versions,
and its bits across shapes, on the card (the cuda-marked test:
kernels/selfcheck.check_synth)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch.kernels import pipeline as tp
from mp3tpu_torch.kernels import selfcheck
from mp3tpu_torch.kernels import synth as sy
from mp3tpu_torch.kernels.tables import (SYNTH_V_ROWS, build_tables,
                                         synth_v_expansion)
from mp3tpu_torch.oracle.synth import SynthFIFO
from mp3tpu_torch.tables import filterbank as fb

torch.set_num_threads(1)
SR = 44100


@pytest.fixture(scope="module")
def tables():
    return build_tables(SR, "cpu")


def inputs(S, G, seed):
    return selfcheck.random_z(S, G, seed, device="cpu")


# both float32, the 512-term sum behind a sample taken in another order by
# the two libraries: relative to the largest value of the output
TOL = 1e-6


@pytest.mark.parametrize("G", (1, 2, 32))
def test_synth_backend_matches_jax(tables, G):
    S = 3
    z, st = inputs(S, G, seed=G)
    pcm, new = sy.synth_backend(z, st, tables)
    want, new_j = kp._backend(
        jnp.asarray(z.numpy()), {k: jnp.asarray(v.numpy()) for k, v in st.items()},
        kp.build_tables(SR), S, G)
    want = np.asarray(want)
    assert tuple(pcm.shape) == want.shape == (S, G * 576, 2)
    assert pcm.dtype == torch.float32
    assert np.abs(pcm.numpy() - want).max() <= TOL * np.abs(want).max()
    for k in ("overlap", "hist"):
        w = np.asarray(new_j[k])
        assert tuple(new[k].shape) == w.shape
        assert np.abs(new[k].numpy() - w).max() <= TOL * np.abs(w).max()


def test_synth_backend_is_the_decoder_back_end(tables, monkeypatch):
    """GranuleDecoder.forward hands z and the state to synth_backend."""
    seen = []

    def spy(z, state, t):
        seen.append(tuple(z.shape))
        return sy.synth_backend(z, state, t)

    monkeypatch.setattr(tp, "synth_backend", spy)
    S, G = 2, 4
    args = [torch.zeros((S, G, 2, 576), dtype=torch.int16),
            torch.zeros((S, G, 2, 64), dtype=torch.int16),
            torch.zeros((S, G, 2), dtype=torch.int8),
            torch.zeros((S, G, 2), dtype=torch.bool),
            torch.zeros((S, G, 64), dtype=torch.uint8)]
    pcm, _ = tp.GranuleDecoder(tables)(*args, tp.init_state(S, device="cpu"))
    assert seen == [(S, G, 2, 32, 36)] and tuple(pcm.shape) == (S, G * 576, 2)


def test_state_carries_across_calls(tables):
    """One call at G=4 equals two at G=2 carrying the state (plain version,
    within the tolerance: a library matmul promises no order)."""
    z, st = inputs(2, 4, seed=9)
    whole, end = sy.synth_backend(z, st, tables)
    a, mid = sy.synth_backend(z[:, :2], st, tables)
    b, end2 = sy.synth_backend(z[:, 2:], mid, tables)
    two = torch.cat([a, b], dim=1)
    assert float((whole - two).abs().max()) <= TOL * float(whole.abs().max())
    assert torch.equal(end["overlap"], end2["overlap"])
    assert torch.equal(end["hist"], end2["hist"])


@pytest.mark.parametrize("S,G", [(4, 0), (0, 3)])
def test_nothing_to_do_returns_empty_and_the_state(tables, S, G):
    z, st = inputs(S, G, seed=1)
    before = sy.synth_backend.launches
    pcm, new = sy.synth_backend(z, st, tables)
    assert tuple(pcm.shape) == (S, G * 576, 2) and new is st
    assert sy.synth_backend.launches == before


@pytest.mark.parametrize("case", ["z_shape", "z_rank", "overlap_shape",
                                  "hist_shape", "z_dtype", "hist_dtype",
                                  "device"])
def test_wrong_inputs_raise(tables, case):
    z, st = inputs(2, 2, seed=2)
    err = ValueError
    if case == "z_shape":
        z = z[..., :35]
    elif case == "z_rank":
        z = z[0]
    elif case == "overlap_shape":
        st["overlap"] = st["overlap"][:1]
    elif case == "hist_shape":
        st["hist"] = st["hist"][:, :, :14]
    elif case == "z_dtype":
        z, err = z.double(), TypeError
    elif case == "hist_dtype":
        st["hist"], err = st["hist"].half(), TypeError
    else:
        z = z.to("meta")
    with pytest.raises(err):
        sy.synth_backend(z, st, tables)


def test_cpu_tensors_count_no_launch(tables):
    z, st = inputs(1, 2, seed=3)
    before = sy.synth_backend.launches
    sy.synth_backend(z, st, tables)
    assert sy.synth_backend.launches == before


def test_checks_fail_a_wrong_kernel(tables, monkeypatch):
    """check_synth's tolerance catches one wrong tap, and its bit-identity
    checks a sum whose value depends on the call's shape."""
    real = sy.synth_backend_reference

    def one_tap_off(z, state, t):
        pcm, new = real(z, state, t)
        pcm = pcm.clone()
        pcm[0, 7, 1] += 1e-4 * float(pcm[0, :, 1].abs().max())
        return pcm, new

    monkeypatch.setattr(sy, "synth_backend", one_tap_off)
    with pytest.raises(AssertionError, match="of its tol"):
        selfcheck.check_synth(tables, log=lambda *_: None)

    def shape_dependent(z, state, t):
        pcm, new = real(z, state, t)
        return pcm * (1.0 + 1e-7 * z.shape[0]), new

    monkeypatch.setattr(sy, "synth_backend", shape_dependent)
    with pytest.raises(AssertionError, match="differs"):
        selfcheck.check_synth(tables, log=lambda *_: None)


def test_checks_pass_on_the_plain_version(tables):
    selfcheck.check_synth(tables, log=lambda *_: None)


def test_bound_counts_this_call(tables):
    z, _ = inputs(2, 32, seed=4)
    b = selfcheck.synth_bound(z)
    samples = 2 * 2 * 32 * 576
    assert b["flops"] == samples * (48 * 2 + 2)
    assert b["bytes"] >= z.numel() * 4 + samples * 4
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("S,G,bound_us", [(1, 32, 0.1396), (64, 32, 8.777),
                                          (256, 32, 35.10), (36, 130, 19.50)])
def test_bound_is_the_bytes_at_every_path_shape(S, G, bound_us):
    """The factored form is under the float32 ridge at the shapes the paths
    hand the kernel: the bytes bound it (at 3.35 TB/s)."""
    b = selfcheck.synth_bound(torch.empty((S, G, 2, 32, 36), device="meta"))
    assert b["bound_by"] == "bytes"
    assert b["bound_us"] == pytest.approx(bound_us, rel=1e-3)


def test_factorization_is_exact():
    """synth_fir, the plain version's taps, is the window times the
    matrixing: synth_fir[d, k, j] == D[32d + j] * N[j + 32 (d & 1), k] in
    float64; N's symmetries give V from the 32 rows SYNTH_V_ROWS; the
    tables hold the float32 values of D and of those rows."""
    fir, D, N = fb.synthesis_fir(), fb.synthesis_window(), fb.synthesis_matrix()
    d = np.arange(16)[:, None, None]
    k = np.arange(32)[None, :, None]
    j = np.arange(32)[None, None, :]
    assert np.abs(D[32 * d + j] * N[j + 32 * (d & 1), k] - fir).max() <= 1e-12
    assert np.abs(N[16]).max() <= 1e-12
    for i in range(33):
        assert np.abs(N[32 - i] + N[i]).max() <= 1e-12
    for i in range(33, 64):
        assert np.abs(N[96 - i] - N[i]).max() <= 1e-12
    src, sign = synth_v_expansion()
    assert np.abs(np.array(sign)[:, None] * N[list(SYNTH_V_ROWS)][src] - N).max() <= 1e-12
    t = build_tables(SR, "cpu")
    assert np.array_equal(t.synth_window.numpy(), D.astype(np.float32))
    assert np.array_equal(t.synth_matrix.numpy(),
                          N[list(SYNTH_V_ROWS)].astype(np.float32))


@pytest.mark.parametrize("G", (1, 2, 32))
def test_factored_form_matches_jax(tables, G):
    S = 3
    z, st = inputs(S, G, seed=40 + G)
    pcm, new = sy.synth_backend_factored_reference(z, st, tables)
    want, new_j = kp._backend(
        jnp.asarray(z.numpy()), {k: jnp.asarray(v.numpy()) for k, v in st.items()},
        kp.build_tables(SR), S, G)
    want = np.asarray(want)
    assert tuple(pcm.shape) == want.shape == (S, G * 576, 2)
    assert pcm.dtype == torch.float32
    assert np.abs(pcm.numpy() - want).max() <= TOL * np.abs(want).max()
    for k in ("overlap", "hist"):
        assert np.array_equal(new[k].numpy(), np.asarray(new_j[k]))


def _quantize(x: np.ndarray) -> np.ndarray:
    """float PCM -> int16, half away from zero (quantize_i16's rule)."""
    s = x * 32768.0
    r = np.where(s >= 0, np.floor(s + 0.5), np.ceil(s - 0.5))
    return np.clip(r, -32768, 32767).astype(np.int16)


def _oracle_pcm(z: np.ndarray, st: dict) -> np.ndarray:
    """float64 PCM [S, 2, T*32] of the V-FIFO of ISO 11172-3 (oracle.synth),
    primed with the 15 rows of hist, on the float64 overlap-added input."""
    S, G = z.shape[:2]
    z64, inv = z.astype(np.float64), np.ones((32, 18))
    inv[1::2, 1::2] = -1.0
    tails = np.concatenate([st["overlap"][:, None], z64[:, :-1, :, :, 18:]], axis=1)
    seq = ((z64[..., :18] + tails) * inv).transpose(0, 2, 1, 4, 3).reshape(S * 2, G * 18, 32)
    fifo = SynthFIFO(S * 2)
    for h in range(15):
        fifo.step(st["hist"].reshape(S * 2, 15, 32)[:, h].astype(np.float64))
    out = np.stack([fifo.step(seq[:, t]) for t in range(G * 18)], axis=1)
    return out.reshape(S, 2, G * 576)


def test_factored_form_matches_the_float64_oracle(tables):
    """int16 of the factored form within 1 LSB of the float64 V-FIFO and at
    least 98% exact, on seeded input scaled so that each stream peaks at
    0.9 of full scale."""
    S, G = 3, 8
    z, st = inputs(S, G, seed=11)
    z, st = z.numpy(), {k: v.numpy() for k, v in st.items()}
    peak = np.abs(_oracle_pcm(z, st)).max(axis=(1, 2))
    gain = (0.9 / peak).astype(np.float32)
    z = z * gain[:, None, None, None, None]
    st = {k: v * gain[:, None, None, None] for k, v in st.items()}
    want = _quantize(_oracle_pcm(z, st))
    pcm, _ = sy.synth_backend_factored_reference(
        torch.from_numpy(z), {k: torch.from_numpy(v) for k, v in st.items()}, tables)
    got = _quantize(pcm.transpose(1, 2).numpy())
    d = np.abs(got.astype(np.int32) - want)
    assert np.abs(want).max() > 20000
    assert d.max() <= 1 and (d == 0).mean() >= 0.98


def test_checks_pass_on_the_factored_form(tables, monkeypatch):
    """check_synth, the check the card applies to csrc/synth.cu, passes with
    the factored form in the kernel's place: within REL_TOL of plain, and
    bit-identical across launches, batch sizes, window splits and the
    chunked decode's shape (its per-row arithmetic does not follow S)."""
    wrapper = sy.synth_backend

    def factored(z, state, t):
        if z.shape[0] * z.shape[1] == 0:  # the wrapper's: no launch
            return wrapper(z, state, t)
        return sy.synth_backend_factored_reference(z, state, t)

    factored.launches = 0
    monkeypatch.setattr(sy, "synth_backend", factored)
    selfcheck.check_synth(tables, log=lambda *_: None)


@pytest.mark.cuda
def test_synth_kernel_checks_on_card():
    """Within REL_TOL of plain at odd shapes; bit-identical across launches,
    batch sizes, window splits and the chunked decode's shape; zero granules
    (kernels/selfcheck.check_synth)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = sy.synth_backend.launches
    selfcheck.check_synth(build_tables(SR, "cuda"))
    torch.cuda.synchronize()
    assert sy.synth_backend.launches > before
