"""C6-C7 of the PyTorch port (kernels/synth.py: overlap-add, frequency
inversion, synthesis FIR) held against the JAX package's _backend on the
same seeded numpy inputs, on the CPU, where synth_backend runs its plain
version. The CUDA kernel of csrc/synth.cu is held to the plain version, and
its bits across shapes, on the card (the cuda-marked test:
kernels/selfcheck.check_synth)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch.kernels import pipeline as tp
from mp3tpu_torch.kernels import selfcheck
from mp3tpu_torch.kernels import synth as sy
from mp3tpu_torch.kernels.tables import build_tables

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
    assert b["flops"] == samples * (512 * 2 + 2)
    assert b["bytes"] >= z.numel() * 4 + samples * 4
    assert b["bound_by"] == "operations"


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
