"""C1-C4 of the PyTorch port (kernels/fused_z.py: fused_frontend and its
plain version) held against the JAX package: the XLA path's natural-order
spectrum `nat`, and the Pallas kernel _kernel in interpret mode. The CUDA
kernel itself is held against the plain version on the card (the
cuda-marked tests: kernels/selfcheck.py's checks)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.kernels import pallas_fused as pf
from mp3tpu.kernels import pipeline as kp
from mp3tpu_torch.kernels import fused_z as fz
from mp3tpu_torch.kernels import selfcheck
from mp3tpu_torch.kernels.tables import build_tables
from test_torch_fused_z import assert_close, symbols


def port_nat(args, sr=44100):
    return fz.fused_frontend_reference(
        *(torch.from_numpy(a) for a in args), build_tables(sr, "cpu")).numpy()


@pytest.mark.parametrize("sr", (44100, 22050))
def test_plain_matches_xla_nat(sr, monkeypatch):
    args = symbols(2, 32, seed=sr + 1)
    monkeypatch.setattr(kp, "_imdct_and_backend", lambda v, *rest: v)
    v = kp._granule_pipeline_xla(*(jnp.asarray(a) for a in args),
                                 kp.init_state(2), kp.build_tables(sr))
    assert_close(port_nat(args, sr), np.asarray(v).reshape(2, 32, 2, 576))


def test_plain_matches_pallas_kernel(monkeypatch):
    """_kernel itself, in Pallas interpret mode on the JAX CPU backend."""
    monkeypatch.setattr(pf.pl, "pallas_call",
                        functools.partial(pf.pl.pallas_call, interpret=True))
    args = symbols(1, 32, seed=8)
    want = pf.fused_frontend(*(jnp.asarray(a) for a in args),
                             kp.build_tables(44100), 44100)
    assert_close(port_nat(args), np.asarray(want))


def test_wrapper_runs_plain_on_cpu():
    args = [torch.from_numpy(a) for a in symbols(1, 4, seed=5)]
    t = build_tables(44100, "cpu")
    before = fz.fused_frontend.launches
    nat = fz.fused_frontend(*args, t)
    assert fz.fused_frontend.launches == before  # no kernel on the CPU
    assert nat.shape == (1, 4, 2, 576) and nat.dtype == torch.float32
    assert torch.equal(nat, fz.fused_frontend_reference(*args, t))
    with pytest.raises(ValueError, match="smode: shape"):
        fz.fused_frontend(*args[:4], args[4][..., :32], t)


def test_plain_c1_c5_is_c1_c4_then_imdct():
    """One plain C1-C4 serves both plain versions: z's long-block subbands
    are the IMDCT of fused_frontend_reference's nat."""
    is_, exp, bt, mixed, smode = symbols(1, 8, seed=6)
    bt[:] = 0
    args = [torch.from_numpy(a) for a in (is_, exp, bt, np.zeros_like(mixed), smode)]
    t = build_tables(44100, "cpu")
    nat = fz.fused_frontend_reference(*args, t).reshape(1, 8, 2, 32, 18)
    z = fz.fused_pipeline_z_reference(*args, t)
    assert torch.equal(z, (nat @ t.imdct_long) * t.windows[0])


@pytest.mark.cuda
@pytest.mark.parametrize("S", (64, 256))
def test_kernel_matches_plain_on_card(S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [torch.from_numpy(a).cuda() for a in symbols(S, 32, seed=S + 2)]
    t = build_tables(44100, "cuda")
    before = fz.fused_frontend.launches
    nat = fz.fused_frontend(*args, t)
    want = fz.fused_frontend_reference(*args, t)
    torch.cuda.synchronize()
    assert fz.fused_frontend.launches == before + 1
    selfcheck.compare("fused_frontend", nat, want, f"S={S}")
    assert torch.equal(nat, fz.fused_frontend(*args, t))  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("check", sorted(selfcheck.CHECKS))
def test_kernel_checks_on_card(check):
    """Odd pair counts, every input type, bit-identity across launches and
    batch sizes, zero pairs (kernels/selfcheck.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    selfcheck.CHECKS[check]("fused_frontend", build_tables(44100, "cuda"))
    torch.cuda.synchronize()
