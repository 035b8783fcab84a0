"""Checks of the CUDA kernels of csrc/fused_z.cu and csrc/synth.cu against
their plain versions on a CUDA device, and the least time the card could take
for their work.

The cuda-marked tests (tests/test_torch_fused_z.py, test_torch_frontend.py)
and the kernel phase of chip_smoke.py run the same checks:
check_kernel() holds a kernel to its plain version (compare(): each
subband of each granule pair within REL_TOL of its own largest value) at
pair counts that do not fill the persistent grid, for every input type the
kernel reads, and asserts that its bits do not depend on the input types,
on the launch or on the batch a pair sits in, and that zero pairs launch
nothing. check_synth() does the same for the synthesis kernel (C6-C7): each
(stream, channel) row of PCM within REL_TOL of the row's largest value, the
state equal bit for bit, and the same bits whatever the call's shape.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fused_z as fz
from . import synth as sy
from .tables import DeviceTables

# kernel vs plain, both float32: they differ by the cube-root seed, the
# multiply-adds and the order of the 18-term IMDCT sums (C1-C5) or of the
# two-term alias sums (C1-C4); relative to the largest output value of
# each subband of each granule pair
REL_TOL = 1e-5
# pair counts that leave the persistent grid (SMs x blocks per SM) part
# empty, or wrap it unevenly
ODD_PAIRS = (1, 3, 133, 8191)
# NVIDIA H100 SXM: HBM3 bytes per second and float32 operations per second
# outside the tensor cores (the data sheet's peaks, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

KERNELS = {"fused_z": (fz.fused_pipeline_z, fz.fused_pipeline_z_reference),
           "fused_frontend": (fz.fused_frontend, fz.fused_frontend_reference)}
ENTRIES = {"fused_z": ("mp3tpu_fused_z", (32, 36)),
           "fused_frontend": ("mp3tpu_fused_frontend", (576,))}


def variant(name: str, defines: tuple = ()):
    """Kernel `name` launched from csrc/fused_z.cu built with the macros
    `defines` (its MP3TPU_FZ_* measurement variants; () is the wrapper's own
    build), called as the wrapper is; it counts no launch."""
    entry, tail = ENTRIES[name]
    lib = fz._library(tuple(defines))
    return lambda *args: fz._launch(entry, tail, *args, lib=lib)


def blocks_per_sm(name: str, defines: tuple = ()) -> int:
    """Blocks of the persistent grid per SM of kernel `name` (int32
    symbols), on the current CUDA device."""
    import ctypes
    n = ctypes.c_int(0)
    lib = fz._library(tuple(defines))
    rc = lib.mp3tpu_fused_blocks_per_sm(int(name == "fused_frontend"),
                                        ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(lib.mp3tpu_cuda_error_string(rc).decode())
    return n.value


def random_symbols(S: int, G: int, seed: int, real=(),
                   sym_types=(torch.int32, torch.int32), bt_dtype=torch.int8,
                   device="cuda") -> list:
    """Seeded symbols [S, G, ...] covering every block type, mixed blocks,
    all 144 palette indices and escape-sized values; the first streams are
    replaced by real windows (SymbolTensors in `real`). is_ and exp take
    the types sym_types (int32 as the plane decode hands them over),
    block_type bt_dtype."""
    rng = np.random.default_rng(seed)
    shape = (S, G, 2)
    is_ = rng.integers(-15, 16, shape + (576,)).astype(np.int16)
    big = rng.random(is_.shape) < 0.005
    is_[big] = rng.integers(-8206, 8207, int(big.sum()))
    exp = rng.integers(-80, 8, shape + (64,)).astype(np.int16)
    bt = rng.integers(0, 4, shape).astype(np.int8)
    mixed = (rng.random(shape) < 0.5) & (bt == 2)
    smode = rng.integers(0, 144, (S, G, 64)).astype(np.uint8)
    smode.reshape(-1)[:144] = np.arange(144)[:smode.size]
    for s, st in enumerate(real[:S]):
        is_[s], exp[s] = st.is_[:G], st.exp[:G]
        bt[s], mixed[s], smode[s] = st.block_type[:G], st.mixed[:G], st.smode[:G]
    t = lambda a: torch.from_numpy(a).to(device)
    return [t(is_).to(sym_types[0]), t(exp).to(sym_types[1]),
            t(bt).to(bt_dtype), t(mixed), t(smode)]


def traffic(name: str, args) -> tuple:
    """(bytes, float32 operations) that one call of kernel `name` needs on
    these inputs: each input read once, each output written once; the
    multiplies and multiply-adds of C1 (the scale), C2, C4 (on the lines
    this data's flavors alias) and C5, the cube roots not counted."""
    is_, exp, bt, mixed, smode = args
    pairs = is_.shape[0] * is_.shape[1]
    n_in = sum(a.numel() * a.element_size() for a in args)
    n_out = pairs * 2 * (1152 if name == "fused_z" else 576) * 4
    short = bt.long() == 2
    boundaries = torch.where(short, torch.where(mixed.bool(), 1, 0), 31)
    flops = (pairs * 576 * (2 + 6) + 16 * 3 * int(boundaries.sum())
             + (pairs * 2 * 32 * 36 * 18 * 2 if name == "fused_z" else 0))
    return n_in + n_out, flops


def bound(name: str, args) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    nbytes, flops = traffic(name, args)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return {"bytes": nbytes, "flops": flops,
            "bound_us": 1e6 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare(name: str, got: torch.Tensor, want: torch.Tensor, what: str):
    """(max |got - want|, max |want|, the worst group's error over its
    tolerance) of z [S,G,2,32,36] or nat [S,G,2,576]. A group is one
    subband of one granule pair, both channels (the stereo stage couples
    them): each is held to REL_TOL of its own largest |want|, so a wrong
    stream, band or subband fails however small its values are beside the
    rest of the call. Raises if any group is beyond it."""
    if got.shape != want.shape:
        raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {what}: output not finite")
    S, G = want.shape[:2]
    d = (got - want).abs().reshape(S * G, 2, 32, -1)
    err_g = d.amax(dim=(1, 3))                                  # [pairs, 32]
    tol_g = REL_TOL * want.abs().reshape(S * G, 2, 32, -1).amax(dim=(1, 3))
    over = torch.where(tol_g > 0, err_g / tol_g.clamp_min(1e-38),
                       torch.where(err_g > 0, torch.inf, 0.0))
    err, scale = float(d.max()), float(want.abs().max())
    worst = float(over.max())
    if scale == 0:
        raise AssertionError(f"{name} {what}: the plain version gives zeros")
    if not worst <= 1.0:
        pair, sb = divmod(int(over.argmax()), 32)
        raise AssertionError(
            f"{name} {what}: {int((over > 1).sum())} of {over.numel()} "
            f"subbands beyond REL_TOL {REL_TOL:g} of their own max |out|; "
            f"worst: stream {pair // G}, granule {pair % G}, subband {sb}, "
            f"|d| {float(err_g.flatten()[pair * 32 + sb]):.6g} against a tol "
            f"of {float(tol_g.flatten()[pair * 32 + sb]):.6g}")
    return err, scale, worst


def check_odd_pairs(name: str, tables: DeviceTables, log=print) -> None:
    """Within REL_TOL of plain at pair counts that leave the persistent grid
    part empty or wrap it unevenly."""
    kernel, plain = KERNELS[name]
    for n in ODD_PAIRS:
        args = random_symbols(n, 1, seed=n, device=tables.band_map.device)
        _, _, worst = compare(name, kernel(*args, tables),
                              plain(*args, tables), f"{n} pairs")
        log(f"check {name}: {n} pairs within tol of plain (worst subband "
            f"at {worst:.3g} of its tol)")


def check_input_types(name: str, tables: DeviceTables, log=print) -> None:
    """Every input type the kernel reads, within REL_TOL of plain, and the
    same bits from each."""
    kernel, plain = KERNELS[name]
    ref = None
    for sym in fz._SYMBOL_TYPES:
        for bt_dt in (torch.int8, torch.int32):
            for mixed_u8 in (False, True):
                args = random_symbols(133, 1, seed=5, sym_types=sym,
                                      bt_dtype=bt_dt,
                                      device=tables.band_map.device)
                if mixed_u8:
                    args[3] = args[3].to(torch.uint8)
                out = kernel(*args, tables)
                compare(name, out, plain(*args, tables),
                        f"is/exp {sym}, block_type {bt_dt}")
                if ref is None:
                    ref = out
                elif not torch.equal(out, ref):
                    raise AssertionError(f"{name}: bits depend on the input "
                                         f"types (is/exp {sym}, "
                                         f"block_type {bt_dt})")
    log(f"check {name}: is_/exp int16/int16, int32/int32 and int32/int16, "
        "int8/int32 block_type, bool/uint8 mixed: within tol, bit-identical "
        "to each other")


def check_bit_identity(name: str, tables: DeviceTables, log=print) -> None:
    """Two launches give the same bits, and a stream alone (S=1) the bits
    it has at S=64."""
    kernel, _ = KERNELS[name]
    args = random_symbols(64, 32, seed=64, device=tables.band_map.device)
    out = kernel(*args, tables)
    if not torch.equal(out, kernel(*args, tables)):
        raise AssertionError(f"{name}: two launches differ")
    for s in (0, 17, 63):
        one = kernel(*(a[s:s + 1] for a in args), tables)
        if not torch.equal(one[0], out[s]):
            raise AssertionError(f"{name}: stream {s} at S=1 differs from "
                                 "the same stream at S=64")
    log(f"check {name}: two launches bit-identical; streams at S=1 "
        "bit-identical to the same streams at S=64")


def check_zero_pairs(name: str, tables: DeviceTables, log=print) -> None:
    """Zero pairs: an empty output and no launch."""
    kernel, _ = KERNELS[name]
    args = random_symbols(0, 32, seed=0, device=tables.band_map.device)
    before = kernel.launches
    empty = kernel(*args, tables)
    if empty.numel() != 0 or kernel.launches != before:
        raise AssertionError(f"{name}: zero pairs launched or gave output")
    log(f"check {name}: zero pairs -> empty {tuple(empty.shape)}, "
        "no launch")


CHECKS = {"odd_pairs": check_odd_pairs, "input_types": check_input_types,
          "bit_identity": check_bit_identity, "zero_pairs": check_zero_pairs}


def check_kernel(name: str, tables: DeviceTables, log=print) -> None:
    """Every check of kernel `name` on the device of `tables`; raises on the
    first that fails, logs one line for each that passes."""
    for check in CHECKS.values():
        check(name, tables, log)
    if tables.band_map.device.type == "cuda":
        torch.cuda.synchronize(tables.band_map.device)


# ---- the synthesis kernel (C6-C7, csrc/synth.cu)

# (S, G) of check_synth's comparisons with the plain version: single
# granules, a last tile of time steps that is part empty, rows the persistent
# grid wraps unevenly
SYNTH_SHAPES = ((1, 1), (3, 2), (5, 7), (2, 32), (67, 3), (4, 130))


def random_z(S: int, G: int, seed: int, device="cuda"):
    """Seeded z [S, G, 2, 32, 36] float32 with streams of different loudness
    (so that a row's tolerance is its own), and a non-zero decoder state."""
    rng = np.random.default_rng(seed)
    loud = np.exp(rng.uniform(-6.0, 0.0, (S, 1, 1, 1, 1)))
    z = (rng.standard_normal((S, G, 2, 32, 36)) * 0.05 * loud).astype(np.float32)
    state = {"overlap": (rng.standard_normal((S, 2, 32, 18)) * 0.05
                         * loud[:, 0]).astype(np.float32),
             "hist": (rng.standard_normal((S, 2, 15, 32)) * 0.05
                      * loud[:, 0]).astype(np.float32)}
    return (torch.from_numpy(z).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in state.items()})


def synth_traffic(z: torch.Tensor) -> tuple:
    """(bytes, float32 operations) of one synth_backend call on z: z, the
    state and the tables the kernel reads (inv_mask, the 32 distinct rows of
    the matrixing, the window) read once, PCM and the new state written
    once; per sample the factored form's 48 multiply-adds (32 of the
    matrixing, 16 of the window) and the overlap-add's add and multiply."""
    S, G = z.shape[:2]
    state = S * 2 * (32 * 18 + 15 * 32) * 4
    n_bytes = (z.numel() * 4 + state + (32 * 18 + 32 * 32 + 512) * 4
               + S * 2 * G * 576 * 4 + state)
    flops = S * 2 * G * 576 * (48 * 2 + 2)
    return n_bytes, flops


def synth_bound(z: torch.Tensor) -> dict:
    """As bound(), for the synthesis kernel."""
    nbytes, flops = synth_traffic(z)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return {"bytes": nbytes, "flops": flops,
            "bound_us": 1e6 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare_synth(got, want, what: str):
    """(max |d|, max |want|, the worst row's error over its tolerance) of
    (pcm [S, n, 2], state) pairs: each (stream, channel) row of PCM is held
    to REL_TOL of its own largest |want|; the states (sums of two values and
    copies) must be equal bit for bit. Raises otherwise."""
    (pcm, st), (pcm_w, st_w) = got, want
    if pcm.shape != pcm_w.shape:
        raise AssertionError(f"synth {what}: shape {tuple(pcm.shape)} vs "
                             f"{tuple(pcm_w.shape)}")
    if not bool(torch.isfinite(pcm).all()):
        raise AssertionError(f"synth {what}: output not finite")
    for k in ("overlap", "hist"):
        if not torch.equal(st[k], st_w[k]):
            raise AssertionError(f"synth {what}: new {k} differs from plain")
    err_r = (pcm - pcm_w).abs().amax(dim=1)                     # [S, 2]
    tol_r = REL_TOL * pcm_w.abs().amax(dim=1)
    if not bool((tol_r > 0).all()):
        raise AssertionError(f"synth {what}: the plain version gives a zero row")
    worst = float((err_r / tol_r).max())
    if not worst <= 1.0:
        s, c = divmod(int((err_r / tol_r).argmax()), 2)
        raise AssertionError(
            f"synth {what}: stream {s} channel {c} at {worst:.3g} of its tol "
            f"(REL_TOL {REL_TOL:g} of the row's max |pcm|)")
    return float(err_r.max()), float(pcm_w.abs().max()), worst


def _equal_out(a, b) -> bool:
    return (torch.equal(a[0], b[0]) and torch.equal(a[1]["overlap"], b[1]["overlap"])
            and torch.equal(a[1]["hist"], b[1]["hist"]))


def check_synth(tables: DeviceTables, log=print) -> None:
    """Every check of the synthesis kernel on the device of `tables`: within
    REL_TOL of plain at SYNTH_SHAPES; bit-identical PCM and state for two
    launches, for one call at [S, G] against S calls at [1, G], for one call
    at G=64 against two at G=32 carrying the state, and for S=36 rows of 130
    granules against each stream alone in windows of 32; zero granules and
    zero streams launch nothing."""
    dev = tables.synth_w.device
    for S, G in SYNTH_SHAPES:
        z, st = random_z(S, G, seed=100 * S + G, device=dev)
        _, _, worst = compare_synth(sy.synth_backend(z, st, tables),
                                    sy.synth_backend_reference(z, st, tables),
                                    f"S={S} G={G}")
        log(f"check synth: S={S} G={G} within tol of plain (worst row at "
            f"{worst:.3g} of its tol), state bit-identical")

    z, st = random_z(64, 32, seed=64, device=dev)
    out = sy.synth_backend(z, st, tables)
    if not _equal_out(out, sy.synth_backend(z, st, tables)):
        raise AssertionError("synth: two launches differ")
    for s in range(64):
        one = sy.synth_backend(z[s:s + 1], {k: v[s:s + 1] for k, v in st.items()},
                               tables)
        if not _equal_out(one, (out[0][s:s + 1],
                                {k: v[s:s + 1] for k, v in out[1].items()})):
            raise AssertionError(f"synth: stream {s} at S=1 differs from the "
                                 "same stream at S=64")
    log("check synth: two launches bit-identical; one call at [64, 32] "
        "bit-identical to 64 calls at [1, 32]")

    z, st = random_z(5, 64, seed=7, device=dev)
    whole = sy.synth_backend(z, st, tables)
    a, mid = sy.synth_backend(z[:, :32], st, tables)
    b, end = sy.synth_backend(z[:, 32:], mid, tables)
    if not _equal_out(whole, (torch.cat([a, b], dim=1), end)):
        raise AssertionError("synth: one call at G=64 differs from two at "
                             "G=32 carrying the state")
    log("check synth: one call at G=64 bit-identical to two at G=32 carrying "
        "the state")

    z, st = random_z(36, 130, seed=36, device=dev)
    rows = sy.synth_backend(z, st, tables)
    for s in range(36):
        state = {k: v[s:s + 1] for k, v in st.items()}
        parts = []
        for g in range(0, 130, 32):
            p, state = sy.synth_backend(z[s:s + 1, g:g + 32], state, tables)
            parts.append(p)
        if not _equal_out((torch.cat(parts, dim=1), state),
                          (rows[0][s:s + 1],
                           {k: v[s:s + 1] for k, v in rows[1].items()})):
            raise AssertionError(f"synth: stream {s} of [36, 130] differs from "
                                 "its decode alone in windows of 32")
    log("check synth: [36, 130] bit-identical to each stream alone in "
        "windows of 32 granules")

    before = sy.synth_backend.launches
    for S, G in ((4, 0), (0, 32)):
        z, st = random_z(S, G, seed=1, device=dev)
        pcm, st2 = sy.synth_backend(z, st, tables)
        if (tuple(pcm.shape) != (S, G * 576, 2) or st2 is not st
                or sy.synth_backend.launches != before):
            raise AssertionError(f"synth: S={S} G={G} launched, gave output "
                                 "or changed the state")
    log("check synth: zero granules and zero streams -> empty PCM, the state "
        "as it was, no launch")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
