"""The Huffman transition chain of the PyTorch port (kernels/huffman_dfa.py)
held to the JAX package's spike (tools/device_huffman_spike.py): the count1
table A automaton state for state, the plain version against the JAX tool's
formulation (lax.scan with one jnp.take a bit step, on JAX's CPU backend)
on the same seeded bytes, and every automaton on strings of real codewords,
which it counts one by one and the port's host Huffman decoder
(bitstream/huffdec.py) decodes to the same number of quads and pairs. On the
CPU dfa_count runs its plain version; the CUDA kernel (csrc/huffman_dfa.cu)
is held to it count for count on the card (the cuda-marked tests)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import device_huffman_spike as jax_spike
from mp3tpu_torch import sanitize
from mp3tpu_torch.bitstream import huffdec
from mp3tpu_torch.kernels import huffman_dfa as hd
from mp3tpu_torch.tables import huffman as ht

torch.set_num_threads(1)
TABLES = ("count1a", 13, 24, 31)


def jax_chain(packed: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """The JAX tool's `fsm` (tools/device_huffman_spike.py:94-109), rebuilt
    here over the same flat table: bytes unpacked MSB first, a lax.scan over
    bit steps, one jnp.take a step, the transitions into state 0 summed."""
    flat = jnp.asarray(trans.reshape(-1).astype(np.int32))

    @jax.jit
    def fsm(packed_bytes):
        shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
        bits = ((packed_bytes[:, :, None] >> shifts) & 1).astype(jnp.int32)
        bits = bits.reshape(packed_bytes.shape[0], -1)

        def step(state, b):
            nxt = jnp.take(flat, state * 2 + b)
            return nxt, (nxt == 0).astype(jnp.int8)

        s0 = jnp.zeros(packed_bytes.shape[0], jnp.int32)
        _, emits = jax.lax.scan(step, s0, bits.T)
        return emits.astype(jnp.int32).sum(axis=0)

    return np.asarray(fsm(jnp.asarray(packed)))


def test_count1a_dfa_is_the_jax_tools():
    trans, n = hd.count1a_dfa()
    want, n_j = jax_spike.build_count1a_dfa()
    assert n == n_j == 19 and trans.shape == (19, 2)
    assert np.array_equal(trans, want)


@pytest.mark.parametrize("table,n_states", [(1, 5), (13, 257), (16, 259),
                                            (24, 265), (31, 283)])
def test_bigvalues_dfa_shape(table, n_states):
    """The trie of the table's codes (a complete prefix code: one internal
    node fewer than codes) and one chain state per trailing bit of the
    longest tail (2 x (linbits + 1) where the table has linbits, else 2)."""
    trans, n = hd.bigvalues_dfa(table)
    lens, _, xl, yl, linbits = ht.table_arrays(table)
    assert n == n_states == (xl * yl - 1) + 2 * (linbits + 1)
    assert trans.dtype == np.int16 and trans.shape == (n, 2)
    assert trans.min() >= 0 and trans.max() < n
    # every state but the root is reachable
    entered = np.bincount(trans.reshape(-1), minlength=n)
    assert np.all(entered[1:] >= 1)
    with pytest.raises(ValueError):
        hd.bigvalues_dfa(4)


@pytest.mark.parametrize("table", TABLES)
def test_plain_version_matches_jax(table):
    """64 rows x 264 bits of seeded random bytes: the plain version's counts
    equal the JAX tool's formulation's, for every automaton."""
    trans, _ = hd.automaton(table)
    packed = np.random.default_rng(64).integers(0, 256, (64, 33), np.uint8)
    got = hd.dfa_count(torch.from_numpy(packed), torch.from_numpy(trans))
    assert got.dtype == torch.int32 and tuple(got.shape) == (64,)
    assert np.array_equal(got.numpy(), jax_chain(packed, trans))


def test_nbits_cuts_the_row():
    """nbits walks a prefix of each row: the counts of the first 259 bits
    (not a whole byte) equal a walk of those bits in Python."""
    trans, _ = hd.automaton(31)
    packed = np.random.default_rng(1).integers(0, 256, (9, 33), np.uint8)
    got = hd.dfa_count(torch.from_numpy(packed), torch.from_numpy(trans), 259)
    bits = np.unpackbits(packed, axis=1)[:, :259]
    want = []
    for row in bits:
        s, k = 0, 0
        for b in row:
            s = int(trans[s, b])
            k += s == 0
        want.append(k)
    assert got.tolist() == want


def _granule(table, pairs):
    """Side info that sends `pairs` big-value pairs through `table` (all
    three regions), or only count1 table A quads (table "count1a")."""
    big = table != "count1a"
    return types.SimpleNamespace(
        big_values=pairs if big else 0, window_switching=0, region0_count=15,
        region1_count=7, table_select=(table,) * 3 if big else (0, 0, 0),
        count1table_select=0)


@pytest.mark.parametrize("table", TABLES)
def test_real_codewords_counted_one_by_one(table):
    """Rows of concatenated codewords with their linbits and sign bits: the
    chain counts each codeword once, and huffdec.decode_spectrum decodes the
    same number of quads (count1) or pairs (big values), to the very lines
    the rows code, using every bit and no more."""
    nbits = 300   # at most 144 quads or 288 pairs: one granule's 576 lines
    packed, words, lines = hd.codeword_rows(table, 12, nbits, seed=5)
    trans, _ = hd.automaton(table)
    got = hd.dfa_count(torch.from_numpy(packed), torch.from_numpy(trans), nbits)
    assert np.array_equal(got.numpy(), words) and words.min() > 0
    per = 4 if table == "count1a" else 2
    for row, n, want in zip(packed, words, lines):
        br = huffdec.GranuleBits(row.tobytes(), 0, nbits)
        out, end, overrun, slack = huffdec.decode_spectrum(
            br, _granule(table, int(n)), 44100, False, nbits)
        assert len(want) == per * n and not overrun and slack == 0
        assert np.array_equal(out[:per * n], want)
        if table == "count1a":
            assert end == per * n          # the quads decoded
        assert not out[per * n:].any()


def test_wrapper_checks():
    trans = torch.from_numpy(hd.automaton("count1a")[0])
    packed = torch.zeros((3, 4), dtype=torch.uint8)
    assert hd.dfa_count(packed[:0], trans).shape == (0,)
    with pytest.raises(ValueError):
        hd.dfa_count(packed.to(torch.int16), trans)
    with pytest.raises(ValueError):
        hd.dfa_count(packed, trans.to(torch.int32))
    with pytest.raises(ValueError):
        hd.dfa_count(packed, trans, 33)
    bad = trans.clone()
    bad[0, 0] = 19
    with pytest.raises(ValueError):
        hd.dfa_count(packed, bad)


def test_bound():
    """The spike's default case on an H100 at 1,980 MHz: count1-A's 19
    states fit a 12-bit table in shared memory, so 131,072 x ceil(256 / 12)
    lookups (0.35 us) take less than the 4,718,668 bytes (1.41 us), which
    bound it; at one bit a lookup the lookups would (4.01 us). Tables of
    257-283 states take 8 bits a lookup."""
    b = hd.bound(131072, 256, 32, 19, 1980.0)
    assert b["bytes"] == 131072 * 36 + 76
    assert b["table_bits"] == 12 and b["lookups"] == 131072 * 22
    assert b["bound_by"] == "bytes"
    assert b["bound_us"] == pytest.approx(1e6 * b["bytes"] / 3.35e12)
    assert b["bit_serial_us"] == pytest.approx(131072 * 256 / (132 * 32 * 1980.0))
    assert [hd.table_bits(n) for n in (1, 19, 257, 283, 1024)] == \
        [16, 12, 8, 8, 6]
    for n in (19, 283, 1024):
        k = hd.table_bits(n)
        assert n * 2 ** k * hd.ENTRY_BYTES <= hd.SMEM_BYTES \
            < n * 2 ** (k + 1) * hd.ENTRY_BYTES
    # few rows, many states: the lookups bound it
    b = hd.bound(1, 1 << 20, 1 << 17, 1024, 1000.0, sms=1)
    assert b["bound_by"] == "operations"
    assert b["bound_us"] == pytest.approx(-(-(1 << 20) // 6) / 32e9 * 1e6)


def test_sanitizer_cases_straddle_the_grid():
    """sanitize.py's chain cases, the one list the card's checks run: every
    pairing of 1, 31, 33, 4,096 and 131,072 rows and a persistent grid's
    width minus one, exactly and plus one, with 8 to 2,048 bits a row
    (three not a multiple of 32), through every automaton; then rows of
    codewords of each, which carry their own counts; a guarded int32 output
    holds counts between untouched guard bands."""
    width = 3 * hd.THREADS
    shapes = sanitize.dfa_shapes(width)
    assert sorted({r for r, _ in shapes}) == [1, 31, 33, width - 1, width,
                                              width + 1, 4096, 131072]
    assert sorted({b for _, b in shapes}) == [8, 256, 259, 264, 2048]
    assert sum(b % 32 != 0 for b in {b for _, b in shapes}) == 3
    assert len(shapes) == 8 * 5
    cases = sanitize.dfa_cases("cpu", width)
    first = next(cases)
    labels = [first[0]] + [c[0] for c in cases if c[4] is not None]
    assert labels[0] == "count1a 1 rows x 8 bits"
    assert [lb.split()[0] for lb in labels[1:]] == ["count1a", "13", "24", "31"]
    assert "huffman_dfa" in sanitize.GROUPS and "huffman_dfa" in sanitize.RUNNERS
    buf, out = sanitize.guarded((5,), "cpu", torch.int32)
    out.copy_(hd.dfa_count(first[1][:1].expand(5, -1).contiguous(), first[2],
                           first[3]))
    sanitize.check_guards(buf, 5, "counts")
    assert out.dtype == torch.int32 and out.data_ptr() % 16 == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The kernel against its plain version count for count at every case of
    sanitize.dfa_cases around the card's grid, and on real codewords
    against their number."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    recs = sanitize.run_dfa("cuda")
    assert len(recs) == len(sanitize.dfa_shapes(hd.persistent_width("cuda"))) \
        * len(sanitize.DFA_TABLES) + len(sanitize.DFA_TABLES)
    assert all(r["max_abs_err"] == 0 for r in recs)
