"""The bit-serial transition chain of a Huffman decode: for each row of
packed bits, walk a binary automaton one bit at a time and count the
transitions into state 0 (counterpart of the measurement in the JAX
package's tools/device_huffman_spike.py, whose `fsm` is jnp code there, not a
TPU kernel).

dfa_count runs the CUDA kernel of csrc/huffman_dfa.cu on CUDA tensors and
its plain PyTorch version, dfa_count_reference (the JAX tool's formulation:
the bits unpacked, a loop over bit steps with one gather from the flat
table a step), on CPU tensors. No decode path calls it: it measures what
the Huffman decode's irreducible part would cost on the card
(mp3tpu_torch.tools.device_huffman_spike), and chip_smoke.py holds it to its
plain version.

The automata: state 0 is the root of a code's trie, so every transition into
it completes one codeword with its trailing bits.
  count1a_dfa(): count1 table A (ISO 11172-3 Annex B.7), the trie of its
      16 codes (15 internal nodes) and a chain for the quad's sign bits, 19
      states: the JAX tool's build_count1a_dfa(), state for state.
  bigvalues_dfa(table): the trie of a big-values table's codes (255 internal
      nodes for the 16 x 16 tables) and, after each leaf (x, y), a chain for
      the bits that follow it: x's linbits where x == 15, x's sign where x !=
      0, then the same for y. Chain states are shared by the count of bits
      left (table 31: at most 2 * 13 + 2 = 28).
codeword_rows() makes rows of real concatenated codewords with their
trailing bits, and the number of codewords in each, for the tests and
chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from ..tables import huffman as ht

MAX_STATES = 1024      # csrc/huffman_dfa.cu kMaxStates
THREADS = 128          # csrc/huffman_dfa.cu kThreads
# the bound's card, an H100 SXM: SMs, shared-memory words a SM delivers a
# cycle, shared memory one block may hold, HBM bytes a second
H100_SMS = 132
LOOKUPS_PER_CYCLE = 32
SMEM_BYTES = 227 * 1024
HBM_BYTES_PER_S = 3.35e12
# an entry of a k-bit table (table_bits): the state after k bits (below
# MAX_STATES: 10 bits) and the codewords completed in them (at most k <= 31:
# 5 bits)
ENTRY_BYTES = 2


def _code_dfa(codes, lens, trailing) -> tuple:
    """The automaton of a prefix code: a binary trie over the codes (state 0
    its root, internal nodes numbered as they are first reached, codes in
    order, bits MSB first), each leaf leading to the chain state of its
    symbol's `trailing` bit count (or back to the root when it has none),
    chain state k (numbered n_trie + k - 1) to chain state k - 1 on either
    bit, and chain state 1 to the root. Returns (trans int16 [n, 2], n)."""
    children = [[-1, -1]]
    leaf = {}
    for q, (code, ln) in enumerate(zip(codes, lens)):
        if ln == 0:
            continue
        s = 0
        for i in range(ln - 1, -1, -1):
            b = (code >> i) & 1
            if i == 0:
                leaf[(s, b)] = q
            else:
                if children[s][b] == -1:
                    children.append([-1, -1])
                    children[s][b] = len(children) - 1
                s = children[s][b]
    n_trie = len(children)
    max_k = max(trailing)
    chain = {k: n_trie + k - 1 for k in range(1, max_k + 1)}
    n = n_trie + max_k
    if n > MAX_STATES:
        raise ValueError(f"{n} states, more than the kernel's {MAX_STATES}")
    trans = np.zeros((n, 2), np.int16)
    for s in range(n_trie):
        for b in (0, 1):
            if (s, b) in leaf:
                k = trailing[leaf[(s, b)]]
                trans[s, b] = chain[k] if k else 0
            elif children[s][b] != -1:
                trans[s, b] = children[s][b]
            # else 0: no code takes this bit (an incomplete code)
    for k in range(1, max_k + 1):
        trans[chain[k]] = 0 if k == 1 else chain[k - 1]
    return trans, n


def _symbols(table) -> tuple:
    """(codes, lens, trailing bits, values) of `table`: "count1a" (values
    [16, 4], the quad's lines v, w, x, y) or a big-values table id (values
    [n, 2], the pair (x, y); trailing counts linbits at 15 and signs)."""
    if table == "count1a":
        codes, lens = ht.COUNT1A_CODES, ht.COUNT1A_LENS
        vals = np.array([[(q >> (3 - j)) & 1 for j in range(4)]
                         for q in range(16)])
        return codes, lens, [int(v.sum()) for v in vals], vals
    lens, codes, _xl, yl, linbits = ht.table_arrays(int(table))
    vals = np.array([divmod(i, yl) for i in range(len(codes))])
    trailing = [int(sum((linbits if v == 15 else 0) + (v != 0) for v in xy))
                for xy in vals]
    return [int(c) for c in codes], [int(n) for n in lens], trailing, vals


@functools.cache
def _automaton(table) -> tuple:
    codes, lens, trailing, _ = _symbols(table)
    trans, n = _code_dfa(codes, lens, trailing)
    trans.flags.writeable = False
    return trans, n


def count1a_dfa() -> tuple:
    """count1 table A's automaton: (trans int16 [19, 2], 19)."""
    trans, n = _automaton("count1a")
    return trans.copy(), n


def bigvalues_dfa(table: int) -> tuple:
    """Big-values table `table`'s automaton (its tree's codes, its own
    linbits): (trans int16 [n, 2], n)."""
    if ht.TABLE_INFO.get(int(table)) is None or int(table) == 0:
        raise ValueError(f"table {table} has no codes")
    trans, n = _automaton(int(table))
    return trans.copy(), n


def automaton(table) -> tuple:
    """count1a_dfa() for "count1a", else bigvalues_dfa(table)."""
    return count1a_dfa() if table == "count1a" else bigvalues_dfa(table)


# ----------------------------------------------------------- real codewords

FILL = 64  # a row's last bits, filled exactly by the fewest codewords


def codeword_rows(table, rows: int, nbits: int, seed: int) -> tuple:
    """`rows` rows of exactly `nbits` bits, each a string of real codewords
    of `table` with their trailing bits: symbols drawn as random bits would
    decode them (probability 2^-length), linbits and signs random, the last
    FILL bits filled exactly by the fewest codewords. Returns (packed uint8
    [rows, ceil(nbits / 8)], codewords int64 [rows], the lines each row
    codes: a list of int64 arrays, 4 a quad or 2 a pair, signed, linbits
    added, in the order a decoder writes them)."""
    codes, lens, trailing, vals = _symbols(table)
    linbits = 0 if table == "count1a" else ht.table_arrays(int(table))[4]
    live = [q for q in range(len(codes)) if lens[q] > 0]
    size = np.array([lens[q] + trailing[q] for q in live])
    prob = np.array([2.0 ** -lens[q] for q in live])
    prob /= prob.sum()
    # fewest[r]: the fewest codewords that fill r bits exactly (-1: none)
    top = FILL + int(size.max())
    fewest = np.full(top + 1, -1, np.int64)
    pick = np.zeros(top + 1, np.int64)
    fewest[0] = 0
    for r in range(1, top + 1):
        for i, s in enumerate(size):
            if s <= r and fewest[r - s] >= 0 and (
                    fewest[r] < 0 or fewest[r - s] + 1 < fewest[r]):
                fewest[r], pick[r] = fewest[r - s] + 1, i
    if nbits <= top and fewest[nbits] < 0:
        raise ValueError(f"no string of {table}'s codewords is {nbits} bits")
    rng = np.random.default_rng(seed)
    bits = np.zeros((rows, nbits), np.uint8)
    counts = np.zeros(rows, np.int64)
    lines = []
    for r in range(rows):
        chosen, left = [], nbits
        for i in rng.choice(len(live), size=nbits, p=prob):
            if left <= top and fewest[left] >= 0:
                break
            if left - size[i] > top or fewest[left - size[i]] >= 0:
                chosen.append(i)
                left -= size[i]
        if left > top or fewest[left] < 0:
            raise ValueError(f"{table}: no exact fill of a row's last {left} bits")
        while left:
            chosen.append(pick[left])
            left -= size[pick[left]]
        row, out = [], []
        for i in chosen:
            q = live[i]
            row.append((codes[q] >> np.arange(lens[q] - 1, -1, -1)) & 1)
            for v in vals[q]:
                v = int(v)
                if linbits and v == 15:
                    ext = int(rng.integers(0, 1 << linbits))
                    row.append((ext >> np.arange(linbits - 1, -1, -1)) & 1)
                    v += ext
                if v:
                    sign = int(rng.integers(0, 2))
                    row.append(np.array([sign]))
                    v = -v if sign else v
                out.append(v)
        bits[r] = np.concatenate(row)
        counts[r] = len(chosen)
        lines.append(np.array(out, np.int64))
    return np.packbits(bits, axis=1), counts, lines


# --------------------------------------------------------------- the kernel

def dfa_count_reference(packed: torch.Tensor, trans: torch.Tensor,
                        nbits: int | None = None) -> torch.Tensor:
    """The chain as the JAX tool computes it: bits unpacked MSB first, then
    for each bit step s = flat[2 s + bit], count += (s == 0). packed uint8
    [rows, nbytes], trans int16 [n, 2] -> counts int32 [rows]."""
    rows, nbytes = packed.shape
    nbits = 8 * nbytes if nbits is None else nbits
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = ((packed[:, :, None] >> shifts) & 1).reshape(rows, -1)[:, :nbits]
    bits = bits.t().contiguous()                               # [nbits, rows]
    flat = trans.reshape(-1).long()
    state = torch.zeros(rows, dtype=torch.long, device=packed.device)
    count = torch.zeros(rows, dtype=torch.int32, device=packed.device)
    for i in range(nbits):
        state = flat[state * 2 + bits[i]]
        count += state == 0
    return count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build("huffman_dfa.cu")))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mp3tpu_dfa_count.restype = I
    lib.mp3tpu_dfa_count.argtypes = [P, P, I, P, I, ctypes.c_longlong, I, P]
    lib.mp3tpu_dfa_config.restype = I
    lib.mp3tpu_dfa_config.argtypes = [ctypes.POINTER(I)] * 2
    lib.mp3tpu_cuda_error_string.restype = ctypes.c_char_p
    lib.mp3tpu_cuda_error_string.argtypes = [I]
    return lib


def _check(packed, trans, nbits) -> int:
    """The bits a row holds to walk; raises on what the kernel does not
    take."""
    if packed.dim() != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"packed: {packed.dtype} {tuple(packed.shape)}, "
                         "expected uint8 [rows, nbytes]")
    if trans.dim() != 2 or trans.shape[1] != 2 or trans.dtype != torch.int16:
        raise ValueError(f"trans: {trans.dtype} {tuple(trans.shape)}, "
                         "expected int16 [n_states, 2]")
    if not 1 <= trans.shape[0] <= MAX_STATES:
        raise ValueError(f"trans: {trans.shape[0]} states, expected 1 to "
                         f"{MAX_STATES}")
    if trans.device != packed.device:
        raise ValueError(f"trans is on {trans.device}, packed on {packed.device}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dfa_count runs on cpu or cuda, not {packed.device}")
    nbits = 8 * packed.shape[1] if nbits is None else int(nbits)
    if not 0 <= nbits <= 8 * packed.shape[1] or nbits >= 1 << 31:
        raise ValueError(f"nbits {nbits}: a row holds {8 * packed.shape[1]}")
    if packed.shape[0] >= 1 << 31:
        raise ValueError(f"{packed.shape[0]} rows: at most 2^31 - 1")
    return nbits


def _launch(packed, trans, nbits: int, out=None) -> torch.Tensor:
    """Launch the kernel of csrc/huffman_dfa.cu on the current CUDA stream
    -> counts int32 [rows]; `out`, where given, is the int32 [rows] tensor it
    writes (sanitize.py's guarded outputs)."""
    rows = packed.shape[0]
    packed = packed.contiguous()
    trans = trans.contiguous()
    if out is None:
        out = torch.empty(rows, dtype=torch.int32, device=packed.device)
    if tuple(out.shape) != (rows,) or out.dtype != torch.int32 \
            or not out.is_contiguous():
        raise ValueError(f"out: {out.dtype} {tuple(out.shape)}, expected a "
                         f"contiguous int32 ({rows},)")
    lib = _library()
    with torch.cuda.device(packed.device):
        rc = lib.mp3tpu_dfa_count(
            packed.data_ptr(), trans.data_ptr(), trans.shape[0], out.data_ptr(),
            rows, packed.shape[1], nbits, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("mp3tpu_dfa_count kernel launch failed: "
                           + lib.mp3tpu_cuda_error_string(rc).decode())
    return out


def kernel_config(device=None) -> dict:
    """The kernel's launch shape on a CUDA device: blocks per SM (the
    occupancy query) and threads a block."""
    per_sm, threads = ctypes.c_int(0), ctypes.c_int(0)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.mp3tpu_dfa_config(ctypes.byref(per_sm), ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError(lib.mp3tpu_cuda_error_string(rc).decode())
    return {"blocks_per_sm": per_sm.value, "threads": threads.value}


def persistent_width(device) -> int:
    """Rows the persistent grid walks at once on CUDA device `device`: its
    SMs x blocks an SM (the occupancy query) x threads a block."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cfg = kernel_config(device)
    return sms * cfg["blocks_per_sm"] * cfg["threads"]


def table_bits(n_states: int) -> int:
    """The widest k for which a table of k bits a lookup fits SMEM_BYTES:
    n_states x 2^k entries of ENTRY_BYTES each."""
    k = 1
    while k < 31 and n_states * (2 << k) * ENTRY_BYTES <= SMEM_BYTES:
        k += 1
    return k


def bound(rows: int, nbits: int, row_bytes: int, n_states: int,
          sm_clock_mhz: float, sms: int = H100_SMS) -> dict:
    """The least time the card could take for one call: the larger of the
    bytes (packed and the table read once, the counts written once) over
    HBM_BYTES_PER_S and the fewest shared-memory lookups the function needs
    over the SMs' LOOKUPS_PER_CYCLE a cycle at `sm_clock_mhz`: ceil(nbits /
    k) a row through the widest k-bit table that fits (table_bits; its
    build not counted). The kernel walks one bit a lookup: the same bound
    at rows x nbits lookups comes beside it as "bit_serial_us"."""
    nbytes = rows * row_bytes + 4 * n_states + 4 * rows
    k = table_bits(n_states)
    lookups = rows * -(-nbits // k)
    rate = sms * LOOKUPS_PER_CYCLE * sm_clock_mhz * 1e6
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = lookups / rate
    return {"bytes": nbytes, "table_bits": k, "lookups": lookups,
            "bound_us": 1e6 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bit_serial_us": 1e6 * max(t_bytes, rows * nbits / rate)}


def dfa_count(packed: torch.Tensor, trans: torch.Tensor,
              nbits: int | None = None) -> torch.Tensor:
    """Walk automaton `trans` (int16 [n_states, 2], n_states <= MAX_STATES;
    state 0 the start) over the first `nbits` bits (default all) of each row
    of `packed` (uint8 [rows, nbytes], MSB first) -> the transitions into
    state 0 of each row, int32 [rows].

    On CUDA tensors it launches the kernel of csrc/huffman_dfa.cu (built at
    first use) and counts the launch in dfa_count.launches; on CPU tensors
    it runs dfa_count_reference. Every successor in `trans` must lie in [0,
    n_states) (the automata of this module do): the plain version then
    gives what the kernel does, and the kernel never reads outside its
    table whatever `trans` holds. Zero rows give an empty result with no
    launch."""
    nbits = _check(packed, trans, nbits)
    if packed.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=packed.device)
    if packed.device.type == "cpu":
        if trans.numel() and (int(trans.min()) < 0
                              or int(trans.max()) >= trans.shape[0]):
            raise ValueError("trans: a successor outside [0, n_states)")
        return dfa_count_reference(packed, trans, nbits)
    out = _launch(packed, trans, nbits)
    dfa_count.launches += 1
    return out


dfa_count.launches = 0
