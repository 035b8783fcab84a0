// The bit-serial transition chain of a Huffman decode, for NVIDIA Hopper
// (sm_90a): for each row of packed bits, walk a binary automaton one bit at
// a time and count the transitions into state 0. In the automata of
// kernels/huffman_dfa.py (count1_dfa, bigvalues_dfa) state 0 is the root of
// a code's trie, so each such transition completes one codeword with its
// trailing linbits and sign bits.
//
// Replaces the JAX package's measurement in tools/device_huffman_spike.py
// (:94-109, the jitted `fsm`: jnp code, no Pallas kernel): the bytes unpacked
// to int32 bits and a lax.scan over bit steps with one jnp.take from the
// flat table a step. That is the formulation the TPU forced (its only
// parallelism the vector of rows, one step at a time), not the function. The
// plain PyTorch version, kernels/huffman_dfa.py:dfa_count_reference, keeps
// it as a loop over steps with a gather.
//
// Per row r (rows of row_bytes bytes, bits MSB first within a byte):
//   s = 0; count = 0
//   for i in 0 .. nbits-1:  s = trans[s][bit i]; count += (s == 0)
//   counts[r] = count
//
// What bounds it on the card: the bytes are nbits / 8 in and 4 out a row;
// the lookups are dependent, 32 a cycle on each of the 132 SMs. A table of
// k bits a lookup (the state after k bits and the codewords completed in
// them; k = 12 for count1-A, 8 for the big-values tables, in 227 KB of
// shared memory) needs ceil(nbits / k) lookups a row, so the function's
// bound is its bytes (kernels/huffman_dfa.py:bound). This kernel is the
// simple form: one bit a lookup, rows x nbits lookups, which is what
// limits it. One row is a chain that cannot be split (a step needs the
// state of the one before it), so the rows are the parallelism. The design:
//   - one thread owns one row's whole chain, in a persistent grid (SMs x
//     the blocks that fit one SM, 128 threads a block) that walks the rows
//     with a stride of the grid's width;
//   - the table is staged once per block into shared memory as one 32-bit
//     word a state: the two successors' byte offsets in that table, 16 bits
//     each, so a step is a shift (by 0 or 16, from the bit), a mask, one
//     shared load and a compare; a successor is masked into the table
//     (kMaxStates entries, zeros past n_states), so a bad table cannot make a
//     load leave it;
//   - a row's bits arrive 32 at a time in a register (one 4-byte load where
//     the rows are 4-byte aligned, else four byte loads), read through the
//     read-only cache: neighbouring threads read neighbouring rows, so a
//     warp's rows share cache lines;
//   - counts are int32, added in the row's own order: no atomics and no
//     float, so the result is exact and the same at every launch shape.
// No TMA and no tensor cores: the work is a chain of table lookups.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStates = 1024;   // the table's entries; a power of two
constexpr int kMaxDevices = 64;

// Four bytes of a row at p, big-endian (the first byte's MSB is the first
// bit): one 4-byte load where `aligned`, else four byte loads.
__device__ __forceinline__ uint32_t load_be32(const uint8_t* __restrict__ p,
                                              bool aligned) {
  if (aligned)
    return __byte_perm(__ldg(reinterpret_cast<const unsigned int*>(p)), 0u, 0x0123u);
  return (uint32_t)__ldg(p) << 24 | (uint32_t)__ldg(p + 1) << 16 |
         (uint32_t)__ldg(p + 2) << 8 | (uint32_t)__ldg(p + 3);
}

__global__ void __launch_bounds__(kThreads)
dfa_count_kernel(const uint8_t* __restrict__ packed, const uint32_t* __restrict__ trans,
                 int n_states, int32_t* __restrict__ counts, int rows,
                 long long row_bytes, int nbits, bool aligned) {
  // tab[s]: bits 0-15 the byte offset of trans[s][0], bits 16-31 that of
  // trans[s][1]; trans[s] is the int16 pair (on 0, on 1) read as one word
  __shared__ uint32_t tab[kMaxStates];
  for (int s = threadIdx.x; s < kMaxStates; s += kThreads) {
    const uint32_t w = s < n_states ? __ldg(trans + s) : 0u;
    const uint32_t on0 = (w & 0xFFFFu) & (kMaxStates - 1);
    const uint32_t on1 = (w >> 16) & (kMaxStates - 1);
    tab[s] = on0 << 2 | on1 << 18;
  }
  __syncthreads();
  const char* tbase = reinterpret_cast<const char*>(tab);
  const int words = nbits >> 5;
  const int rest = nbits & 31;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < rows;
       r += (long long)gridDim.x * kThreads) {
    const uint8_t* row = packed + r * row_bytes;
    uint32_t off = 0;  // byte offset of the current state in tab: the root
    int count = 0;
    for (int w = 0; w < words; ++w) {
      const uint32_t bits = load_be32(row + 4 * w, aligned);
#pragma unroll
      for (int k = 31; k >= 0; --k) {
        const uint32_t e = *reinterpret_cast<const uint32_t*>(tbase + off);
        off = (e >> ((bits >> k & 1u) << 4)) & 0xFFFFu;
        count += off == 0u;
      }
    }
    if (rest) {
      // the last (rest + 7) / 8 bytes of the row's bits, MSB first
      const uint8_t* p = row + 4 * words;
      uint32_t bits = 0;
      for (int b = 0; b < (rest + 7) >> 3; ++b) bits |= (uint32_t)__ldg(p + b) << (24 - 8 * b);
      for (int k = 31; k > 31 - rest; --k) {
        const uint32_t e = *reinterpret_cast<const uint32_t*>(tbase + off);
        off = (e >> ((bits >> k & 1u) << 4)) & 0xFFFFu;
        count += off == 0u;
      }
    }
    counts[r] = count;
  }
}

int blocks_per_sm(int* per_sm) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, dfa_count_kernel,
                                                                kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

}  // namespace

// packed uint8 [rows, row_bytes], trans int16 [n_states, 2] (4-byte
// aligned), counts int32 [rows]; all contiguous, on the current device;
// 1 <= n_states <= 1024, 0 <= nbits <= 8 * row_bytes. Returns the
// cudaError_t of the launch (0: launched; rows == 0 launches nothing).
extern "C" int mp3tpu_dfa_count(const void* packed, const void* trans, int n_states,
                                void* counts, int rows, long long row_bytes, int nbits,
                                void* stream) {
  if (n_states < 1 || n_states > kMaxStates || rows < 0 || nbits < 0 || row_bytes < 0 ||
      (long long)nbits > 8 * row_bytes || (reinterpret_cast<uintptr_t>(trans) & 3))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  static int grid_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (grid_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int rc = blocks_per_sm(&per_sm);
    if (rc != 0) return rc;
    grid_of[dev] = sms * per_sm;
  }
  const long long need = ((long long)rows + kThreads - 1) / kThreads;
  const int grid = (int)(need < grid_of[dev] ? need : grid_of[dev]);
  const bool aligned = ((reinterpret_cast<uintptr_t>(packed) | (uintptr_t)row_bytes) & 3) == 0;
  dfa_count_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint32_t*)trans, n_states, (int32_t*)counts, rows,
      row_bytes, nbits, aligned);
  return (int)cudaGetLastError();
}

// The persistent grid's shape: blocks per SM (the occupancy query) and
// threads a block.
extern "C" int mp3tpu_dfa_config(int* per_sm, int* threads) {
  *threads = kThreads;
  return blocks_per_sm(per_sm);
}

extern "C" const char* mp3tpu_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
