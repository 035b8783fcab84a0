// The encoder's inner rate bisection for NVIDIA Hopper (sm_90a): for each
// granule-channel row, the fixed-step bisection over global_gain of
// encoder/vloop_device.py:_inner_bisect (quantize, exact Huffman bit count,
// fit test, every step) or, in count-only mode, _count_rows of given
// quantized rows. Bit for bit what the plain torch version gives.
//
// Replaces no Pallas kernel: the JAX package's rate loops
// (src/mp3tpu/encoder/vloop_device.py) are jnp code that XLA fuses. It was
// added because in torch a bisection step is about 45 launches around a
// gather of every pair's code length under all 31 table columns ([31, R, 288]
// int16, 585 MB at the 32,768-row block) and a cumsum over it, and the card
// waited on the launches between them.
//
// Per row (a = |ix| of the quantized row; pairs p = lines 2p, 2p + 1; quads
// q = lines 4q .. 4q + 3):
//   rzp = one past the last nonzero pair, rounded up to even; bigp = one past
//   the last pair above 1; k = (rzp - bigp) / 2 count1 quads; bv = rzp - 2k;
//   regions [0, r1), [r1, r2), [r2, bv) of the pairs (r1p[bv], r2p[bv]; or
//   min(bv, fixed_pairs), bv for the switched and short split);
//   a region's bits under table c: the sum of len[bin(p)][c] over its pairs,
//   kInvalid where the region's largest value does not fit the table (plain
//   tables: max < xl; escape tables: bit length of max - 15 <= linbits);
//   bits = sum over regions of (the cheapest table, lowest column among
//   equals; + its sign bits) + min(count1 A, count1 B) over the quads
//   [bv / 2, bv / 2 + k) (A on equal).
//   Bisection: steps times, while lo <= hi: mid = (lo + hi) / 2; a row fits
//   at mid when max a <= IX_MAX and bits <= budget; then hi = mid - 1, else
//   lo = mid + 1.
//
// What bounds it on the card: the bytes are p34 and sign (4,608 B a row) and
// the small per-row vectors, each read or written once a call, at 3.35 TB/s;
// the operations are the length lookups the count needs, one a pair below bv
// and column (31 columns) a counted step, at most 288 x 31, from shared
// memory at 32 a cycle on each of 132 SMs at 1,980 MHz
// (kernels/rate_bisect.py:bound). At the main path's shapes the lookups bound
// it. The design:
//   - one warp owns one row for all its steps. Lane l holds quads l + 32 j
//     (20 lines for l < 16, 16 for the others) in registers, read with 16-byte
//     loads, so the row comes from device memory once a call, not once a step;
//   - a step quantizes in registers: scale[mid] from a table made by the
//     plain version's own torch expression, then floor(p34 * scale + MAGIC)
//     with __fmul_rn / __fadd_rn, which nvcc does not contract into an FMA,
//     as torch's two eager ops round; the bounds rzp, bigp, the regions'
//     maxima and count1's sums are warp reductions; the clamped pair bins
//     below bv go to the warp's array in shared memory;
//   - then lane c owns table column c (30 tables; column 30 the sign bits)
//     and walks the pairs 0 .. bv, adding that column's length to its
//     region's sum: the edges are the warp's, so the walk does not diverge;
//     the bin is a broadcast and the columns neighbouring bytes, so no bank
//     conflicts. No [31, R, 288] tensor and no prefix exist;
//   - the cheapest valid table of a region is a warp min over the key
//     cost * 32 + column (the plain version's first_min), count1 a warp sum,
//     all int32: exact, and the same at every launch shape;
//   - a row leaves the bisection once lo > hi, where every later step of the
//     plain version leaves it unchanged;
//   - a persistent grid (SMs x the blocks that fit an SM, 8 warps a block)
//     loads the length table (uint8: every length is below 46), the region
//     and count1 tables, the validity rules and the gain scales into shared
//     memory once a block, and its warps walk the rows with a stride.
// No TMA and no tensor cores: the work is integer lookups and reductions.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLines = 576;
constexpr int kPairs = 288;
constexpr int kQuads = 144;
constexpr int kSlots = 5;          // quads a lane holds: lane + 32 j, j < 5
constexpr int kBins = 289;         // clamped pair bins, 17 x 17
constexpr int kCols = 32;          // columns of the length table (31 used)
constexpr int kTables = 30;        // column 30 holds the sign bits
constexpr int kInvalid = 1 << 20;  // vloop_device._INVALID
constexpr int kIxMax = 8206;       // quantize.IX_MAX
constexpr int kEsc = 0x100;        // a validity rule's escape flag
constexpr int kMaxDevices = 64;
// the consts vector (kernels/rate_bisect.py:count_consts), int32 words
constexpr int kLenAt = 0;                      // [289][32] code lengths
constexpr int kR1At = kLenAt + kBins * kCols;  // [289] long region 0/1 edge by bv
constexpr int kR2At = kR1At + kBins;           // [289] long region 1/2 edge
constexpr int kC1aAt = kR2At + kBins;          // [16] count1 table A + signs
constexpr int kC1bAt = kC1aAt + 16;            // [16] count1 table B + signs
constexpr int kRuleAt = kC1bAt + 16;           // [32] validity rule by column
constexpr int kScaleAt = kRuleAt + kCols;      // [256] float32 gain scales
constexpr int kMagicAt = kScaleAt + 256;       // float32 MAGIC
constexpr int kConsts = kMagicAt + 1;

struct Params {
  const float* p34;       // bisect: [rows, 576]
  const int32_t* sign;    // bisect: [rows, 576], each -1, 0 or 1
  const int32_t* ix;      // count: [rows, 576]
  const int32_t* budget;  // bisect: [rows]
  const int32_t* lo;      // bisect: [rows], each in [0, 255]
  const int32_t* consts;  // kConsts words
  int32_t* gg;            // bisect outputs [rows]
  uint8_t* has;
  uint8_t* capped;
  int32_t* next_lo;
  int32_t* bits;          // count outputs: [rows], selr [rows, 3]
  int32_t* selr;
  int32_t* bv;
  int32_t* k;
  int32_t* c1sel;
  int rows, steps, window, short_split, fixed_pairs, count_only;
};

struct Shared {
  uint8_t len[kBins * kCols];
  int32_t r1[kBins];
  int32_t r2[kBins];
  int32_t c1a[16];
  int32_t c1b[16];
  int32_t rule[kCols];
  float scale[256];
  uint16_t bins[kWarps][kPairs];  // a warp's pair bins, premultiplied by kCols
};

struct Count {
  int bits, sel0, sel1, sel2, bv, k, c1sel;
};

constexpr unsigned kAll = 0xFFFFFFFFu;

// Whether a region whose largest value is m fits table rule (xl of a plain
// table; kEsc | linbits of an escape table): the plain version's comparison
// ladder, the overflow's bit length capped at 14.
__device__ __forceinline__ bool fits_table(int rule, int m) {
  if (rule & kEsc) {
    const int ov = max(m - 15, 0);
    return min(32 - __clz(ov), 14) <= (rule & 0xFF);
  }
  return m < rule;
}

// The exact count of the row whose magnitudes the warp holds in a (every
// lane gets the same result); bins is the warp's array.
__device__ __forceinline__ Count count_row(const int (&a)[kSlots][4], int lane,
                                           const Shared& s, uint16_t* bins,
                                           bool short_split, int fixed_pairs) {
  int rz = 0, big = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mx = max(a[j][2 * h], a[j][2 * h + 1]);
      const int p1 = 2 * (lane + 32 * j) + h + 1;  // rising: the last is the max
      if (mx > 0) rz = p1;
      if (mx > 1) big = p1;
    }
  }
  rz = __reduce_max_sync(kAll, rz);
  big = __reduce_max_sync(kAll, big);
  rz += rz & 1;
  const int k = (rz - big) >> 1;
  const int bv = rz - 2 * k;
  const int r1 = short_split ? min(bv, fixed_pairs) : s.r1[bv];
  const int r2 = short_split ? bv : s.r2[bv];
  const int q0 = bv >> 1, q1 = (bv >> 1) + k;
  int m0 = 0, m1 = 0, m2 = 0, ca = 0, cb = 0;
  __syncwarp();  // the last walk is done with bins
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int q = lane + 32 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 2 * q + h;
      const int x = a[j][2 * h], y = a[j][2 * h + 1];
      if (p < bv) {
        const int mx = max(x, y);
        bins[p] = (uint16_t)((min((unsigned)x, 16u) * 17 + min((unsigned)y, 16u)) * kCols);
        if (p < r1)
          m0 = max(m0, mx);
        else if (p < r2)
          m1 = max(m1, mx);
        else
          m2 = max(m2, mx);
      }
    }
    if (q >= q0 && q < q1) {
      const int nib = (a[j][0] != 0) << 3 | (a[j][1] != 0) << 2 | (a[j][2] != 0) << 1 |
                      (a[j][3] != 0);
      ca += s.c1a[nib];
      cb += s.c1b[nib];
    }
  }
  m0 = __reduce_max_sync(kAll, m0);
  m1 = __reduce_max_sync(kAll, m1);
  m2 = __reduce_max_sync(kAll, m2);
  ca = __reduce_add_sync(kAll, ca);
  cb = __reduce_add_sync(kAll, cb);
  __syncwarp();  // bins written
  const uint8_t* col = s.len + lane;
  int s0 = 0, s1 = 0, s2 = 0;
#pragma unroll 4
  for (int p = 0; p < r1; ++p) s0 += col[bins[p]];
#pragma unroll 4
  for (int p = r1; p < r2; ++p) s1 += col[bins[p]];
#pragma unroll 4
  for (int p = r2; p < bv; ++p) s2 += col[bins[p]];
  const int signs = __shfl_sync(kAll, s0 + s1 + s2, kTables);
  const int rule = s.rule[lane];
  const bool table = lane < kTables;
  const int key0 = __reduce_min_sync(
      kAll, table ? (fits_table(rule, m0) ? s0 : kInvalid) * 32 + lane : INT_MAX);
  const int key1 = __reduce_min_sync(
      kAll, table ? (fits_table(rule, m1) ? s1 : kInvalid) * 32 + lane : INT_MAX);
  const int key2 = __reduce_min_sync(
      kAll, table ? (fits_table(rule, m2) ? s2 : kInvalid) * 32 + lane : INT_MAX);
  Count c;
  c.bits = (key0 >> 5) + (key1 >> 5) + (key2 >> 5) + signs + min(ca, cb);
  c.sel0 = key0 & 31;
  c.sel1 = key1 & 31;
  c.sel2 = key2 & 31;
  c.bv = bv;
  c.k = k;
  c.c1sel = ca > cb;
  return c;
}

__global__ void __launch_bounds__(kThreads) rate_bisect_kernel(const Params prm) {
  __shared__ Shared s;
  for (int i = threadIdx.x; i < kBins * kCols; i += kThreads)
    s.len[i] = (uint8_t)__ldg(prm.consts + kLenAt + i);
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    s.r1[i] = __ldg(prm.consts + kR1At + i);
    s.r2[i] = __ldg(prm.consts + kR2At + i);
  }
  if (threadIdx.x < 16) {
    s.c1a[threadIdx.x] = __ldg(prm.consts + kC1aAt + threadIdx.x);
    s.c1b[threadIdx.x] = __ldg(prm.consts + kC1bAt + threadIdx.x);
  }
  if (threadIdx.x < kCols) s.rule[threadIdx.x] = __ldg(prm.consts + kRuleAt + threadIdx.x);
  for (int i = threadIdx.x; i < 256; i += kThreads)
    s.scale[i] = __int_as_float(__ldg(prm.consts + kScaleAt + i));
  const float magic = __int_as_float(__ldg(prm.consts + kMagicAt));
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint16_t* bins = s.bins[warp];
  const bool short_split = prm.short_split != 0;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < prm.rows;
       row += (long long)gridDim.x * kWarps) {
    const size_t base = (size_t)row * kLines;
    if (prm.count_only) {
      int a[kSlots][4];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int q = lane + 32 * j;
        int4 v = make_int4(0, 0, 0, 0);
        if (q < kQuads) v = __ldg(reinterpret_cast<const int4*>(prm.ix + base) + q);
        a[j][0] = abs(v.x);
        a[j][1] = abs(v.y);
        a[j][2] = abs(v.z);
        a[j][3] = abs(v.w);
      }
      const Count c = count_row(a, lane, s, bins, short_split, prm.fixed_pairs);
      if (lane == 0) {
        prm.bits[row] = c.bits;
        prm.selr[3 * row] = c.sel0;
        prm.selr[3 * row + 1] = c.sel1;
        prm.selr[3 * row + 2] = c.sel2;
        prm.bv[row] = c.bv;
        prm.k[row] = c.k;
        prm.c1sel[row] = c.c1sel;
      }
      continue;
    }
    float p[kSlots][4];
    unsigned nz = 0;  // bit 4 j + e: line e of quad slot j has a nonzero sign
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int q = lane + 32 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      int4 g = make_int4(0, 0, 0, 0);
      if (q < kQuads) {
        v = __ldg(reinterpret_cast<const float4*>(prm.p34 + base) + q);
        g = __ldg(reinterpret_cast<const int4*>(prm.sign + base) + q);
      }
      p[j][0] = v.x;
      p[j][1] = v.y;
      p[j][2] = v.z;
      p[j][3] = v.w;
      nz |= ((unsigned)(g.x != 0) | (unsigned)(g.y != 0) << 1 | (unsigned)(g.z != 0) << 2 |
             (unsigned)(g.w != 0) << 3) << (4 * j);
    }
    int lo = __ldg(prm.lo + row);
    const int lo_adj = lo;
    int hi = prm.window > 0 ? min(lo + prm.window - 1, 255) : 255;
    const int hi0 = hi;
    const int budget = __ldg(prm.budget + row);
    int best = 210;
    bool has = false;
    for (int step = 0; step < prm.steps && lo <= hi; ++step) {
      const int mid = (lo + hi) >> 1;
      const float sc = s.scale[mid & 255];
      int a[kSlots][4];
      int amax = 0;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // torch: sign * floor(p34 * scale + MAGIC).to(int32), then abs
          const int v = __float2int_rz(floorf(__fadd_rn(__fmul_rn(p[j][e], sc), magic)));
          a[j][e] = (nz >> (4 * j + e) & 1u) ? abs(v) : 0;
          amax = max(amax, a[j][e]);
        }
      }
      const bool over = __reduce_max_sync(kAll, amax) > kIxMax;
      const bool fits =
          !over && count_row(a, lane, s, bins, short_split, prm.fixed_pairs).bits <= budget;
      if (fits) {
        best = mid;
        has = true;
        hi = mid - 1;
      } else {
        lo = mid + 1;
      }
    }
    if (lane == 0) {
      prm.gg[row] = has ? best : 210;
      prm.has[row] = has;
      prm.capped[row] = !has && hi0 < 255;
      prm.next_lo[row] = min(lo_adj + prm.window, 255);
    }
  }
}

int blocks_per_sm(int* per_sm) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rate_bisect_kernel,
                                                                kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch(const Params& prm, void* stream) {
  if (prm.rows < 0 || prm.steps < 0 || prm.window < 0 || prm.window > 256 ||
      prm.fixed_pairs < 0 || prm.fixed_pairs > kPairs || prm.consts == nullptr)
    return (int)cudaErrorInvalidValue;
  if (prm.rows == 0) return (int)cudaSuccess;
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
  const long long need = ((long long)prm.rows + kWarps - 1) / kWarps;
  const int grid = (int)(need < grid_of[dev] ? need : grid_of[dev]);
  rate_bisect_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// The bisection of `rows` rows: p34 float32 and sign int32 [rows, 576] (each
// 16-byte aligned), budget and lo int32 [rows] (lo in [0, 255]), consts the
// kConsts words of kernels/rate_bisect.py:count_consts; `steps` steps over
// [lo, 255] (window 0) or [lo, min(lo + window - 1, 255)]. Writes gg, next_lo
// int32 and has, capped uint8 [rows]. Returns the cudaError_t of the launch
// (0: launched; rows == 0 launches nothing).
extern "C" int mp3tpu_rate_bisect(const void* p34, const void* sign, const void* budget,
                                  const void* lo, const void* consts, void* gg, void* has,
                                  void* capped, void* next_lo, int rows, int steps,
                                  int window, int short_split, int fixed_pairs,
                                  void* stream) {
  if (!aligned16(p34) || !aligned16(sign)) return (int)cudaErrorInvalidValue;
  Params prm = {};
  prm.p34 = (const float*)p34;
  prm.sign = (const int32_t*)sign;
  prm.budget = (const int32_t*)budget;
  prm.lo = (const int32_t*)lo;
  prm.consts = (const int32_t*)consts;
  prm.gg = (int32_t*)gg;
  prm.has = (uint8_t*)has;
  prm.capped = (uint8_t*)capped;
  prm.next_lo = (int32_t*)next_lo;
  prm.rows = rows;
  prm.steps = steps;
  prm.window = window;
  prm.short_split = short_split;
  prm.fixed_pairs = fixed_pairs;
  prm.count_only = 0;
  return launch(prm, stream);
}

// The exact count of `rows` quantized rows ix int32 [rows, 576] (16-byte
// aligned): bits, bv, k, c1sel int32 [rows] and the three regions' table
// columns selr int32 [rows, 3].
extern "C" int mp3tpu_rate_count(const void* ix, const void* consts, void* bits, void* selr,
                                 void* bv, void* k, void* c1sel, int rows, int short_split,
                                 int fixed_pairs, void* stream) {
  if (!aligned16(ix)) return (int)cudaErrorInvalidValue;
  Params prm = {};
  prm.ix = (const int32_t*)ix;
  prm.consts = (const int32_t*)consts;
  prm.bits = (int32_t*)bits;
  prm.selr = (int32_t*)selr;
  prm.bv = (int32_t*)bv;
  prm.k = (int32_t*)k;
  prm.c1sel = (int32_t*)c1sel;
  prm.rows = rows;
  prm.short_split = short_split;
  prm.fixed_pairs = fixed_pairs;
  prm.count_only = 1;
  return launch(prm, stream);
}

// The persistent grid's shape: blocks per SM (the occupancy query), threads
// and static shared memory a block, and the consts' length in words.
extern "C" int mp3tpu_rate_config(int* per_sm, int* threads, int* smem_bytes,
                                  int* consts_words) {
  *threads = kThreads;
  *smem_bytes = (int)sizeof(Shared);
  *consts_words = kConsts;
  return blocks_per_sm(per_sm);
}

extern "C" const char* mp3tpu_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
