// C6-C7 of the MP3 Layer III granule chain, for NVIDIA Hopper (sm_90a):
// overlap-add, frequency inversion and the polyphase synthesis, as the
// standard matrixing and 16-tap window.
//
// Not a port of a TPU kernel: in the JAX package C6-C7 is jnp code
// (mp3tpu/kernels/pipeline.py:_backend: the overlap-add, the inversion mask
// and the einsum "sctdk,dkj->sctj" over synth_fir [16, 32, 32]). The plain
// PyTorch version (kernels/synth.py:synth_backend_reference) unfolds the
// time axis into [S*2*T, 512] windows and hands one matmul to cuBLAS, which
// picks its tiles and its split of the sum by the call's shape, so a
// sample's bits would change with S, G and the place of its window. This
// kernel writes the order down.
//
// Per (stream s, channel c), with T = G*18 time steps of 32 subbands:
//   seq[t, k]  = (z[s, g, c, k, i] + tail) * inv_mask[k, i],  t = g*18 + i,
//                tail = z[s, g-1, c, k, 18+i], or overlap[s, c, k, i] at g = 0
//                (one __fadd_rn, then one __fmul_rn);
//   full       = hist[s, c] (15 rows) ++ seq (T rows);
//   V[u, i]    = sum over k = 0..31 of N[i, k] * full[u, k],  i = 0..63;
//   pcm[t, j]  = sum over d = 0..15 of D[32d + j] * V[t + 15 - d, j + 32 (d & 1)];
//   new_hist   = the last 15 rows of full (rows of seq: T >= 18).
// N [64, 32] is the matrixing and D [512] the window of ISO 11172-3
// (tables/filterbank.py: synthesis_matrix, synthesis_window). synth_fir, the
// plain version's 512 taps, is exactly this product taken together:
// synth_fir[d, k, j] = D[32d + j] * N[j + 32 (d & 1), k]. N's symmetries,
// N[16] = 0, N[32 - i] = -N[i] and N[96 - i] = N[i], leave 32 distinct
// values of V a row: P[m] = V[m] and P[16 + m] = V[33 + m], m < 16. The
// others are sign flips and copies of them, and V[16] is 0.0f. The new
// overlap, z[s, G-1, c, :, 18:], is a copy the wrapper makes.
//
// The order of each sum: ONE thread owns each sum whole and starts it from
// 0.0f, each step one __fmaf_rn (a fused multiply-add, rounded once):
//   P[u, m]    adds N[i(m), k] * full[u, k] for k = 0..31 in that order;
//   pcm[t, j]  adds D[32d + j] * V[t + 15 - d, j + 32 (d & 1)] for d = 0..15
//              in that order, reading a flipped V as P with the sign moved
//              onto D (-D * P and D * -P are the same product) and V[16] as
//              a column of 0.0f.
// No atomicAdd, no split of a sum over threads, no --use_fast_math. The
// 15 rows of V before a tile (its halo) are computed again by the tile, by
// the same code in the same order as in the tile that owns them, and the
// rows of hist give their V by that code too. So a sample's bits depend on
// its own inputs only: not on S, G, the tile, the grid or where a window
// starts.
//
// What bounds it on the card: per sample, 8 bytes of z in and 4 of PCM out
// against 48 multiply-adds (32 of the matrixing, 16 of the window; the
// halo adds 16/72 of the matrixing): about 8 operations a byte, under the
// float32 ridge (about 20), so the memory bounds it, at 35.1 us for S=256 x
// 32 granules. No tensor cores: the arithmetic is under the bound in
// float32, and TF32 would not hold the int16 contract. The design:
//   - a persistent grid (SMs x 3 blocks of 192 threads) walks over tiles of
//     (s, c, 4 granules = 72 time steps), time fastest, so that two
//     neighbouring tiles, which read two granules in common, run together
//     and the second finds them in L2;
//   - a tile's z arrives as whole granule blocks (4,608 contiguous bytes
//     each: the 4 it owns and the 2 before them, for the halo and the first
//     tail; the first tile of a row takes the row's overlap and hist in place
//     of the two) by TMA bulk copies into a ring of two stages on mbarriers,
//     issued by one thread two tiles ahead;
//   - the tables are small: the 32 distinct rows of N (4 KB) and inv_mask in
//     shared memory, staged once per block; each thread's 16 window taps in
//     registers for the whole run;
//   - seq (88 rows: 16 of halo, the first unused, and 72 owned) goes to
//     shared memory subband-major, one warp a granule and lane = subband:
//     a row of z is nine 16-byte loads, without bank conflicts;
//   - the matrixing is a product tiled in registers, 4 rows x 4 values of P
//     a thread, two 16-byte loads a k for 16 multiply-adds; P then
//     overwrites seq in the same buffer;
//   - the window: lane = output subband j, 12 time steps a thread, the 27
//     rows of the two columns of P it reads as 16-byte loads without bank
//     conflicts (column stride 92 floats);
//   - PCM leaves channel-planar, [S, 2, T*32], 128 bytes a warp and store;
//     the wrapper hands out the [S, T*32, 2] view of it, as the plain
//     version does.
// chip_smoke.py --variants times the kernel with each phase's arithmetic
// left out (MP3TPU_SY_SKIP); PERF.md holds what it found.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_tma.h"  // mbarrier, TMA bulk copies

namespace {

constexpr int kGran = 4;                      // granules a tile owns
constexpr int kOwn = kGran * 18;              // time steps a tile owns
constexpr int kHalo = 16;                     // rows before them: the 15 of V
                                              // the window reads, and one that
                                              // keeps rows in pairs and quads
constexpr int kRows = kHalo + kOwn;           // 88 rows of full
constexpr int kQuads = kRows / 4;             // row quads of the matrixing
constexpr int kSlots = kGran + 2;             // granule blocks of z a tile reads
constexpr int kZ = 32 * 36;                   // floats of z per (s, g, c)
constexpr int kStages = 2;                    // input ring depth
constexpr int kThreads = 192;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kOwn / kWarps;           // window: time steps a thread
constexpr int kLoad = (kPer + kHalo) / 4;     // window: float4 per column
constexpr int kStride = 92;                   // floats per column of buf
constexpr int kCols = 33;                     // 32 of seq or P, one of zeros
constexpr int kBlocksPerSm = 3;
constexpr int kMaxDevices = 64;
// Measurement variants (chip_smoke.py --variants builds them with -D): a
// bit mask of the arithmetic left out, 1 seq, 2 the matrixing, 4 the
// window. PCM is then wrong; only the time is read.
#ifndef MP3TPU_SY_SKIP
#define MP3TPU_SY_SKIP 0
#endif

// shared memory of one block, in bytes; every offset a multiple of 16
constexpr int kStageBytes = kSlots * kZ * 4;
constexpr int kBuf = kStages * kStageBytes;
constexpr int kN = kBuf + kCols * kStride * 4;
constexpr int kInv = kN + 32 * 32 * 4;
constexpr int kBar = kInv + 32 * 18 * 4;
constexpr int kSmemBytes = kBar + 8 * kStages;  // 73,856
constexpr int kStateBytes = (32 * 18 + 15 * 32) * 4;  // a row's overlap and hist

static_assert(kGran == 4 && kHalo == 16 && kWarps > kGran,
              "seq: warp w takes slot q = w + 1, buf rows 18q - 20 + i");
static_assert(kOwn % kWarps == 0 && kPer % 4 == 0, "window rows start on a float4");
static_assert(kRows <= kStride && kOwn - kPer + 4 * kLoad <= kStride,
              "every float4 stays in its column");
static_assert(kStride % 32 == 28 || kStride % 32 == 4,
              "8 consecutive columns fall in 8 distinct 16-byte bank groups");
static_assert(kQuads * 8 <= kThreads, "one matrixing task a thread");
static_assert(kStageBytes % 16 == 0 && kBuf % 16 == 0 && kN % 16 == 0 &&
              kInv % 16 == 0 && kBar % 8 == 0,
              "TMA, float4 and mbarrier offsets");

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
synth_kernel(const float* __restrict__ z, const float* __restrict__ overlap,
             const float* __restrict__ hist, const float* __restrict__ inv_mask,
             const float* __restrict__ matrix, const float* __restrict__ window,
             float* __restrict__ pcm, float* __restrict__ new_hist, int G,
             int tiles_per_row, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  // buf [kCols][kStride]: seq[k][r] of the tile's rows, then P[m][r] over it;
  // column 32 stays 0.0f (V[16])
  float* buf = reinterpret_cast<float*>(smem + kBuf);
  float* nm = reinterpret_cast<float*>(smem + kN);     // [32 k][32 m]
  float* inv = reinterpret_cast<float*>(smem + kInv);  // [18 i][32 k]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBar);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int step = gridDim.x;
  const int T = G * 18;

  // tile n's granule blocks g0-2 .. g0+3 (those that exist) -> stage s;
  // slot q of a stage holds granule g0 - 2 + q. The first tile of a row
  // takes the row's overlap [32][18] into slot 0 and hist [15][32] into
  // slot 1 instead.
  auto issue = [&](int n, int s) {
    const int row = n / tiles_per_row;  // s*2 + c
    const int g0 = (n - row * tiles_per_row) * kGran;
    const int ga = g0 >= 2 ? g0 - 2 : 0, gb = g0 + kGran < G ? g0 + kGran : G;
    const uint32_t bar = smem_u32(&full[s]);
    unsigned char* st = smem + s * kStageBytes;
    mbar_expect_tx(bar, (uint32_t)((gb - ga) * kZ * 4 + (g0 == 0 ? kStateBytes : 0)));
    if (g0 == 0) {
      bulk_load(smem_u32(st), overlap + (long long)row * 32 * 18, 32 * 18 * 4, bar);
      bulk_load(smem_u32(st + kZ * 4), hist + (long long)row * 15 * 32, 15 * 32 * 4, bar);
    }
    for (int g = ga; g < gb; ++g)
      bulk_load(smem_u32(st + (g - g0 + 2) * kZ * 4),
                z + (((long long)(row >> 1) * G + g) * 2 + (row & 1)) * kZ, kZ * 4, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      const int n = blockIdx.x + s * step;
      if (n < n_tiles) issue(n, s);
    }
  }

  // the tables, once per block, while the first tiles load
  for (int e = tid; e < 32 * 32; e += kThreads) nm[(e & 31) * 32 + (e >> 5)] = matrix[e];
  for (int e = tid; e < 32 * 18; e += kThreads) inv[(e % 18) * 32 + e / 18] = inv_mask[e];
  for (int e = tid; e < kCols * kStride; e += kThreads) buf[e] = 0.f;
  // the window: lane j's 16 taps, each with the sign of the V it meets;
  // ce and co are the columns of buf that hold V[j] and V[32 + j]
  const int j = lane;
  const int ce = j < 16 ? j : (j == 16 ? 32 : 32 - j);
  const int co = j == 0 ? 0 : (j <= 16 ? 15 + j : 47 - j);
  float taps[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    const float w = __ldg(window + 32 * d + j);
    const bool flip = (d & 1) ? j == 0 : j > 16;
    taps[d] = flip ? -w : w;
  }
  __syncthreads();

  int it = 0;
  for (int n = blockIdx.x; n < n_tiles; n += step, ++it) {
    const int s = it % kStages;
    const int row = n / tiles_per_row;
    const int g0 = (n - row * tiles_per_row) * kGran;
    const int ng = G - g0 < kGran ? G - g0 : kGran;  // granules owned
    const int R = kHalo + 18 * ng;                   // rows of full read
    const int t0 = g0 * 18;
    const float* st = reinterpret_cast<const float*>(smem + s * kStageBytes);

    mbar_wait(smem_u32(&full[s]), (uint32_t)(it / kStages) & 1u);
    __syncthreads();  // the last tile's window has read buf

    // ---- seq of rows t0-16 .. t0+18ng-1 (r = 0..R-1): warp w < 5 takes
    // the granule of slot q = w + 1 (q = 1: the halo, rows i - 2 of granule
    // g0-1; q >= 2: own granule q - 2, rows 18q - 20 + i), lane = subband k;
    // a row of z is read as 16-byte loads, without bank conflicts
    if (warp <= kGran && warp - 1 < ng && !(MP3TPU_SY_SKIP & 1)) {
      const int q = warp + 1, k = lane;
      float v[18];
      if (q == 1 && g0 == 0) {
        // the halo from hist (slot 1): rows 1..15; row 0, before it, is 0
        v[0] = v[1] = v[2] = 0.f;
#pragma unroll
        for (int h = 0; h < 15; ++h) v[3 + h] = st[kZ + h * 32 + k];
      } else {
        float head[20], tail[18];
        const float* zr = st + q * kZ + k * 36;
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          const float4 x = *reinterpret_cast<const float4*>(zr + 4 * f);
          head[4 * f] = x.x; head[4 * f + 1] = x.y; head[4 * f + 2] = x.z; head[4 * f + 3] = x.w;
        }
        if (q == 2 && g0 == 0) {
          // granule 0's tail: the row's overlap (slot 0)
#pragma unroll
          for (int f = 0; f < 9; ++f) {
            const float2 x = *reinterpret_cast<const float2*>(st + k * 18 + 2 * f);
            tail[2 * f] = x.x; tail[2 * f + 1] = x.y;
          }
        } else {
          // the previous granule's outputs 18..35 (16..35 as 16-byte loads)
          const float* tr = st + (q - 1) * kZ + k * 36;
          float t[20];
#pragma unroll
          for (int f = 0; f < 5; ++f) {
            const float4 x = *reinterpret_cast<const float4*>(tr + 16 + 4 * f);
            t[4 * f] = x.x; t[4 * f + 1] = x.y; t[4 * f + 2] = x.z; t[4 * f + 3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < 18; ++i) tail[i] = t[i + 2];
        }
#pragma unroll
        for (int i = 0; i < 18; ++i)
          v[i] = __fmul_rn(__fadd_rn(head[i], tail[i]), inv[i * 32 + k]);
      }
      // buf rows 18q - 20 + i: 4 float4 and a float2 (q even), or a float2
      // and 4 float4 (q odd; the halo's rows -2 and -1 do not exist)
      float* b = buf + k * kStride + 18 * q - 20;
      if (q & 1) {
        if (q != 1) *reinterpret_cast<float2*>(b) = make_float2(v[0], v[1]);
#pragma unroll
        for (int f = 0; f < 4; ++f)
          *reinterpret_cast<float4*>(b + 2 + 4 * f) =
              make_float4(v[2 + 4 * f], v[3 + 4 * f], v[4 + 4 * f], v[5 + 4 * f]);
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f)
          *reinterpret_cast<float4*>(b + 4 * f) =
              make_float4(v[4 * f], v[4 * f + 1], v[4 * f + 2], v[4 * f + 3]);
        *reinterpret_cast<float2*>(b + 16) = make_float2(v[16], v[17]);
      }
      // the carried history: the row's last 15 rows, from its last granule
      if (g0 + ng == G && q - 2 == ng - 1) {
#pragma unroll
        for (int h = 0; h < 15; ++h) new_hist[((long long)row * 15 + h) * 32 + k] = v[3 + h];
      }
    }
    __syncthreads();
    // stage s is read: load the tile kStages ahead into it
    if (tid == 0 && n + kStages * step < n_tiles) issue(n + kStages * step, s);

    // ---- the matrixing: P[r][m] for rows 4rq..4rq+3, m = 4mq..4mq+3
    const int mq = tid & 7, rq = tid >> 3;
    const bool mat = rq < kQuads && 4 * rq < R;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    if (mat && !(MP3TPU_SY_SKIP & 2)) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(buf + k * kStride + 4 * rq);
        const float4 w = *reinterpret_cast<const float4*>(nm + k * 32 + 4 * mq);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ws[4] = {w.x, w.y, w.z, w.w};
        // the sum's order: k ascending, one fused multiply-add a step
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = __fmaf_rn(ws[b], xs[a], acc[a][b]);
      }
    }
    __syncthreads();  // every read of seq is done: P goes over it
    if (mat) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        *reinterpret_cast<float4*>(buf + (4 * mq + b) * kStride + 4 * rq) =
            make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
    }
    __syncthreads();

    // ---- the window: own rows o0..o0+11 of output subband j; own row o is
    // buf row o + 16 and meets V of buf row o + 16 - d
    const int o0 = warp * kPer;
    if (o0 < 18 * ng) {
      float out[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) out[q] = 0.f;
      if (!(MP3TPU_SY_SKIP & 4)) {
        float ve[4 * kLoad], vo[4 * kLoad];  // buf rows o0 .. o0+27
#pragma unroll
        for (int q = 0; q < kLoad; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(buf + ce * kStride + o0 + 4 * q);
          const float4 b = *reinterpret_cast<const float4*>(buf + co * kStride + o0 + 4 * q);
          ve[4 * q] = a.x; ve[4 * q + 1] = a.y; ve[4 * q + 2] = a.z; ve[4 * q + 3] = a.w;
          vo[4 * q] = b.x; vo[4 * q + 1] = b.y; vo[4 * q + 2] = b.z; vo[4 * q + 3] = b.w;
        }
        // the sum's order: d ascending, one fused multiply-add a step
#pragma unroll
        for (int d = 0; d < 16; ++d) {
#pragma unroll
          for (int q = 0; q < kPer; ++q)
            out[q] = __fmaf_rn(taps[d], (d & 1) ? vo[q + 16 - d] : ve[q + 16 - d], out[q]);
        }
      }
      float* dst = pcm + ((long long)row * T + t0 + o0) * 32 + j;
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        if (o0 + q < 18 * ng) dst[q * 32] = out[q];
    }
  }
}

// The blocks of the persistent grid that fit one SM; also lifts the
// kernel's limit on dynamic shared memory.
int blocks_per_sm(int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, synth_kernel, kThreads,
                                                    kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

}  // namespace

// z [S, G, 2, 32, 36], overlap [S, 2, 32, 18], hist [S, 2, 15, 32] (these
// three 16-byte aligned: TMA reads them), inv_mask [32, 18], matrix [32, 32] (the distinct rows 0-15
// and 33-48 of N), window [512] -> pcm [S, 2, G*18*32], new_hist
// [S, 2, 15, 32]; all float32, contiguous, on the current device. Returns the
// cudaError_t of the launch (0: launched).
extern "C" int mp3tpu_synth(const void* z, const void* overlap, const void* hist,
                            const void* inv_mask, const void* matrix, const void* window,
                            void* pcm, void* new_hist, int S, int G, void* stream) {
  if (S <= 0 || G <= 0) return (int)cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(overlap) |
       reinterpret_cast<uintptr_t>(hist)) & 15)
    return (int)cudaErrorMisalignedAddress;
  // blocks of the persistent grid, per device: the SM count times the
  // blocks that fit one SM
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
  const int tiles_per_row = (G + kGran - 1) / kGran;
  const long long n_tiles = (long long)S * 2 * tiles_per_row;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < grid_of[dev] ? n_tiles : grid_of[dev]);
  synth_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)overlap, (const float*)hist,
      (const float*)inv_mask, (const float*)matrix, (const float*)window, (float*)pcm,
      (float*)new_hist, G, tiles_per_row, (int)n_tiles);
  return (int)cudaGetLastError();
}

// The kernel's launch shape: blocks per SM on the current device (occupancy
// query), threads a block, dynamic shared memory a block in bytes.
extern "C" int mp3tpu_synth_config(int* per_sm, int* threads, int* smem_bytes) {
  *threads = kThreads;
  *smem_bytes = kSmemBytes;
  return blocks_per_sm(per_sm);
}

extern "C" const char* mp3tpu_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
