// C1-C5 of the MP3 Layer III granule chain, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mp3tpu/kernels/pallas_fused.py:_kernel_z (launched
// by _fused_z_call, wrapped by fused_pipeline_z). It computes the same
// function, not the same blocks: the TPU kernel multiplies by composed
// [576, 1152] reorder+alias+IMDCT matrices to keep its matrix unit busy;
// here each stage is done directly.
//
// The same kernel, instantiated with kStopAfterC4, replaces the TPU kernel
// mp3tpu/kernels/pallas_fused.py:_kernel (launched by _fused_call, wrapped
// by fused_frontend): it stops after C4 and writes the natural-order,
// alias-reduced spectrum nat [pairs, 2, 576] instead of z.
//
// Per granule pair (both channels, since the stereo stage couples them):
//   C1  requantize: sign(is) * |is|^(4/3) * 2^(exp[band]/4), the band taken
//       from the line's flavor (long, short, mixed); |is|^(4/3) is cbrtf
//       plus one Newton step (a table of it for |is| < 64, filled with the
//       same arithmetic), 2^(exp/4) is exp2f once per band;
//   C2  stereo: the 2x2 palette matrix of the band, on channel 0's geometry;
//   C3  reorder through the flavor's map;
//   C4  alias butterflies over the flavor's boundary count, 8 pairs each;
//       every line has at most one partner;
//   C5  per-subband IMDCT 18 -> 36 and window, by the subband's block type
//       (mixed blocks: block type 0 for subbands 0-1). Long blocks: the 18
//       distinct sums of the 36-point IMDCT (out[17-i] = -out[i],
//       out[53-i] = out[i]), times the window, as the plain version's
//       (v @ imdct_long) * window; short blocks: three windowed 12-point
//       IMDCTs, overlapped.
//
// What bounds it on the card: per pair 5,188 bytes of symbols in (int32
// spectrum and exponents, int8 block types, as the plane decode gives them)
// and 9,216 bytes of z out (4,608 of nat), against about 45 k float32
// operations: memory-bound (the float32 ridge is about 20 operations per
// byte). The design is built around that:
//   - a persistent grid (SMs x the blocks that fit: 6 of 35 KB for z, 8 for
//     nat) whose blocks walk over the pairs; each block stages the tables
//     once (band and reorder maps narrowed to 8 and 16 bits, the
//     |is|^(4/3) table, the alias coefficients);
//   - each pair's spectrum, exponents and stereo modes (contiguous rows)
//     arrive in a ring of two shared-memory stages by TMA bulk copies on an
//     mbarrier, issued by one thread two pairs ahead, so the next pairs'
//     loads are in flight while this one computes; the flag bytes of both
//     channels are loaded one pair ahead into registers;
//   - C1-C4 run over all 6 warps with fixed trip counts (3 and 6 items a
//     thread, unrolled, so their shared-memory gathers overlap); C5 runs on
//     4 warps, lane = subband, warp = (channel, half of the 36 outputs), so
//     each lane does 9 of the 18 distinct sums (162 multiply-adds);
//   - the IMDCT coefficients are a kernel parameter (__grid_constant__)
//     read as constant-bank operands, kept to 2,160 bytes: the four
//     windowed [18, 36] matrices (10 KB) thrash the constant cache when
//     block types mix, and z then takes 5x longer;
//   - z is staged in shared memory and leaves by one TMA bulk store per
//     pair, 16-byte shared stores without bank conflicts before it;
//   - the spectrum and exponents are read as given (both int16, both int32,
//     or int32 spectrum with int16 exponents), the block type as int8 or
//     int32, mixed as bool/uint8: nothing is cast before the launch;
//   - float32 on the CUDA cores, no tensor cores: TF32 would not hold the
//     1e-5 tolerance.
//
// Each output's arithmetic is fixed: every product, sum and multiply-add is
// an explicitly rounded intrinsic (no contraction left to the compiler), the
// sums run in tap order, there are no atomics, and nothing depends on the
// grid, on which block takes a pair or on the input types. A pair gives the
// same bits at any S, in any launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "cuda_tma.h"  // mbarrier, TMA bulk copies, proxy fence

namespace {

constexpr int kLines = 576;    // spectral lines per granule-channel
constexpr int kBands = 64;     // band slots per granule-channel
constexpr int kTaps = 18;      // lines per subband
constexpr int kOut = 36;       // IMDCT outputs per subband
constexpr int kZ = 32 * kOut;  // z values per granule-channel
constexpr int kThreads = 192;  // 6 warps; 4 of them run the IMDCT
// Measurement variants (chip_smoke.py --variants builds them with -D):
// the input ring's depth, a cap on the blocks per SM (0: all that fit), and
// C5's arithmetic left out (z is then wrong; only its time is read).
#ifndef MP3TPU_FZ_STAGES
#define MP3TPU_FZ_STAGES 2
#endif
#ifndef MP3TPU_FZ_BLOCKS_PER_SM
#define MP3TPU_FZ_BLOCKS_PER_SM 0
#endif
#ifndef MP3TPU_FZ_NO_C5
#define MP3TPU_FZ_NO_C5 0
#endif
constexpr int kStages = MP3TPU_FZ_STAGES;  // input ring depth
constexpr int kPowTab = 64;    // |is| below this: table of |is|^(4/3)
constexpr int kWStride = 19;   // padded subband stride of the IMDCT input
constexpr int kMaxDevices = 64;

// The IMDCT coefficients, a kernel parameter: each is read as a
// constant-bank operand. 2,160 bytes, small enough to stay in the constant
// cache while every block of the SM reads it.
struct ImdctCoefs {
  // the 18 distinct sums of the 36-point IMDCT: columns 0-8 and 18-26 of
  // the unwindowed [18, 36] matrix; out[17-i] = -out[i] for i < 9 and
  // out[53-i] = out[i] for 18 <= i < 27
  float lng[kTaps][18];
  // one short window's windowed 12-point IMDCT (6 lines in, 12 out)
  float shrt[6][12];
  // the long windows by block type (row 2 unused)
  float win[4][kOut];
};
struct NoCoefs {};

struct Tables {
  const int32_t* band_map;     // [3, 576]
  const int32_t* reorder_map;  // [3, 576]
  const int32_t* n_alias;      // [3]
  const float* palette4;       // [n_palette, 4]
  const float* alias_cs;       // [8]
  const float* alias_ca;       // [8]
  int n_palette;
};

// Shared-memory layout of one block; every offset is a multiple of 16.
template <typename TI, typename TE, bool kStopAfterC4>
struct Layout {
  static constexpr int kIsBytes = 2 * kLines * (int)sizeof(TI);
  static constexpr int kExpBytes = 2 * kBands * (int)sizeof(TE);
  static constexpr int kStageBytes = kIsBytes + kExpBytes + kBands;
  static constexpr int kOutFloats = kStopAfterC4 ? 2 * kLines : 2 * kZ;
  static constexpr int kStage = 0;
  static constexpr int kOutBuf = kStage + kStages * kStageBytes;
  static constexpr int kXs = kOutBuf + kOutFloats * 4;
  static constexpr int kW = kXs + 2 * kLines * 4;
  static constexpr int kScale = kW + (kStopAfterC4 ? 0 : 2 * 32 * kWStride * 4);
  static constexpr int kPb = kScale + 2 * kBands * 4;
  static constexpr int kPow = kPb + kBands * 16;
  static constexpr int kBmap = kPow + kPowTab * 4;
  static constexpr int kRmap = kBmap + 3 * kLines;
  static constexpr int kAlias = kRmap + 3 * kLines * 2;
  static constexpr int kBar = kAlias + 16 * 4;
  static constexpr int kBytes = kBar + 16 * ((kStages + 1) / 2);  // kStages mbarriers
  static_assert(kStageBytes % 16 == 0 && kIsBytes % 16 == 0 &&
                kExpBytes % 16 == 0 && kOutBuf % 16 == 0 && kBmap % 16 == 0 &&
                kRmap % 16 == 0 && kBar % 16 == 0,
                "TMA, float4 and mbarrier offsets must be multiples of 16");
};

// ---- arithmetic, every operation rounded on its own

// |q|^(4/3) = a * cbrt(a): cbrtf refined by one Newton step (the XLA path's
// _pow43)
__device__ __forceinline__ float pow43(float a) {
  float y = cbrtf(a);
  const float y2 = __fmul_rn(y, y);
  const float num = __fmaf_rn(y2, y, -a);
  const float den = __fmaf_rn(3.f, y2, 1e-30f);
  y = a > 0.f ? __fsub_rn(y, __fdiv_rn(num, den)) : 0.f;
  return __fmul_rn(a, y);
}

// sign(q) * |q|^(4/3)
template <typename T>
__device__ __forceinline__ float signed_pow43(T q, const float* ptab) {
  const int qi = (int)q;
  const uint32_t a = qi < 0 ? 0u - (uint32_t)qi : (uint32_t)qi;
  const float p = a < (uint32_t)kPowTab ? ptab[a] : pow43((float)a);
  return qi > 0 ? p : (qi < 0 ? -p : 0.f);
}

__device__ __forceinline__ void store2(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}
__device__ __forceinline__ void store4(float* d, float a, float b, float c, float e) {
  *reinterpret_cast<float4*>(d) = make_float4(a, b, c, e);
}

// Long block (types 0, 1, 3): z[18H + m], m < 18, of one subband: 9 of the
// 18 distinct IMDCT sums in tap order, unfolded by the IMDCT's symmetry,
// times the window of block type b. dst is z + 18H (8-byte aligned).
template <int H>
__device__ __forceinline__ void long_half(const float* src, const ImdctCoefs& C, int b,
                                          float* dst) {
  float v[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) v[t] = src[t];
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = __fmul_rn(v[0], C.lng[0][9 * H + i]);
#pragma unroll
  for (int t = 1; t < kTaps; ++t) {
#pragma unroll
    for (int i = 0; i < 9; ++i) acc[i] = __fmaf_rn(v[t], C.lng[t][9 * H + i], acc[i]);
  }
  float z[18];
#pragma unroll
  for (int m = 0; m < 18; ++m) {
    // H = 0: out[m] = acc[m], out[17-m'] = -acc[m']; H = 1: out[35-m'] = acc[m']
    const float y = m < 9 ? acc[m] : (H == 0 ? -acc[17 - m] : acc[17 - m]);
    z[m] = __fmul_rn(y, C.win[b][18 * H + m]);
  }
  if (H == 0) {
#pragma unroll
    for (int m = 0; m < 16; m += 4) store4(dst + m, z[m], z[m + 1], z[m + 2], z[m + 3]);
    store2(dst + 16, z[16], z[17]);
  } else {
    store2(dst, z[0], z[1]);
#pragma unroll
    for (int m = 2; m < 18; m += 4) store4(dst + m, z[m], z[m + 1], z[m + 2], z[m + 3]);
  }
}

// o[i] = sum over 6 lines of window w's windowed 12-point IMDCT, for the
// outputs i in [I0, I0 + N)
template <int I0, int N>
__device__ __forceinline__ void short_sums(const float* v6, const ImdctCoefs& C,
                                           float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = __fmul_rn(v6[0], C.shrt[0][I0 + i]);
#pragma unroll
  for (int k = 1; k < 6; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __fmaf_rn(v6[k], C.shrt[k][I0 + i], o[i]);
  }
}

// Short block: z[18H + m], m < 18, of one subband: its three windows'
// 12-point IMDCTs at offsets 6, 12 and 18, overlapped (z[0:6] and z[30:36]
// are 0). dst is z + 18H.
template <int H>
__device__ __forceinline__ void short_half(const float* src, const ImdctCoefs& C,
                                           float* dst) {
  float v[12];
#pragma unroll
  for (int t = 0; t < 12; ++t) v[t] = src[6 * H + t];  // windows H and H+1
  float z[18];
  if (H == 0) {
    float o0[12], o1[6];
    short_sums<0, 12>(v, C, o0);
    short_sums<0, 6>(v + 6, C, o1);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      z[m] = 0.f;
      z[6 + m] = o0[m];
      z[12 + m] = __fadd_rn(o0[6 + m], o1[m]);
    }
  } else {
    float o1[6], o2[12];
    short_sums<6, 6>(v, C, o1);
    short_sums<0, 12>(v + 6, C, o2);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      z[m] = __fadd_rn(o1[m], o2[m]);
      z[6 + m] = o2[6 + m];
      z[12 + m] = 0.f;
    }
  }
  if (H == 0) {
#pragma unroll
    for (int m = 0; m < 16; m += 4) store4(dst + m, z[m], z[m + 1], z[m + 2], z[m + 3]);
    store2(dst + 16, z[16], z[17]);
  } else {
    store2(dst, z[0], z[1]);
#pragma unroll
    for (int m = 2; m < 18; m += 4) store4(dst + m, z[m], z[m + 1], z[m + 2], z[m + 3]);
  }
}

template <typename TI, typename TE, bool kStopAfterC4>
__global__ void __launch_bounds__(kThreads, kStopAfterC4 ? 8 : 6)
fused_z_kernel(const TI* __restrict__ is_, const TE* __restrict__ exp_,
               const void* __restrict__ block_type, int bt_bytes,
               const uint8_t* __restrict__ mixed, const uint8_t* __restrict__ smode,
               const Tables tab, float* __restrict__ out, int64_t n_pairs,
               const __grid_constant__ std::conditional_t<kStopAfterC4, NoCoefs, ImdctCoefs>
                   coefs) {
  // out: z [pairs, 2, 32, 36], or nat [pairs, 2, 576] when kStopAfterC4
  using L = Layout<TI, TE, kStopAfterC4>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ob = reinterpret_cast<float*>(smem + L::kOutBuf);      // z or nat of a pair
  float* xs = reinterpret_cast<float*>(smem + L::kXs);          // [2][576]
  float* wv = reinterpret_cast<float*>(smem + L::kW);           // [2][32][19]
  float* scale = reinterpret_cast<float*>(smem + L::kScale);    // [2][64]
  float4* pb = reinterpret_cast<float4*>(smem + L::kPb);        // [64]
  float* ptab = reinterpret_cast<float*>(smem + L::kPow);       // [kPowTab]
  uint8_t* bmap = smem + L::kBmap;                              // [3][576]
  uint16_t* rmap = reinterpret_cast<uint16_t*>(smem + L::kRmap);  // [3][576]
  float* cs = reinterpret_cast<float*>(smem + L::kAlias);       // [8]
  float* ca = cs + 8;                                           // [8]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar); // [kStages]

  const int tid = threadIdx.x;
  const int64_t step = gridDim.x;
  const int n_pal = tab.n_palette;

  // one pair's rows -> stage s, completing on full[s]
  auto issue = [&](int64_t n, int s) {
    unsigned char* st = smem + L::kStage + s * L::kStageBytes;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, L::kStageBytes);
    bulk_load(smem_u32(st), is_ + n * 2 * kLines, L::kIsBytes, bar);
    bulk_load(smem_u32(st + L::kIsBytes), exp_ + n * 2 * kBands, L::kExpBytes, bar);
    bulk_load(smem_u32(st + L::kIsBytes + L::kExpBytes), smode + n * kBands, kBands, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      const int64_t n = blockIdx.x + s * step;
      if (n < n_pairs) issue(n, s);
    }
  }

  // the tables, once per block, while the first pairs load
  for (int i = tid; i < 3 * kLines; i += kThreads) {
    bmap[i] = (uint8_t)tab.band_map[i];
    rmap[i] = (uint16_t)tab.reorder_map[i];
  }
  if (tid < kPowTab) ptab[tid] = pow43((float)tid);
  if (tid < 8) {
    cs[tid] = tab.alias_cs[tid];
    ca[tid] = tab.alias_ca[tid];
  }
  const int na0 = tab.n_alias[0], na1 = tab.n_alias[1], na2 = tab.n_alias[2];
  const float4* pal = reinterpret_cast<const float4*>(tab.palette4);

  // block type and mixed flag of both channels, one pair ahead
  auto load_flags = [&](int64_t n, int (&f)[4]) {
    if (bt_bytes == 1) {
      const int8_t* b = static_cast<const int8_t*>(block_type) + 2 * n;
      f[0] = __ldg(b);
      f[1] = __ldg(b + 1);
    } else {
      const int32_t* b = static_cast<const int32_t*>(block_type) + 2 * n;
      f[0] = __ldg(b);
      f[1] = __ldg(b + 1);
    }
    f[2] = __ldg(mixed + 2 * n);
    f[3] = __ldg(mixed + 2 * n + 1);
  };
  int next[4] = {0, 0, 0, 0};
  if ((int64_t)blockIdx.x < n_pairs) load_flags(blockIdx.x, next);
  __syncthreads();

  int k = 0;
  for (int64_t n = blockIdx.x; n < n_pairs; n += step, ++k) {
    const int s = k % kStages;
    int cur[4] = {next[0], next[1], next[2], next[3]};
    if (n + step < n_pairs) load_flags(n + step, next);
    const int bt0 = cur[0] & 3, bt1 = cur[1] & 3;
    const int fl0 = bt0 == 2 ? (cur[2] ? 2 : 1) : 0;
    const int fl1 = bt1 == 2 ? (cur[3] ? 2 : 1) : 0;

    mbar_wait(smem_u32(&full[s]), (uint32_t)(k / kStages) & 1u);
    const unsigned char* st = smem + L::kStage + s * L::kStageBytes;
    const TI* isv = reinterpret_cast<const TI*>(st);
    const TE* ev = reinterpret_cast<const TE*>(st + L::kIsBytes);
    const uint8_t* sm = st + L::kIsBytes + L::kExpBytes;

    // per band: 2^(exp/4) of each channel, the palette row (channel 0's bands)
    if (tid < 2 * kBands) {
      scale[tid] = exp2f(__fmul_rn(0.25f, (float)ev[tid]));
    } else {
      const int b = tid - 2 * kBands;
      const int p = sm[b];
      pb[b] = p < n_pal ? __ldg(pal + p) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    // ---- C1 requantize + C2 stereo, transmitted order
    {
      const uint8_t* bm0 = bmap + fl0 * kLines;
      const uint8_t* bm1 = bmap + fl1 * kLines;
#pragma unroll
      for (int r = 0; r < kLines / kThreads; ++r) {
        const int i = tid + r * kThreads;
        const int b0 = bm0[i], b1 = bm1[i];
        const float x0 = __fmul_rn(signed_pow43(isv[i], ptab), scale[b0]);
        const float x1 = __fmul_rn(signed_pow43(isv[kLines + i], ptab), scale[kBands + b1]);
        const float4 m = pb[b0];
        xs[i] = __fmaf_rn(m.x, x0, __fmul_rn(m.y, x1));
        xs[kLines + i] = __fmaf_rn(m.z, x0, __fmul_rn(m.w, x1));
      }
    }
    // nat is written next: the store of the previous pair must have read it
    if (kStopAfterC4 && tid == 0) bulk_wait_read();
    __syncthreads();
    // stage s is consumed: load the pair kStages ahead into it
    if (tid == 0 && n + kStages * step < n_pairs) issue(n + kStages * step, s);

    // ---- C3 reorder + C4 alias butterflies, natural order
#pragma unroll
    for (int r = 0; r < 2 * kLines / kThreads; ++r) {
      const int t = tid + r * kThreads;
      const int c = t >= kLines;
      const int i = t - c * kLines;
      const int fl = c ? fl1 : fl0;
      const int nb = fl == 0 ? na0 : (fl == 1 ? na1 : na2);
      const uint16_t* rm = rmap + fl * kLines;
      const float* x = xs + c * kLines;
      const int sb = i / kTaps, kk = i - kTaps * sb;
      float v = x[rm[i]];
      if (kk < 8 && sb >= 1 && sb - 1 < nb) {
        v = __fmaf_rn(x[rm[i - 1 - 2 * kk]], ca[kk], __fmul_rn(v, cs[kk]));
      } else if (kk >= 10 && sb < nb) {
        const int j = kTaps - 1 - kk;
        v = __fmaf_rn(-x[rm[i + 1 + 2 * j]], ca[j], __fmul_rn(v, cs[j]));
      }
      if constexpr (kStopAfterC4) {
        ob[t] = v;
      } else {
        wv[(c * 32 + sb) * kWStride + kk] = v;
      }
    }

    if constexpr (!kStopAfterC4) {
      // z is written next: the store of the previous pair must have read it
      if (tid == 0) bulk_wait_read();
      __syncthreads();
      // ---- C5 IMDCT + window: warps 0-3, (channel, half of the 36
      // outputs); lane = subband
      const int warp = tid >> 5, lane = tid & 31;
      if (warp < 4 && !MP3TPU_FZ_NO_C5) {
        const int c = warp >> 1, h = warp & 1;
        const int bt = c ? bt1 : bt0;
        const int b = ((c ? fl1 : fl0) == 2 && lane < 2) ? 0 : bt;
        const float* src = wv + (c * 32 + lane) * kWStride;
        float* dst = ob + c * kZ + lane * kOut + 18 * h;
        if (b != 2) {
          if (h == 0) long_half<0>(src, coefs, b, dst);
          else long_half<1>(src, coefs, b, dst);
        } else {
          if (h == 0) short_half<0>(src, coefs, dst);
          else short_half<1>(src, coefs, dst);
        }
      }
    }

    // the output rows leave by one bulk store
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) bulk_store(out + n * L::kOutFloats, smem_u32(ob), L::kOutFloats * 4);
  }
  if (tid == 0) bulk_wait_read();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The blocks of one instantiation that fit an SM (at most
// MP3TPU_FZ_BLOCKS_PER_SM where that is set); also lifts its limit on
// dynamic shared memory.
template <typename TI, typename TE, bool kStopAfterC4>
int blocks_per_sm(int* per_sm) {
  constexpr int smem = Layout<TI, TE, kStopAfterC4>::kBytes;
  auto kernel = fused_z_kernel<TI, TE, kStopAfterC4>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (MP3TPU_FZ_BLOCKS_PER_SM > 0 && *per_sm > MP3TPU_FZ_BLOCKS_PER_SM)
    *per_sm = MP3TPU_FZ_BLOCKS_PER_SM;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <typename TI, typename TE, bool kStopAfterC4>
int launch_typed(const void* is_, const void* exp_, const void* block_type, int bt_bytes,
                 const void* mixed, const void* smode, const Tables& tab,
                 const float* coefs_host, void* out, int64_t n_pairs, cudaStream_t stream) {
  using L = Layout<TI, TE, kStopAfterC4>;
  auto kernel = fused_z_kernel<TI, TE, kStopAfterC4>;
  constexpr int smem = L::kBytes;
  // blocks of the persistent grid, per device: the SM count times the
  // blocks that fit one SM
  static int grid_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (grid_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int rc = blocks_per_sm<TI, TE, kStopAfterC4>(&per_sm);
    if (rc != 0) return rc;
    grid_of[dev] = sms * per_sm;
  }
  const int64_t grid = n_pairs < grid_of[dev] ? n_pairs : grid_of[dev];
  std::conditional_t<kStopAfterC4, NoCoefs, ImdctCoefs> coefs;
  if constexpr (!kStopAfterC4) memcpy(&coefs, coefs_host, sizeof(ImdctCoefs));
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const TI*>(is_), static_cast<const TE*>(exp_), block_type, bt_bytes,
      static_cast<const uint8_t*>(mixed), static_cast<const uint8_t*>(smode), tab,
      static_cast<float*>(out), n_pairs, coefs);
  return (int)cudaGetLastError();
}

template <bool kStopAfterC4>
int launch(const void* is_, int is_bytes, const void* exp_, int exp_bytes,
           const void* block_type, int bt_bytes, const void* mixed, const void* smode,
           const Tables& tab, const float* coefs_host, void* out, int64_t n_pairs,
           void* stream) {
  if (n_pairs <= 0) return 0;
  if (!aligned16(is_) || !aligned16(exp_) || !aligned16(smode) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  if ((bt_bytes != 1 && bt_bytes != 4) || tab.n_palette < 0 || !aligned16(tab.palette4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MP3TPU_LAUNCH(TI, TE)                                                         \
  return launch_typed<TI, TE, kStopAfterC4>(is_, exp_, block_type, bt_bytes, mixed, \
                                             smode, tab, coefs_host, out, n_pairs, s)
  // the callers' pairs: int16 symbols (the player, the scheduler, the
  // single-stream decode), int32 from the plane decode, and int32 spectrum
  // with int16 exponents where the plane decode's byte exponents overflow
  if (is_bytes == 2 && exp_bytes == 2) MP3TPU_LAUNCH(int16_t, int16_t);
  if (is_bytes == 4 && exp_bytes == 2) MP3TPU_LAUNCH(int32_t, int16_t);
  if (is_bytes == 4 && exp_bytes == 4) MP3TPU_LAUNCH(int32_t, int32_t);
#undef MP3TPU_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C1-C5: z [n_pairs, 2, 32, 36]. is_/exp_ hold is_bytes/exp_bytes-wide
// ints, block_type bt_bytes-wide ints; imdct_coefs is a host pointer to the
// 540 floats of ImdctCoefs.
extern "C" int mp3tpu_fused_z(const void* is_, int is_bytes, const void* exp_,
                              int exp_bytes, const void* block_type, int bt_bytes,
                              const void* mixed, const void* smode, const void* band_map,
                              const void* reorder_map, const void* n_alias,
                              const void* palette4, int n_palette, const void* alias_cs,
                              const void* alias_ca, const void* imdct_coefs, void* z,
                              int64_t n_pairs, void* stream) {
  const Tables tab{static_cast<const int32_t*>(band_map),
                   static_cast<const int32_t*>(reorder_map),
                   static_cast<const int32_t*>(n_alias), static_cast<const float*>(palette4),
                   static_cast<const float*>(alias_cs), static_cast<const float*>(alias_ca),
                   n_palette};
  return launch<false>(is_, is_bytes, exp_, exp_bytes, block_type, bt_bytes, mixed, smode,
                       tab, static_cast<const float*>(imdct_coefs), z, n_pairs, stream);
}

// C1-C4: nat [n_pairs, 2, 576]
extern "C" int mp3tpu_fused_frontend(const void* is_, int is_bytes, const void* exp_,
                                     int exp_bytes, const void* block_type, int bt_bytes,
                                     const void* mixed, const void* smode,
                                     const void* band_map, const void* reorder_map,
                                     const void* n_alias, const void* palette4,
                                     int n_palette, const void* alias_cs,
                                     const void* alias_ca, void* nat, int64_t n_pairs,
                                     void* stream) {
  const Tables tab{static_cast<const int32_t*>(band_map),
                   static_cast<const int32_t*>(reorder_map),
                   static_cast<const int32_t*>(n_alias), static_cast<const float*>(palette4),
                   static_cast<const float*>(alias_cs), static_cast<const float*>(alias_ca),
                   n_palette};
  return launch<true>(is_, is_bytes, exp_, exp_bytes, block_type, bt_bytes, mixed, smode,
                      tab, nullptr, nat, n_pairs, stream);
}

// The blocks of the persistent grid per SM, for int32 spectrum and
// exponents: of C1-C4 (stop_after_c4) or of C1-C5.
extern "C" int mp3tpu_fused_blocks_per_sm(int stop_after_c4, int* per_sm) {
  return stop_after_c4 ? blocks_per_sm<int32_t, int32_t, true>(per_sm)
                       : blocks_per_sm<int32_t, int32_t, false>(per_sm);
}

extern "C" const char* mp3tpu_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
