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
// alias-reduced spectrum nat [pairs, 2, 576] instead of z. The TPU kernel
// does C3-C4 as one [576, 576] matmul per flavor; here they are the index
// map and the one-partner butterflies of the C1-C5 kernel.
//
// One thread block per granule pair (both channels, since the stereo stage
// couples them), one thread per spectral line:
//   C1  requantize: sign(is) * |is|^(4/3) * 2^(exp[band]/4), the band taken
//       from the line's flavor (long, short, mixed); cbrtf plus one Newton
//       step, as the XLA path's _pow43;
//   C2  stereo: the 2x2 palette matrix of the band, on channel 0's geometry;
//   C3  reorder through the flavor's map (in shared memory);
//   C4  alias butterflies over the flavor's boundary count, 8 pairs each;
//       every line has at most one partner;
//   C5  per-subband IMDCT 18 -> 36 with the windowed matrix of the subband's
//       block type (mixed blocks: block type 0 for subbands 0-1).
// z [pairs, 2, 32, 36] float32 is written once, coalesced.
//
// What bounds it on the card: per granule-channel about 2.6 KB of symbols in
// (int32 spectrum and exponents, as the plane decode leaves them) and 4.6 KB
// of z out, against about 21 k multiply-adds (1152 outputs x 18 taps): some
// 3 multiply-adds per byte, below the H100's float32 ridge (about 10 per
// byte: 67 TFLOP/s over 3.35 TB/s), so memory-bound. The
// design reads the symbols once and writes z once; nothing between C1 and C5
// goes to device memory. The tables (maps, palette, coefficients) stay in
// L1/L2, and the 10 KB of IMDCT matrices are staged in shared memory.
// The C1-C4 variant reads the same 2.6 KB and writes 2.3 KB of nat per
// granule-channel, with no IMDCT: memory-bound too.
//
// Fixed launch configuration, no atomics: equal inputs give bit-identical z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLines = 576;   // spectral lines per granule-channel
constexpr int kBands = 64;    // band slots per granule-channel
constexpr int kTaps = 18;     // lines per subband
constexpr int kOut = 36;      // IMDCT outputs per subband
constexpr int kZ = 32 * kOut; // z values per granule-channel

template <bool kStopAfterC4>
__global__ void __launch_bounds__(kLines)
fused_z_kernel(const int32_t* __restrict__ is_, const int32_t* __restrict__ exp_,
               const int32_t* __restrict__ block_type,
               const uint8_t* __restrict__ mixed, const uint8_t* __restrict__ smode,
               const int32_t* __restrict__ band_map,
               const int32_t* __restrict__ reorder_map,
               const int32_t* __restrict__ n_alias,
               const float* __restrict__ palette4, int n_palette,
               const float* __restrict__ alias_cs, const float* __restrict__ alias_ca,
               const float* __restrict__ imdct_blocks, float* __restrict__ out,
               int64_t n_pairs) {
  // out: z [pairs, 2, 32, 36], or nat [pairs, 2, 576] when kStopAfterC4
  __shared__ float blocks[kStopAfterC4 ? 1 : 4 * kTaps * kOut];
  __shared__ float xs[2][kLines];
  __shared__ float vs[2][kLines];

  const int64_t n = blockIdx.x;
  if (n >= n_pairs) return;  // the whole block leaves together
  const int i = threadIdx.x;
  if constexpr (!kStopAfterC4) {
    for (int k = i; k < 4 * kTaps * kOut; k += kLines) blocks[k] = imdct_blocks[k];
  }

  int bt[2], fl[2];
  for (int c = 0; c < 2; ++c) {
    bt[c] = block_type[n * 2 + c] & 3;
    fl[c] = bt[c] == 2 ? (mixed[n * 2 + c] ? 2 : 1) : 0;
  }

  // ---- C1 requantize
  float x[2];
  for (int c = 0; c < 2; ++c) {
    const int64_t row = n * 2 + c;
    const int q = is_[row * kLines + i];
    const float a = fabsf((float)q);
    float y = cbrtf(a);
    const float y2 = y * y;
    y = a > 0.f ? y - (y2 * y - a) / (3.f * y2 + 1e-30f) : 0.f;
    const float sgn = q > 0 ? 1.f : (q < 0 ? -1.f : 0.f);
    const int e = exp_[row * kBands + band_map[fl[c] * kLines + i]];
    x[c] = (sgn * (a * y)) * exp2f(0.25f * (float)e);
  }

  // ---- C2 stereo: palette row of the band, channel 0's band geometry
  const int p = smode[n * kBands + band_map[fl[0] * kLines + i]];
  float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f;
  if (p < n_palette) {
    m0 = palette4[p * 4 + 0];
    m1 = palette4[p * 4 + 1];
    m2 = palette4[p * 4 + 2];
    m3 = palette4[p * 4 + 3];
  }
  xs[0][i] = m0 * x[0] + m1 * x[1];
  xs[1][i] = m2 * x[0] + m3 * x[1];
  __syncthreads();

  // ---- C3 reorder: natural line i <- transmitted line reorder_map[fl][i]
  for (int c = 0; c < 2; ++c) vs[c][i] = xs[c][reorder_map[fl[c] * kLines + i]];
  __syncthreads();

  // ---- C4 alias butterflies across subband boundaries b < n_alias[fl]:
  // lines 17-k of subband b (lo) and k of subband b+1 (hi), k < 8
  const int sb = i / kTaps, k = i % kTaps;
  float w[2];
  for (int c = 0; c < 2; ++c) {
    const int nb = n_alias[fl[c]];
    float v = vs[c][i];
    if (k < 8 && sb >= 1 && sb - 1 < nb) {
      v = v * alias_cs[k] + vs[c][i - 1 - 2 * k] * alias_ca[k];
    } else if (k >= 10 && sb < nb) {
      const int j = kTaps - 1 - k;
      v = v * alias_cs[j] - vs[c][i + 1 + 2 * j] * alias_ca[j];
    }
    w[c] = v;
  }
  if constexpr (kStopAfterC4) {
    for (int c = 0; c < 2; ++c) out[(n * 2 + c) * kLines + i] = w[c];
  } else {
    for (int c = 0; c < 2; ++c) xs[c][i] = w[c];
    __syncthreads();

    // ---- C5 IMDCT + window: output o = subband * 36 + j, 4 per thread
    for (int c = 0; c < 2; ++c) {
      float* zc = out + (n * 2 + c) * kZ;
      for (int h = 0; h < 2; ++h) {
        const int o = i + h * kLines;
        const int so = o / kOut, j = o % kOut;
        const int b = (fl[c] == 2 && so < 2) ? 0 : bt[c];
        const float* m = blocks + b * kTaps * kOut + j;
        const float* v = xs[c] + so * kTaps;
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) acc += v[t] * m[t * kOut];
        zc[o] = acc;
      }
    }
  }
}

template <bool kStopAfterC4>
int launch(const void* is_, const void* exp_, const void* block_type, const void* mixed,
           const void* smode, const void* band_map, const void* reorder_map,
           const void* n_alias, const void* palette4, int n_palette, const void* alias_cs,
           const void* alias_ca, const void* imdct_blocks, void* out, int64_t n_pairs,
           void* stream) {
  if (n_pairs <= 0) return 0;
  fused_z_kernel<kStopAfterC4><<<(unsigned)n_pairs, kLines, 0, (cudaStream_t)stream>>>(
      (const int32_t*)is_, (const int32_t*)exp_, (const int32_t*)block_type,
      (const uint8_t*)mixed, (const uint8_t*)smode, (const int32_t*)band_map,
      (const int32_t*)reorder_map, (const int32_t*)n_alias, (const float*)palette4,
      n_palette, (const float*)alias_cs, (const float*)alias_ca,
      (const float*)imdct_blocks, (float*)out, n_pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// C1-C5: z [n_pairs, 2, 32, 36]
extern "C" int mp3tpu_fused_z(const void* is_, const void* exp_, const void* block_type,
                              const void* mixed, const void* smode,
                              const void* band_map, const void* reorder_map,
                              const void* n_alias, const void* palette4, int n_palette,
                              const void* alias_cs, const void* alias_ca,
                              const void* imdct_blocks, void* z, int64_t n_pairs,
                              void* stream) {
  return launch<false>(is_, exp_, block_type, mixed, smode, band_map, reorder_map,
                       n_alias, palette4, n_palette, alias_cs, alias_ca, imdct_blocks,
                       z, n_pairs, stream);
}

// C1-C4: nat [n_pairs, 2, 576]
extern "C" int mp3tpu_fused_frontend(const void* is_, const void* exp_,
                                     const void* block_type, const void* mixed,
                                     const void* smode, const void* band_map,
                                     const void* reorder_map, const void* n_alias,
                                     const void* palette4, int n_palette,
                                     const void* alias_cs, const void* alias_ca,
                                     void* nat, int64_t n_pairs, void* stream) {
  return launch<true>(is_, exp_, block_type, mixed, smode, band_map, reorder_map,
                      n_alias, palette4, n_palette, alias_cs, alias_ca, nullptr, nat,
                      n_pairs, stream);
}

extern "C" const char* mp3tpu_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
