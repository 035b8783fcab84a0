// C6-C7 of the MP3 Layer III granule chain, for NVIDIA Hopper (sm_90a):
// overlap-add, frequency inversion and the 16-tap polyphase synthesis FIR.
//
// Not a port of a TPU kernel: in the JAX package C6-C7 is jnp code
// (mp3tpu/kernels/pipeline.py:_backend: the overlap-add, the inversion mask
// and the einsum "sctdk,dkj->sctj" over synth_fir [16, 32, 32]). The plain
// PyTorch version (kernels/synth.py:synth_backend_reference) unfolds the
// time axis into [S*2*T, 512] windows and hands one matmul to cuBLAS, which
// picks its tiles and its split of the 512-term sum by the call's shape, so
// a sample's bits changed with S, G and the place of its window. This
// kernel writes the order down.
//
// Per (stream s, channel c), with T = G*18 time steps of 32 subbands:
//   seq[t, k]  = (z[s, g, c, k, i] + tail) * inv_mask[k, i],  t = g*18 + i,
//                tail = z[s, g-1, c, k, 18+i], or overlap[s, c, k, i] at g = 0
//                (one __fadd_rn, then one __fmul_rn);
//   full       = hist[s, c] (15 rows) ++ seq (T rows);
//   pcm[t, j]  = sum over k = 0..31, w = 0..15 of
//                full[t + w, k] * synth_w[k*16 + w, j];
//   new_hist   = the last 15 rows of full (rows of seq: T >= 18).
// The new overlap, z[s, G-1, c, :, 18:], is a copy the wrapper makes.
//
// The order of each sum: ONE thread owns one output sample's whole sum. It
// starts from 0.0f and adds the 512 products in the order k = 0..31 (outer),
// w = 0..15 (inner), each step one __fmaf_rn(full, synth_w, acc): a fused
// multiply-add, rounded once. No atomicAdd, no split of a sum over threads or
// warps, no --use_fast_math. So a sample's bits depend on its own 512 inputs
// and on nothing else: not on S, G, the grid, the tile a step falls in, or
// where a window starts.
//
// What bounds it on the card: 512 multiply-adds a sample against 12 bytes
// moved (8 of z in, 4 of PCM out): about 85 operations a byte, four times the
// float32 ridge, so the CUDA cores' rate bounds it (no tensor cores: TF32
// would not hold the int16 contract). The design is built around feeding the
// multiply-adds from shared memory with few loads:
//   - synth_w (64 KB) is staged once per block; blocks are persistent
//     (SMs x 3) and walk over tiles of (s, c, 64 time steps);
//   - a tile's 79 rows of full are computed once into shared memory, stored
//     time-major per subband, so a thread reads the 23 values its 8 time
//     steps need for one k as six 16-byte broadcast loads;
//   - lane = j (32 output subbands), warp = 8 consecutive time steps: one
//     synth_w load (conflict-free, 32 consecutive floats a warp) feeds 8
//     multiply-adds, so a k costs 22 shared loads for 128 multiply-adds;
//   - PCM leaves channel-planar, [S, 2, T*32], 128 bytes a warp and store;
//     the wrapper hands out the [S, T*32, 2] view of it, as the plain
//     version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                  // time steps of one tile
constexpr int kThreads = 256;              // 8 warps
constexpr int kPer = kTile / (kThreads / 32);  // 8 time steps a thread
constexpr int kRows = kTile + 15;          // rows of full a tile reads
constexpr int kStride = 80;                // floats per subband row (16-byte multiple)
constexpr int kBlocksPerSm = 3;
constexpr int kWFloats = 512 * 32;
constexpr int kSmemBytes = (kWFloats + 32 * kStride) * 4;   // 75,776

static_assert(kPer == 8, "a thread's window is 8 + 15 rows, read as 6 float4");
static_assert(kTile - kPer + 24 <= kStride, "the last float4 stays in its row");

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
synth_kernel(const float* __restrict__ z, const float* __restrict__ overlap,
             const float* __restrict__ hist, const float* __restrict__ inv_mask,
             const float* __restrict__ synth_w, float* __restrict__ pcm,
             float* __restrict__ new_hist, int G, int tiles_per_row,
             long long n_tiles) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);   // [512][32]
  float* Fs = Ws + kWFloats;                     // [32][kStride]: full, time-major per k
  const int T = G * 18;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kPer;

  {
    const float4* src = reinterpret_cast<const float4*>(synth_w);
    for (int e = threadIdx.x; e < kWFloats / 4; e += kThreads) smem4[e] = src[e];
  }

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row = tile / tiles_per_row;  // s*2 + c
    const int t0 = (int)(tile - row * tiles_per_row) * kTile;
    const long long s = row >> 1;
    const int c = (int)(row & 1);

    __syncthreads();  // the last tile's reads of Fs are done (and Ws is staged)
    // full rows t0-15 .. t0+63 (seq index tt; tt < 0 is the carried hist)
    for (int e = threadIdx.x; e < 32 * kStride; e += kThreads) {
      const int k = e / kStride, l = e - k * kStride;
      const int tt = t0 - 15 + l;
      float v = 0.0f;
      if (l < kRows && tt < T) {
        if (tt < 0) {
          v = hist[(row * 15 + (15 + tt)) * 32 + k];
        } else {
          const int g = tt / 18, i = tt - g * 18;
          const float* zc = z + ((s * G + g) * 2 + c) * 1152 + k * 36;
          const float head = zc[i];
          const float tail = g == 0 ? overlap[(row * 32 + k) * 18 + i]
                                    : zc[i + 18 - 2 * 1152];
          v = __fmul_rn(__fadd_rn(head, tail), inv_mask[k * 18 + i]);
        }
      }
      Fs[k * kStride + l] = v;
    }
    __syncthreads();

    // the carried history: the last 15 rows of seq, from the tile that owns each
    for (int e = threadIdx.x; e < 15 * 32; e += kThreads) {
      const int h = e >> 5, k = e & 31;
      const int tt = T - 15 + h;
      if (tt >= t0 && tt < t0 + kTile)
        new_hist[(row * 15 + h) * 32 + k] = Fs[k * kStride + (tt - t0 + 15)];
    }

    if (t0 + r0 < T) {
      float acc[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) acc[r] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < 32; ++k) {
        float f[24];
        const float4* fp = reinterpret_cast<const float4*>(Fs + k * kStride + r0);
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const float4 v = fp[q];
          f[4 * q] = v.x; f[4 * q + 1] = v.y; f[4 * q + 2] = v.z; f[4 * q + 3] = v.w;
        }
        const float* wp = Ws + k * 16 * 32 + lane;
        // the sum's order: k outer, w inner, one fused multiply-add a step
#pragma unroll
        for (int w = 0; w < 16; ++w) {
          const float wv = wp[w * 32];
#pragma unroll
          for (int r = 0; r < kPer; ++r) acc[r] = __fmaf_rn(f[r + w], wv, acc[r]);
        }
      }
      float* out = pcm + (row * T + t0 + r0) * 32 + lane;
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        if (t0 + r0 + r < T) out[r * 32] = acc[r];
    }
  }
}

}  // namespace

// z [S, G, 2, 32, 36], overlap [S, 2, 32, 18], hist [S, 2, 15, 32], inv_mask
// [32, 18], synth_w [512, 32] (16-byte aligned) -> pcm [S, 2, G*18*32],
// new_hist [S, 2, 15, 32]; all float32, contiguous, on the current device.
// Returns the cudaError_t of the launch (0: launched).
extern "C" int mp3tpu_synth(const void* z, const void* overlap, const void* hist,
                            const void* inv_mask, const void* synth_w, void* pcm,
                            void* new_hist, int S, int G, void* stream) {
  if (S <= 0 || G <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_row = (G * 18 + kTile - 1) / kTile;
  const long long n_tiles = (long long)S * 2 * tiles_per_row;
  const long long cap = (long long)sms * kBlocksPerSm;
  const int grid = (int)(n_tiles < cap ? n_tiles : cap);
  synth_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)overlap, (const float*)hist,
      (const float*)inv_mask, (const float*)synth_w, (float*)pcm,
      (float*)new_hist, G, tiles_per_row, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* mp3tpu_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
