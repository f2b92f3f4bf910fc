// K5/K6: skinny W8A16 matmul for decode, y = (x @ w^T) * scale, for Hopper
// (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernels radvlm_tpu/ops/int8_matmul.py
// int8_matmul_stacked / _kernel_stacked (the decode layers' projections, a
// layer picked by a scalar-prefetched index) and int8_matmul / _kernel (the
// flat lm_head). In PyTorch a layer's weight w[l] is a free view, so one
// kernel serves both callers.
//
// x [M, K] bf16 with M <= 64 rows (decode slots), w [N, K] int8 (torch's
// [out, in] layout, K contiguous), scale [N] f32 per output column, y [M, N]
// bf16. f32 sums, times scale[col], rounded to bf16 once.
//
// What bounds it on the H100: device-memory bandwidth. Every weight byte is
// used M times (2M flops per byte, M <= 64), far below the ~590 int8-op/byte
// ridge, so the kernel is built to stream w once:
// - each lane loads 16 contiguous weight bytes of one output column with one
//   16-byte load, and a warp covers 32 columns (4 mma column tiles of 8) by
//   64 of K per step, so every weight byte is read once, by one lane;
// - the int8 values become bf16 in registers (exact) and go through
//   mma.sync m16n8k16 (bf16 x bf16 -> f32). The 16 bytes a lane holds are
//   not where the mma fragment wants them, so K is permuted inside each
//   64-wide step: logical k {2t, 2t+1, 2t+8, 2t+9} of sub-step j is physical
//   k 16t + 4j + {0, 1, 2, 3}. A sum over k does not care about the order as
//   long as x uses the same permutation, which its fragment loads do;
// - x is staged through shared memory in 256-wide chunks of K (the down
//   projection's x is 64 x 18944 bf16 = 2.4 MB, which does not fit whole),
//   zero past M and past K, and every warp of the CTA reads it from there;
// - one CTA covers 128 columns. Where that gives too few CTAs for 132 SMs
//   (N = 3584 is 28 CTAs), K is split over grid.y: each split writes f32
//   partials and a second small kernel sums them in a fixed order (no
//   atomics, so the result does not change from run to run), scales and
//   rounds to bf16.
//
// Limits: 1 <= M <= 64, K a multiple of 16 (16-byte aligned weight rows).
// N is any width: the columns past N are masked.

#include "common.cuh"

namespace radvlm {
namespace {

constexpr int kI8Warps = 4;
constexpr int kI8Threads = kI8Warps * 32;
constexpr int kColTiles = 4;                        // 8-column mma tiles per warp
constexpr int kBlockN = kI8Warps * kColTiles * 8;   // 128 columns per CTA
constexpr int kStepK = 64;                          // K per step: 16 bytes per lane
constexpr int kChunkK = 256;                        // K of x staged per pass
constexpr int kXLd = kChunkK + 8;                   // bf16 row stride of the x tile

// Bytes `byte` and `byte + 1` of a word of four int8 -> two bf16 (exact).
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t word, int byte) {
  const float lo = static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xffu));
  const float hi = static_cast<float>(static_cast<int8_t>((word >> (8 * byte + 8)) & 0xffu));
  return pack_bf16(lo, hi);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int kMTiles>
__global__ void __launch_bounds__(kI8Threads) int8_matmul_kernel(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    const int8_t* __restrict__ w,         // [N, K]
    const float* __restrict__ scale,      // [N]
    __nv_bfloat16* __restrict__ out,      // [M, N], written when part is null
    float* __restrict__ part,             // [nsplit, M, N] f32 partials, or null
    int m, int n, int k, int k_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[kMTiles * 16][kXLd];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col_warp = blockIdx.x * kBlockN + warp * kColTiles * 8;
  const int split = blockIdx.y;
  const int k_beg = split * k_per_split;
  const int k_end = min(k, k_beg + k_per_split);

  const int8_t* wrow[kColTiles];
  bool wok[kColTiles];
#pragma unroll
  for (int ct = 0; ct < kColTiles; ++ct) {
    const int col = col_warp + ct * 8 + g;
    wok[ct] = col < n;
    wrow[ct] = w + static_cast<long>(wok[ct] ? col : 0) * k;
  }

  float acc[kMTiles][kColTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int ct = 0; ct < kColTiles; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][ct][i] = 0.f;

  for (int c0 = k_beg; c0 < k_end; c0 += kChunkK) {
    const int clen = min(kChunkK, k_end - c0);
    __syncthreads();  // the previous chunk is consumed
    constexpr int kVecs = kChunkK / 8;  // 16-byte vectors of bf16 per row
    for (int i = tid; i < kMTiles * 16 * kVecs; i += kI8Threads) {
      const int r = i / kVecs, c = (i % kVecs) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < m && c < clen) {
        v = *reinterpret_cast<const uint4*>(x + static_cast<long>(r) * k + c0 + c);
      }
      *reinterpret_cast<uint4*>(&xs[r][c]) = v;
    }
    __syncthreads();

    for (int s0 = 0; s0 < clen; s0 += kStepK) {
      // This lane's 16 weight bytes of each of its columns. K is a multiple
      // of 16, so the 16 bytes are all inside K or all past it.
      const int kk = c0 + s0 + 16 * t;
      uint32_t bfrag[kColTiles][4][2];
#pragma unroll
      for (int ct = 0; ct < kColTiles; ++ct) {
        uint4 wv = make_uint4(0u, 0u, 0u, 0u);
        if (wok[ct] && kk < k_end) wv = __ldg(reinterpret_cast<const uint4*>(wrow[ct] + kk));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t word = word_of(wv, j);
          bfrag[ct][j][0] = i8pair_to_bf16x2(word, 0);  // logical k 2t, 2t+1
          bfrag[ct][j][1] = i8pair_to_bf16x2(word, 2);  // logical k 2t+8, 2t+9
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        // Row g and g+8 of the tile, physical k 16t .. 16t+15 of the step.
        const __nv_bfloat16* r0 = &xs[mt * 16 + g][s0 + 16 * t];
        const __nv_bfloat16* r1 = &xs[mt * 16 + g + 8][s0 + 16 * t];
        const uint4 p00 = *reinterpret_cast<const uint4*>(r0);
        const uint4 p01 = *reinterpret_cast<const uint4*>(r0 + 8);
        const uint4 p10 = *reinterpret_cast<const uint4*>(r1);
        const uint4 p11 = *reinterpret_cast<const uint4*>(r1 + 8);
        // Sub-step j reads physical k 16t+4j .. 16t+4j+3: the low word
        // (two bf16) is logical 2t, 2t+1 and the high word 2t+8, 2t+9.
        const uint32_t lo0[4] = {p00.x, p00.z, p01.x, p01.z};
        const uint32_t hi0[4] = {p00.y, p00.w, p01.y, p01.w};
        const uint32_t lo1[4] = {p10.x, p10.z, p11.x, p11.z};
        const uint32_t hi1[4] = {p10.y, p10.w, p11.y, p11.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a[4] = {lo0[j], lo1[j], hi0[j], hi1[j]};
#pragma unroll
          for (int ct = 0; ct < kColTiles; ++ct) {
            mma_16816(acc[mt][ct], a, bfrag[ct][j][0], bfrag[ct][j][1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int ct = 0; ct < kColTiles; ++ct) {
      const int col = col_warp + ct * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + g + 8 * half;
        if (row >= m) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (col + c >= n) continue;
          const float v = acc[mt][ct][2 * half + c];
          if (part != nullptr) {
            part[(static_cast<long>(split) * m + row) * n + col + c] = v;
          } else {
            out[static_cast<long>(row) * n + col + c] = __float2bfloat16(v * scale[col + c]);
          }
        }
      }
    }
  }
}

// Sum the K splits' partials in split order, scale, round to bf16.
__global__ void int8_matmul_combine_kernel(const float* __restrict__ part,
                                           const float* __restrict__ scale,
                                           __nv_bfloat16* __restrict__ out,
                                           int m, int n, int nsplit) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long total = static_cast<long>(m) * n;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += part[sp * total + i];
  out[i] = __float2bfloat16(s * scale[i % n]);
}

template <int kMTiles>
cudaError_t launch_int8(const void* x, const void* w, const void* scale, void* out,
                        void* part, int m, int n, int k, int nsplit, int k_per_split,
                        cudaStream_t st) {
  const dim3 grid((n + kBlockN - 1) / kBlockN, nsplit);
  int8_matmul_kernel<kMTiles><<<grid, kI8Threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), m, n, k, k_per_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace radvlm

// part: f32 scratch [nsplit, M, N] when nsplit > 1, else null.
extern "C" int radvlm_int8_matmul(const void* x, const void* w, const void* scale,
                                  void* out, void* part, int m, int n, int k,
                                  int nsplit, int k_per_split, void* stream) {
  using namespace radvlm;
  if (m < 1 || m > 64 || n < 1 || k < 16 || k % 16 != 0 || nsplit < 1 ||
      k_per_split % kStepK != 0 || static_cast<long>(nsplit) * k_per_split < k ||
      (nsplit > 1) != (part != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((m + 15) / 16) {
    case 1: err = launch_int8<1>(x, w, scale, out, part, m, n, k, nsplit, k_per_split, st); break;
    case 2: err = launch_int8<2>(x, w, scale, out, part, m, n, k, nsplit, k_per_split, st); break;
    case 3: err = launch_int8<3>(x, w, scale, out, part, m, n, k, nsplit, k_per_split, st); break;
    default: err = launch_int8<4>(x, w, scale, out, part, m, n, k, nsplit, k_per_split, st); break;
  }
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const long total = static_cast<long>(m) * n;
  int8_matmul_combine_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), m, n, nsplit);
  return static_cast<int>(cudaGetLastError());
}
