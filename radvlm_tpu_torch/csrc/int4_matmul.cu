// K12: skinny W4A16 matmul for decode, y = x @ bf16(unpack(q4) * group_scale),
// for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel radvlm_tpu/ops/int4_matmul.py
// int4_matmul_stacked / _kernel_stacked (the decode layers' projections on
// nibble-packed int4 weights, a layer picked by a scalar-prefetched index).
// In PyTorch a layer's weight is its own tensor, so the kernel takes one
// layer.
//
// x [M, K] bf16 with M <= 64 rows (decode slots, or slots x verify window),
// w [N, K/2] uint8: torch's [out, in] orientation, two signed nibbles a byte,
// byte b of a row holding k = 2b in its low nibble and k = 2b + 1 in its high
// nibble (the JAX package's concat layout, low nibble = row i and high
// nibble = row i + D/2 of a [D/2, F] array, is a TPU layout; the weight
// bridge repacks once and keeps the inverse), scale [K/128, N] f32: one
// scale per group of 128 along K and output column, y [M, N] bf16.
//
// What it must compute, exactly: each weight is rounded to bf16 AFTER its
// scale, w = bf16(f32(nibble) * scale), then bf16 x bf16 products are summed
// in f32 and the sum is rounded to bf16 once. (K5's "scale after the sum"
// would give another result: int4 -> bf16 times a scale is not exact.) The
// prefill's dequant route uses the same rounded weights.
//
// What bounds it on the H100: device-memory bandwidth (2M flops per weight
// nibble, M <= 64), so the kernel streams w once:
// - each lane loads 16 contiguous bytes = 32 k of one output column with one
//   16-byte load; the four lanes of an mma column cover 128 k = one scale
//   group a step, so a step needs one scale per column; a warp covers 32
//   columns (4 mma column tiles of 8), a CTA 128;
// - the next step's bytes are loaded before this step's are used;
// - nibbles are sign-extended eight at a time from a 32-bit word: shift,
//   mask and flip the sign bit into the mantissa of 2^23 (0x4B000000 | n ^ 8
//   is the float 2^23 + n + 8, exact), subtract 2^23 + 8, multiply by the
//   scale in f32, round pairs to bf16;
// - they go through mma.sync m16n8k16 (bf16 x bf16 -> f32). The 32 k a lane
//   holds are not where the mma fragment wants them, so K is permuted inside
//   each 128-wide step: logical k {2t, 2t+1, 2t+8, 2t+9} of sub-step j is
//   physical k 32t + 4j + {0, 1, 2, 3}. A sum over k does not care as long as
//   x uses the same permutation, which its fragment loads from shared memory
//   do;
// - x is staged through shared memory in 256-wide chunks of K, zero past M;
// - where 128 columns a CTA give too few CTAs for 132 SMs, K is split over
//   grid.y in whole groups of 128: each split writes f32 partials and a
//   second small kernel sums them in split order (no atomics) and rounds to
//   bf16. The split plan depends on N and K only and an mma row's result does
//   not depend on the other rows, so a row's result is the same whatever the
//   number of rows it comes with: greedy speculative tokens rely on that.
//
// Limits: 1 <= M <= 64, K a multiple of 128. N is any width: the columns past
// N are masked.

#include "common.cuh"

namespace radvlm {
namespace {

constexpr int kQ4Warps = 4;
constexpr int kQ4Threads = kQ4Warps * 32;
constexpr int kQ4ColTiles = 4;                          // 8-column mma tiles per warp
constexpr int kQ4BlockN = kQ4Warps * kQ4ColTiles * 8;   // 128 columns per CTA
constexpr int kGroup = 128;                             // K per step = one scale group
constexpr int kQ4ChunkK = 256;                          // K of x staged per pass
constexpr int kQ4XLd = kQ4ChunkK + 8;                   // bf16 row stride of the x tile

// Signed nibble `i` of `word` as a float (exact): the nibble with its sign
// bit flipped is n + 8 in 0..15; or-ed into the mantissa of 2^23 it is the
// float 2^23 + n + 8.
__device__ __forceinline__ float nibble_to_float(uint32_t word, int i) {
  const uint32_t bits = (((word >> (4 * i)) & 0xFu) ^ 0x8u) | 0x4B000000u;
  return __fsub_rn(__uint_as_float(bits), 8388616.0f);
}

// Nibbles i and i + 1 of `word`, each times `scale` in f32, rounded to bf16.
__device__ __forceinline__ uint32_t dequant_pair(uint32_t word, int i, float scale) {
  return pack_bf16(__fmul_rn(nibble_to_float(word, i), scale),
                   __fmul_rn(nibble_to_float(word, i + 1), scale));
}

__device__ __forceinline__ uint32_t q4_word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int kMTiles>
__global__ void __launch_bounds__(kQ4Threads) int4_matmul_kernel(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    const uint8_t* __restrict__ w,        // [N, K/2]
    const float* __restrict__ scale,      // [K/128, N]
    __nv_bfloat16* __restrict__ out,      // [M, N], written when part is null
    float* __restrict__ part,             // [nsplit, M, N] f32 partials, or null
    int m, int n, int k, int k_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[kMTiles * 16][kQ4XLd];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col_warp = blockIdx.x * kQ4BlockN + warp * kQ4ColTiles * 8;
  const int split = blockIdx.y;
  const int k_beg = split * k_per_split;
  const int k_end = min(k, k_beg + k_per_split);

  const uint8_t* wrow[kQ4ColTiles];
  const float* srow[kQ4ColTiles];
  bool wok[kQ4ColTiles];
#pragma unroll
  for (int ct = 0; ct < kQ4ColTiles; ++ct) {
    const int col = col_warp + ct * 8 + g;
    wok[ct] = col < n;
    wrow[ct] = w + static_cast<long>(wok[ct] ? col : 0) * (k / 2) + 16 * t;
    srow[ct] = scale + (wok[ct] ? col : 0);
  }

  float acc[kMTiles][kQ4ColTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int ct = 0; ct < kQ4ColTiles; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][ct][i] = 0.f;

  // This lane's 16 weight bytes (32 k) and the group's scale, per column.
  uint4 wv[kQ4ColTiles], wnext[kQ4ColTiles];
  float sc[kQ4ColTiles], snext[kQ4ColTiles];
  auto load_step = [&](int k0, uint4 (&wq)[kQ4ColTiles], float (&sq)[kQ4ColTiles]) {
#pragma unroll
    for (int ct = 0; ct < kQ4ColTiles; ++ct) {
      wq[ct] = make_uint4(0u, 0u, 0u, 0u);
      sq[ct] = 0.f;
      if (wok[ct] && k0 < k_end) {
        wq[ct] = __ldg(reinterpret_cast<const uint4*>(wrow[ct] + k0 / 2));
        sq[ct] = __ldg(srow[ct] + static_cast<long>(k0 / kGroup) * n);
      }
    }
  };
  load_step(k_beg, wv, sc);

  for (int k0 = k_beg; k0 < k_end; k0 += kGroup) {
    const int s0 = (k0 - k_beg) % kQ4ChunkK;
    if (s0 == 0) {
      const int clen = min(kQ4ChunkK, k_end - k0);
      __syncthreads();  // the previous chunk is consumed
      constexpr int kVecs = kQ4ChunkK / 8;  // 16-byte vectors of bf16 per row
      for (int i = tid; i < kMTiles * 16 * kVecs; i += kQ4Threads) {
        const int r = i / kVecs, c = (i % kVecs) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < m && c < clen) {
          v = *reinterpret_cast<const uint4*>(x + static_cast<long>(r) * k + k0 + c);
        }
        *reinterpret_cast<uint4*>(&xs[r][c]) = v;
      }
      __syncthreads();
    }
    load_step(k0 + kGroup, wnext, snext);

#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      // Word wi of the lane's 16 bytes: physical k 32t + 8wi .. + 7, which
      // is sub-steps j = 2wi (nibbles 0-3) and 2wi + 1 (nibbles 4-7).
      uint32_t bfrag[kQ4ColTiles][2][2];
#pragma unroll
      for (int ct = 0; ct < kQ4ColTiles; ++ct) {
        const uint32_t word = q4_word_of(wv[ct], wi);
        bfrag[ct][0][0] = dequant_pair(word, 0, sc[ct]);  // logical k 2t, 2t+1
        bfrag[ct][0][1] = dequant_pair(word, 2, sc[ct]);  // logical k 2t+8, 2t+9
        bfrag[ct][1][0] = dequant_pair(word, 4, sc[ct]);
        bfrag[ct][1][1] = dequant_pair(word, 6, sc[ct]);
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        // Rows g and g + 8 of the tile, the same 8 physical k.
        const uint4 p0 =
            *reinterpret_cast<const uint4*>(&xs[mt * 16 + g][s0 + 32 * t + 8 * wi]);
        const uint4 p1 =
            *reinterpret_cast<const uint4*>(&xs[mt * 16 + g + 8][s0 + 32 * t + 8 * wi]);
        const uint32_t a0[4] = {p0.x, p1.x, p0.y, p1.y};
        const uint32_t a1[4] = {p0.z, p1.z, p0.w, p1.w};
#pragma unroll
        for (int ct = 0; ct < kQ4ColTiles; ++ct) {
          mma_16816(acc[mt][ct], a0, bfrag[ct][0][0], bfrag[ct][0][1]);
          mma_16816(acc[mt][ct], a1, bfrag[ct][1][0], bfrag[ct][1][1]);
        }
      }
    }
#pragma unroll
    for (int ct = 0; ct < kQ4ColTiles; ++ct) {
      wv[ct] = wnext[ct];
      sc[ct] = snext[ct];
    }
  }

#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int ct = 0; ct < kQ4ColTiles; ++ct) {
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
            out[static_cast<long>(row) * n + col + c] = __float2bfloat16(v);
          }
        }
      }
    }
  }
}

// Sum the K splits' partials in split order, round to bf16.
__global__ void int4_matmul_combine_kernel(const float* __restrict__ part,
                                           __nv_bfloat16* __restrict__ out,
                                           long total, int nsplit) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += part[sp * total + i];
  out[i] = __float2bfloat16(s);
}

template <int kMTiles>
cudaError_t launch_int4(const void* x, const void* w, const void* scale, void* out,
                        void* part, int m, int n, int k, int nsplit, int k_per_split,
                        cudaStream_t st) {
  const dim3 grid((n + kQ4BlockN - 1) / kQ4BlockN, nsplit);
  int4_matmul_kernel<kMTiles><<<grid, kQ4Threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), m, n, k, k_per_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace radvlm

// part: f32 scratch [nsplit, M, N] when nsplit > 1, else null.
extern "C" int radvlm_int4_matmul(const void* x, const void* w, const void* scale,
                                  void* out, void* part, int m, int n, int k,
                                  int nsplit, int k_per_split, void* stream) {
  using namespace radvlm;
  if (m < 1 || m > 64 || n < 1 || k < kGroup || k % kGroup != 0 || nsplit < 1 ||
      k_per_split % kGroup != 0 || static_cast<long>(nsplit) * k_per_split < k ||
      (nsplit > 1) != (part != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((m + 15) / 16) {
    case 1: err = launch_int4<1>(x, w, scale, out, part, m, n, k, nsplit, k_per_split, st); break;
    case 2: err = launch_int4<2>(x, w, scale, out, part, m, n, k, nsplit, k_per_split, st); break;
    case 3: err = launch_int4<3>(x, w, scale, out, part, m, n, k, nsplit, k_per_split, st); break;
    default: err = launch_int4<4>(x, w, scale, out, part, m, n, k, nsplit, k_per_split, st); break;
  }
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const long total = static_cast<long>(m) * n;
  int4_matmul_combine_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), total, nsplit);
  return static_cast<int>(cudaGetLastError());
}
