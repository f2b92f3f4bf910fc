// K9: single-token GQA decode attention over one layer of the bf16 KV cache,
// for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel radvlm_tpu/ops/decode_attention.py
// decode_attention_stacked / _fused_heads_kernel: one query token per row,
// all heads, scores over the [B, Smax, Hkv*D] cache of one layer, slots whose
// segment id is 0 masked, online softmax over blocks of S.
//
// What bounds it on the H100: device-memory bandwidth. Each step reads the
// layer's K and V once (B * Smax * Hkv * D * 2 bytes each) and does ~2 flops
// per byte. With one CTA per (row, kv head), as the TPU grid has, B * Hkv is
// 4-16 CTAs on 132 SMs and the card idles. So S is split across CTAs
// (flash-decoding): grid (nsplit, B * Hkv), each CTA runs an online softmax
// over its chunk and writes f32 partials (max, sum, unnormalised output); a
// second small kernel combines the partials per (row, head). One CTA serves
// the g = H / Hkv query heads of one kv head, so each K/V byte is read once.
// This first version stages 64-key tiles with 4-byte loads and does the dot
// products with plain FMA (memory-bound work; wgmma buys nothing here); wider
// loads and a cp.async/TMA pipeline are the next steps.
//
// Choices against the TPU kernel:
// - The TPU's scalar-prefetch layer index has no counterpart: the wrapper
//   passes the view ck[l], whose pointer already points at layer l.
// - p is zeroed explicitly for slots whose segment is 0. The TPU kernel relies
//   on exp(MASK - m) underflowing once a real slot arrives, and a block of
//   left padding comes first.
// - p stays f32 in the PV sum (the TPU kernel rounds it to bf16).
// - A row with no written slot gives o = 0.
//
// Limits: D even and <= 128, H / Hkv <= 8.

#include "common.cuh"

#include <math.h>

namespace radvlm {
namespace {

constexpr int kTile = 64;  // keys per shared-memory tile (two per lane)
constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;
constexpr int kMaxD = 128;
constexpr int kLds = kMaxD + 2;  // 65 words a row: column reads are conflict-free

__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, H, D]
    const __nv_bfloat16* __restrict__ ck,  // [B, S, Hkv * D], one layer
    const __nv_bfloat16* __restrict__ cv,
    const int* __restrict__ seg,  // [B, S]
    float* __restrict__ part_o,   // [B, H, nsplit, D]
    float* __restrict__ part_ml,  // [B, H, nsplit, 2]: max, sum
    int s, int hkv, int group, int d, int chunk, float scale_log2) {
  __shared__ float qs[kMaxGroup][kMaxD];
  __shared__ __align__(16) __nv_bfloat16 kt[kTile * kLds];
  __shared__ __align__(16) __nv_bfloat16 vt[kTile * kLds];
  __shared__ float sc[kMaxGroup][kTile];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];
  __shared__ int seg_s[kTile];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / hkv, kvh = blockIdx.y % hkv;
  const int h = hkv * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long hd = (long)hkv * d;
  const __nv_bfloat16* kb = ck + (long)b * s * hd + (long)kvh * d;
  const __nv_bfloat16* vb = cv + (long)b * s * hd + (long)kvh * d;
  const int* sb = seg + (long)b * s;

  for (int i = tid; i < group * d; i += kThreads) {
    const int hh = i / d, dd = i % d;
    qs[hh][dd] = __bfloat162float(q[((long)b * h + kvh * group + hh) * d + dd]);
  }
  if (tid < kMaxGroup) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int i = 0; i < kMaxGroup; ++i) acc[i] = 0.f;

  const int c0 = split * chunk, c1 = min(s, c0 + chunk);
  for (int n0 = c0; n0 < c1; n0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kTile * (d / 2); i += kThreads) {
      const int r = i / (d / 2), c = (i % (d / 2)) * 2;
      const int key = n0 + r;
      uint32_t kk = 0u, vv = 0u;
      if (key < c1) {
        kk = *reinterpret_cast<const uint32_t*>(kb + key * hd + c);
        vv = *reinterpret_cast<const uint32_t*>(vb + key * hd + c);
      }
      *reinterpret_cast<uint32_t*>(&kt[r * kLds + c]) = kk;
      *reinterpret_cast<uint32_t*>(&vt[r * kLds + c]) = vv;
    }
    if (tid < kTile) seg_s[tid] = n0 + tid < c1 ? sb[n0 + tid] : 0;
    __syncthreads();

    // Scores: thread -> key tid % 64 and heads tid / 64 + 2i.
    {
      const int key = tid % kTile, h0 = tid / kTile;
      float dot[kMaxGroup / 2];
#pragma unroll
      for (int i = 0; i < kMaxGroup / 2; ++i) dot[i] = 0.f;
      const __nv_bfloat16* krow = &kt[key * kLds];
      for (int c = 0; c < d; c += 2) {
        const __nv_bfloat162 k2 = *reinterpret_cast<const __nv_bfloat162*>(krow + c);
        const float k0 = __low2float(k2), k1 = __high2float(k2);
#pragma unroll
        for (int i = 0; i < kMaxGroup / 2; ++i) {
          const int hh = h0 + 2 * i;
          if (hh < group) dot[i] += qs[hh][c] * k0 + qs[hh][c + 1] * k1;
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxGroup / 2; ++i) {
        const int hh = h0 + 2 * i;
        if (hh < group) sc[hh][key] = seg_s[key] != 0 ? dot[i] : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax, one warp per head (heads warp, warp + 4).
    for (int hh = warp; hh < group; hh += kThreads / 32) {
      const float x0 = sc[hh][lane], x1 = sc[hh][lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[hh];
      const float m_new = fmaxf(m_old, mx);
      const float ref = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = x0 == -INFINITY ? 0.f : exp2f((x0 - ref) * scale_log2);
      const float p1 = x1 == -INFINITY ? 0.f : exp2f((x1 - ref) * scale_log2);
      sc[hh][lane] = p0;
      sc[hh][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f((m_old - ref) * scale_log2);
        alpha_s[hh] = alpha;
        l_s[hh] = l_s[hh] * alpha + sum;
        m_s[hh] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V: thread -> output column tid, all heads.
    if (tid < d) {
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        if (i < group) acc[i] *= alpha_s[i];
      }
      for (int key = 0; key < kTile; ++key) {
        const float vv = __bfloat162float(vt[key * kLds + tid]);
#pragma unroll
        for (int i = 0; i < kMaxGroup; ++i) {
          if (i < group) acc[i] += sc[i][key] * vv;
        }
      }
    }
  }
  __syncthreads();
  if (tid < d) {
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i) {
      if (i < group) {
        const long row = (long)b * h + kvh * group + i;
        part_o[(row * nsplit + split) * d + tid] = acc[i];
      }
    }
  }
  if (tid < group) {
    const long row = (long)b * h + kvh * group + tid;
    part_ml[(row * nsplit + split) * 2 + 0] = m_s[tid];
    part_ml[(row * nsplit + split) * 2 + 1] = l_s[tid];
  }
}

__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_ml,
                                      __nv_bfloat16* __restrict__ out,
                                      int nsplit, int d, float scale_log2) {
  const long row = blockIdx.x;  // b * H + h
  const float* ml = part_ml + row * nsplit * 2;
  float mx = -INFINITY;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, ml[2 * i]);
  const float ref = mx == -INFINITY ? 0.f : mx;
  float l = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    l += ml[2 * i + 1] * exp2f((ml[2 * i] - ref) * scale_log2);
  }
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float o = 0.f;
    for (int i = 0; i < nsplit; ++i) {
      o += part_o[(row * nsplit + i) * d + dd] *
           exp2f((ml[2 * i] - ref) * scale_log2);
    }
    out[row * d + dd] = __float2bfloat16(l > 0.f ? o / l : 0.f);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace
}  // namespace radvlm

extern "C" int radvlm_decode_attention(const void* q, const void* ck,
                                       const void* cv, const void* seg,
                                       void* part_o, void* part_ml, void* out,
                                       int b, int s, int h, int hkv, int d,
                                       int nsplit, int chunk, float scale,
                                       void* stream) {
  using namespace radvlm;
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxD ||
      d % 2 != 0 || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  decode_partial_kernel<<<dim3(nsplit, b * hkv), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(cv), static_cast<const int*>(seg),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), s, hkv,
      h / hkv, d, chunk, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<b * h, 128, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), nsplit, d, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* radvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
