// K1 (tower self-attention) and K2 (causal, segment-masked prefill attention)
// for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernels in radvlm_tpu/ops/flash_attention.py:
//   K1  _fwd_short   (single-pass non-causal softmax for the 729-token tiles)
//   K2  _fwd/_fwd_kernel (blocked online softmax, GQA, causal block skipping,
//       segment mask q_seg == k_seg & q_seg != 0), the forward. Its backward
//       (K7, K8) is flash_attention_bwd.cu and reads the lse written here.
//
// Both are one template: a CTA owns 64 query rows of one (batch, head), four
// warps of 16 rows each. K/V tiles of 64 keys are staged through shared memory
// and the two products run on the tensor cores with mma.sync m16n8k16
// (bf16 in, f32 sums). K1 is the instantiation without causal or segment
// masking; K2 adds them. What bounds it on the H100: the tensor-core rate for
// the two products, but this first version reaches only a fraction of it,
// because it stages K/V synchronously with 4-byte loads (no cp.async/TMA
// pipeline, no wgmma) and reads V fragments element by element. Those are the
// next steps; correctness first.
//
// Choices against the TPU kernels:
// - The scale multiplies the f32 scores after the dot (as _fwd_short does),
//   not the bf16 q (as _fwd_kernel does at :147): one fewer bf16 rounding.
//   The scale and log2(e) fold into one multiply inside exp2.
// - head_dim is padded inside the kernel to DP in {64, 80, 128}: D = 72 (the
//   SigLIP tower) runs as 80, zero-filled. The sequence tail (S = 729) is
//   masked, and out-of-range K/V rows are zero-filled so that 0 * garbage
//   never reaches the sums.
// - Masked scores are -inf and their p is zeroed explicitly; a row with no
//   unmasked key (left padding, segment 0) ends with l = 0 and writes o = 0.
// - Causal: tiles wholly above the diagonal are never loaded (kv_end).
// - p is rounded to bf16 before the PV product, as the TPU kernel rounds p to
//   v's dtype; l sums the unrounded p.
// - The lse output (f32 [B, H, Sq], natural-log units: m * scale + ln(l),
//   -inf on a row with l == 0) is a template flag: serving's entry points
//   instantiate the kernel without it and compute exactly what they did
//   before; `radvlm_prefill_attention_lse` writes it for the backward.
//
// Layouts are the port's public BSHD: q/o [B, Sq, H, D], k/v [B, Sk, Hkv, D],
// segment ids [B, S] int32. D must be even (pairs are loaded as 32 bits).

#include "common.cuh"

#include <math.h>

namespace radvlm {
namespace {

constexpr int kBlockM = 64;  // query rows per CTA (16 per warp)
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

template <int DP, bool CAUSAL, bool HAS_SEG, bool LSE>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qseg,
    const int* __restrict__ kseg, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int sq, int sk, int h, int hkv, int d,
    float scale_log2) {
  constexpr int LDS = DP + 8;  // padded shared row, in bf16 elements
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN * LDS];
  __shared__ int kseg_s[kBlockN];

  const int qtile = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (h / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qtile * kBlockM + warp * 16 + g, r1 = r0 + 8;

  const long q_rs = (long)h * d, kv_rs = (long)hkv * d;
  const __nv_bfloat16* qb = q + (long)b * sq * q_rs + (long)hq * d;
  const __nv_bfloat16* kb = k + (long)b * sk * kv_rs + (long)hk * d;
  const __nv_bfloat16* vb = v + (long)b * sk * kv_rs + (long)hk * d;

  // This warp's 16 query rows as A fragments, zero past S and past D.
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qb + r0 * q_rs + c, r0 < sq && c < d);
    qf[kk][1] = load_pair(qb + r1 * q_rs + c, r1 < sq && c < d);
    qf[kk][2] = load_pair(qb + r0 * q_rs + c + 8, r0 < sq && c + 8 < d);
    qf[kk][3] = load_pair(qb + r1 * q_rs + c + 8, r1 < sq && c + 8 < d);
  }
  int qs0 = 1, qs1 = 1;
  if (HAS_SEG) {
    qs0 = r0 < sq ? qseg[(long)b * sq + r0] : 0;
    qs1 = r1 < sq ? qseg[(long)b * sq + r1] : 0;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  // Running max of the raw scores and partial row sums (rows r0 and r1; each
  // thread sums its own columns, the four threads of a row combine at the end).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int kv_end = sk;
  if (CAUSAL) kv_end = min(sk, (qtile + 1) * kBlockM);
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockN * (DP / 2); i += kThreads) {
      const int r = i / (DP / 2), c = (i % (DP / 2)) * 2;
      const int key = n0 + r;
      const bool ok = key < sk && c < d;
      *reinterpret_cast<uint32_t*>(&ks[r * LDS + c]) =
          load_pair(kb + key * kv_rs + c, ok);
      *reinterpret_cast<uint32_t*>(&vs[r * LDS + c]) =
          load_pair(vb + key * kv_rs + c, ok);
    }
    if (HAS_SEG) {
      for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
        kseg_s[i] = n0 + i < sk ? kseg[(long)b * sk + n0 + i] : 0;
      }
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys per warp.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const __nv_bfloat16* krow = &ks[(nb * 8 + g) * LDS + 2 * t];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[nb], qf[kk], b0, b1);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + 2 * t + (e & 1);
        const int key = n0 + col;
        const int row = e < 2 ? r0 : r1;
        bool ok = key < sk;
        if (CAUSAL) ok = ok && key <= row;
        if (HAS_SEG) {
          const int qsv = e < 2 ? qs0 : qs1;
          ok = ok && qsv != 0 && qsv == kseg_s[col];
        }
        if (!ok) s[nb][e] = -INFINITY;
        if (e < 2) {
          mx0 = fmaxf(mx0, s[nb][e]);
        } else {
          mx1 = fmaxf(mx1, s[nb][e]);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // exp reference: 0 while a row has seen no unmasked key (no -inf - -inf).
    const float ref0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ref1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = exp2f((m0 - ref0) * scale_log2);
    const float a1 = exp2f((m1 - ref1) * scale_log2);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ref = e < 2 ? ref0 : ref1;
        const float p =
            s[nb][e] == -INFINITY ? 0.f : exp2f((s[nb][e] - ref) * scale_log2);
        s[nb][e] = p;
        if (e < 2) {
          rs0 += p;
        } else {
          rs1 += p;
        }
      }
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
    }

    // O += P V: the S accumulators of two adjacent key blocks are exactly the
    // A fragment of one k16 step.
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* v0 = &vs[(j * 16 + 2 * t) * LDS + g];
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        const uint32_t b0 = pack_raw(v0[nd * 8], v0[LDS + nd * 8]);
        const uint32_t b1 = pack_raw(v0[8 * LDS + nd * 8], v0[9 * LDS + nd * 8]);
        mma_16816(acc[nd], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = o + (long)b * sq * q_rs + (long)hq * d;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (c < d) {
      if (r0 < sq) {
        *reinterpret_cast<uint32_t*>(ob + r0 * q_rs + c) =
            pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
      }
      if (r1 < sq) {
        *reinterpret_cast<uint32_t*>(ob + r1 * q_rs + c) =
            pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
      }
    }
  }
  if (LSE && t == 0) {
    // m is the max of the raw scores: lse = m * scale + ln(l), with
    // scale = scale_log2 * ln(2).
    constexpr float kLn2 = 0.6931471805599453f;
    float* lb = lse + ((long)b * h + hq) * sq;
    if (r0 < sq) lb[r0] = l0 > 0.f ? m0 * (scale_log2 * kLn2) + logf(l0) : -INFINITY;
    if (r1 < sq) lb[r1] = l1 > 0.f ? m1 * (scale_log2 * kLn2) + logf(l1) : -INFINITY;
  }
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* qseg;
  const int* kseg;
  __nv_bfloat16* o;
  float* lse;  // written only by the LSE instantiations
  int b, sq, sk, h, hkv, d;
  float scale_log2;
  cudaStream_t stream;
};

template <int DP, bool CAUSAL, bool HAS_SEG, bool LSE>
cudaError_t launch(const Args& a) {
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.h, a.b);
  flash_fwd_kernel<DP, CAUSAL, HAS_SEG, LSE><<<grid, kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.qseg, a.kseg, a.o, a.lse, a.sq, a.sk, a.h, a.hkv, a.d,
      a.scale_log2);
  return cudaGetLastError();
}

template <bool CAUSAL, bool HAS_SEG, bool LSE = false>
cudaError_t dispatch_head_dim(const Args& a) {
  if (a.d % 2 != 0 || a.d > 128 || a.hkv <= 0 || a.h % a.hkv != 0) {
    return cudaErrorInvalidValue;
  }
  if (a.d <= 64) return launch<64, CAUSAL, HAS_SEG, LSE>(a);
  if (a.d <= 80) return launch<80, CAUSAL, HAS_SEG, LSE>(a);
  return launch<128, CAUSAL, HAS_SEG, LSE>(a);
}

template <bool LSE>
cudaError_t dispatch_masks(const Args& a, bool causal) {
  const bool seg = a.qseg != nullptr;
  if (causal) {
    return seg ? dispatch_head_dim<true, true, LSE>(a)
               : dispatch_head_dim<true, false, LSE>(a);
  }
  return seg ? dispatch_head_dim<false, true, LSE>(a)
             : dispatch_head_dim<false, false, LSE>(a);
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace
}  // namespace radvlm

extern "C" int radvlm_tower_attention(const void* q, const void* k,
                                      const void* v, void* o, int b, int s,
                                      int h, int d, float scale, void* stream) {
  using namespace radvlm;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               nullptr,
               nullptr,
               static_cast<__nv_bfloat16*>(o),
               nullptr,
               b, s, s, h, h, d,
               scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_head_dim<false, false>(a));
}

extern "C" int radvlm_prefill_attention(const void* q, const void* k,
                                        const void* v, const void* qseg,
                                        const void* kseg, void* o, int b,
                                        int sq, int sk, int h, int hkv, int d,
                                        int causal, float scale, void* stream) {
  using namespace radvlm;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const int*>(qseg),
               static_cast<const int*>(kseg),
               static_cast<__nv_bfloat16*>(o),
               nullptr,
               b, sq, sk, h, hkv, d,
               scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_masks<false>(a, causal != 0));
}

// K2 with the lse output: o as `radvlm_prefill_attention` gives it, bit for
// bit, and lse f32 [B, H, Sq] for the backward kernels.
extern "C" int radvlm_prefill_attention_lse(const void* q, const void* k,
                                            const void* v, const void* qseg,
                                            const void* kseg, void* o,
                                            void* lse, int b, int sq, int sk,
                                            int h, int hkv, int d, int causal,
                                            float scale, void* stream) {
  using namespace radvlm;
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const int*>(qseg),
               static_cast<const int*>(kseg),
               static_cast<__nv_bfloat16*>(o),
               static_cast<float*>(lse),
               b, sq, sk, h, hkv, d,
               scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_masks<true>(a, causal != 0));
}
