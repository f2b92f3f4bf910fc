// K7 (dk, dv) and K8 (dq): the backward of the fused attention (K2) for
// Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernels in radvlm_tpu/ops/flash_attention.py:
//   K7  _bwd / _bwd_dkv_kernel  (p recomputed from the lse; dv += p^T do;
//       dp = do v^T; ds = p (dp - delta) scale; dk += ds^T q)
//   K8  _bwd / _bwd_dq_kernel   (same recompute; dq += ds k)
// delta = rowsum(do * o) - dlse is computed outside, as the JAX package leaves
// it to XLA.
//
// What is computed, not how the TPU blocks it:
// - K7. On the TPU the query-block loop is the sequential grid axis, every
//   query head writes its own f32 [B, H, Sk, D] dk / dv, and a second XLA
//   pass sums each GQA group. Here a CTA owns 64 keys of one (batch, KV
//   head) and loops inside itself over the g query heads of its group and
//   over the query tiles (from the diagonal down when causal), so dk and dv
//   leave the kernel already summed over the group, in k's dtype, with no
//   f32 temporary, no second pass and no atomics: the sum runs in one fixed
//   order, so the result is the same from run to run. The price is a grid
//   of only Sk/64 x Hkv x B CTAs whose work under a causal mask is uneven
//   (the first key tile sees every query tile); key tile 0 is blockIdx.x 0,
//   so the heaviest CTAs start first.
// - K8. A CTA owns 64 query rows of one (batch, head) and loops over the key
//   tiles up to the diagonal; nothing is summed across CTAs.
// Both: four warps of 16 rows (keys in K7, queries in K8); all four products
// a tile on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 sums);
// tiles staged synchronously through shared memory with 16-byte loads where
// head_dim and the pointers allow it. K7 computes the scores transposed
// (K Q^T), so that p^T and ds^T are already the A operands of its two
// accumulating products. What bounds them on the H100: the tensor-core rate
// (four products in K7, three in K8); this first version has no cp.async /
// TMA pipeline and no wgmma, and reads the B operands of the accumulating
// products element by element, so it reaches a fraction of that rate.
//
// Choices:
// - p = exp2(s * scale * log2(e) - lse * log2(e)) with the scale applied to
//   the f32 scores after the dot, as K2 applies it: the recomputed p agrees
//   with K2's to f32 rounding.
// - p is SELECTED by the mask (causal, segment ids, the ragged tail), never
//   multiplied by it: a row with nothing to attend has lse = -inf, exp2 of
//   +inf is inf, and inf * 0 would be NaN in every key of the tile. Rows
//   past the end of the sequence read lse = 0, delta = 0 and zero q / do.
// - p and ds are rounded to bf16 before the tensor-core products (the TPU's
//   dkv kernel multiplies them in f32; its dq kernel rounds ds already).
// - head_dim is padded inside to DP in {64, 80, 128} (72 runs as 80). At
//   DP = 128 K7 walks the queries in tiles of 32, not 64: its two f32
//   accumulators [16, 128] a warp leave no room for wider score tiles.
//
// Layouts: q / do / dq [B, Sq, H, D], k / v / dk / dv [B, Sk, Hkv, D] bf16;
// lse, delta [B, H, Sq] f32; segment ids [B, S] int32. D must be even.

#include "common.cuh"

#include <math.h>

namespace radvlm {
namespace {

constexpr int kTile = 64;  // rows a CTA owns (16 a warp)
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// rows [row0, row0 + R) of a [*, row_stride] bf16 matrix -> dst [R][DP + 8],
// zero past `limit` rows and past `d` columns.
template <int DP>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long row_stride, int row0,
                                           int limit, int rows, int d,
                                           bool vec) {
  constexpr int LDS = DP + 8;
  if (vec) {  // d % 8 == 0 and 16-byte aligned pointers
    for (int i = threadIdx.x; i < rows * (DP / 8); i += kThreads) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < limit && c < d) {
        val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
      }
      *reinterpret_cast<uint4*>(&dst[r * LDS + c]) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * (DP / 2); i += kThreads) {
      const int r = i / (DP / 2), c = (i % (DP / 2)) * 2;
      uint32_t val = 0u;
      if (row0 + r < limit && c < d) {
        val = *reinterpret_cast<const uint32_t*>(src + (row0 + r) * row_stride + c);
      }
      *reinterpret_cast<uint32_t*>(&dst[r * LDS + c]) = val;
    }
  }
}

// acc[nb] += A(rows row..row+15 of a_s) * B^T(rows nb*8.. of b_s), summed over
// the head dim: both operands are row-major [*, DP + 8] tiles in shared
// memory, the A fragment is loaded once per k16 step and reused over NB.
template <int DP, int NB>
__device__ __forceinline__ void dot_rows(float (&acc)[NB][4],
                                         const __nv_bfloat16* a_s, int row,
                                         const __nv_bfloat16* b_s, int g,
                                         int t) {
  constexpr int LDS = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    const __nv_bfloat16* ar = &a_s[(row + g) * LDS + kk * 16 + 2 * t];
    a[0] = *reinterpret_cast<const uint32_t*>(ar);
    a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * LDS);
    a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * LDS + 8);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const __nv_bfloat16* br = &b_s[(nb * 8 + g) * LDS + kk * 16 + 2 * t];
      mma_16816(acc[nb], a, *reinterpret_cast<const uint32_t*>(br),
                *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// acc[nd] += P(16 x 8*NB, f32 accumulators rounded to bf16) * B(rows of b_s,
// [8*NB, DP]): the accumulators of two adjacent 8-column blocks are the A
// fragment of one k16 step.
template <int DP, int NB>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4],
                                           const float (&p)[NB][4],
                                           const __nv_bfloat16* b_s, int g,
                                           int t) {
  constexpr int LDS = DP + 8;
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * j][0], p[2 * j][1]);
    pa[1] = pack_bf16(p[2 * j][2], p[2 * j][3]);
    pa[2] = pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
    pa[3] = pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
    const __nv_bfloat16* b0r = &b_s[(j * 16 + 2 * t) * LDS + g];
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const uint32_t b0 = pack_raw(b0r[nd * 8], b0r[LDS + nd * 8]);
      const uint32_t b1 = pack_raw(b0r[8 * LDS + nd * 8], b0r[9 * LDS + nd * 8]);
      mma_16816(acc[nd], pa, b0, b1);
    }
  }
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* qseg;
  const int* kseg;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, sq, sk, h, hkv, d;
  float scale;
  bool vec;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// K8: dq
// ---------------------------------------------------------------------------

template <int DP, bool CAUSAL, bool HAS_SEG>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int LDS = DP + 8;
  constexpr int BN = kTile;  // keys per shared-memory tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kTile * LDS;
  __nv_bfloat16* k_s = do_s + kTile * LDS;
  __nv_bfloat16* v_s = k_s + BN * LDS;
  int* kseg_s = reinterpret_cast<int*>(v_s + BN * LDS);

  const int qtile = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int sq = a.sq, sk = a.sk, h = a.h, hkv = a.hkv, d = a.d;
  const int hk = hq / (h / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = qtile * kTile;
  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
  const float scale_log2 = a.scale * kLog2e;

  const long q_rs = (long)h * d, kv_rs = (long)hkv * d;
  const __nv_bfloat16* qb = a.q + (long)b * sq * q_rs + (long)hq * d;
  const __nv_bfloat16* dob = a.dout + (long)b * sq * q_rs + (long)hq * d;
  const __nv_bfloat16* kb = a.k + (long)b * sk * kv_rs + (long)hk * d;
  const __nv_bfloat16* vb = a.v + (long)b * sk * kv_rs + (long)hk * d;

  stage_rows<DP>(q_s, qb, q_rs, m0, sq, kTile, d, a.vec);
  stage_rows<DP>(do_s, dob, q_rs, m0, sq, kTile, d, a.vec);

  const float* lse_b = a.lse + ((long)b * h + hq) * sq;
  const float* delta_b = a.delta + ((long)b * h + hq) * sq;
  // Rows past the end read finite zeros; their p is selected to 0 below.
  const float l2_0 = r0 < sq ? lse_b[r0] * kLog2e : 0.f;
  const float l2_1 = r1 < sq ? lse_b[r1] * kLog2e : 0.f;
  const float dl0 = r0 < sq ? delta_b[r0] : 0.f;
  const float dl1 = r1 < sq ? delta_b[r1] : 0.f;
  int qs0 = 1, qs1 = 1;
  if (HAS_SEG) {
    qs0 = r0 < sq ? a.qseg[(long)b * sq + r0] : 0;
    qs1 = r1 < sq ? a.qseg[(long)b * sq + r1] : 0;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  int kv_end = sk;
  if (CAUSAL) kv_end = min(sk, m0 + kTile);  // tiles above the diagonal: skipped
  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();  // the previous tile is consumed
    stage_rows<DP>(k_s, kb, kv_rs, n0, sk, BN, d, a.vec);
    stage_rows<DP>(v_s, vb, kv_rs, n0, sk, BN, d, a.vec);
    if (HAS_SEG) {
      for (int i = threadIdx.x; i < BN; i += kThreads) {
        kseg_s[i] = n0 + i < sk ? a.kseg[(long)b * sk + n0 + i] : 0;
      }
    }
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
    }
    dot_rows<DP, BN / 8>(s, q_s, warp * 16, k_s, g, t);    // s = q k^T
    dot_rows<DP, BN / 8>(dp, do_s, warp * 16, v_s, g, t);  // dp = do v^T

#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + 2 * t + (e & 1);
        const int key = n0 + col;
        const int row = e < 2 ? r0 : r1;
        bool ok = key < sk && row < sq;
        if (CAUSAL) ok = ok && key <= row;
        if (HAS_SEG) {
          const int qsv = e < 2 ? qs0 : qs1;
          ok = ok && qsv != 0 && qsv == kseg_s[col];
        }
        const float l2 = e < 2 ? l2_0 : l2_1;
        const float dl = e < 2 ? dl0 : dl1;
        const float p = ok ? exp2f(s[nb][e] * scale_log2 - l2) : 0.f;
        s[nb][e] = ok ? p * (dp[nb][e] - dl) * a.scale : 0.f;  // ds
      }
    }
    accumulate<DP, BN / 8>(acc, s, k_s, g, t);  // dq += ds k
  }

  __nv_bfloat16* dqb = a.dq + (long)b * sq * q_rs + (long)hq * d;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (c < d) {
      if (r0 < sq) {
        *reinterpret_cast<uint32_t*>(dqb + r0 * q_rs + c) =
            pack_bf16(acc[nd][0], acc[nd][1]);
      }
      if (r1 < sq) {
        *reinterpret_cast<uint32_t*>(dqb + r1 * q_rs + c) =
            pack_bf16(acc[nd][2], acc[nd][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7: dk, dv, summed over the GQA group
// ---------------------------------------------------------------------------

template <int DP, int BQ, bool CAUSAL, bool HAS_SEG>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int LDS = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kTile * LDS;
  __nv_bfloat16* q_s = v_s + kTile * LDS;
  __nv_bfloat16* do_s = q_s + BQ * LDS;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * LDS);
  float* delta_s = lse_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);

  const int ktile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int sq = a.sq, sk = a.sk, h = a.h, hkv = a.hkv, d = a.d;
  const int group = h / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = ktile * kTile;
  const int kr0 = n0 + warp * 16 + g, kr1 = kr0 + 8;
  const float scale_log2 = a.scale * kLog2e;

  const long q_rs = (long)h * d, kv_rs = (long)hkv * d;
  const __nv_bfloat16* kb = a.k + (long)b * sk * kv_rs + (long)hk * d;
  const __nv_bfloat16* vb = a.v + (long)b * sk * kv_rs + (long)hk * d;
  stage_rows<DP>(k_s, kb, kv_rs, n0, sk, kTile, d, a.vec);
  stage_rows<DP>(v_s, vb, kv_rs, n0, sk, kTile, d, a.vec);
  int ks0 = 1, ks1 = 1;
  if (HAS_SEG) {
    ks0 = kr0 < sk ? a.kseg[(long)b * sk + kr0] : 0;
    ks1 = kr1 < sk ? a.kseg[(long)b * sk + kr1] : 0;
  }

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  // Causal: queries before this key tile see none of its keys.
  const int q_begin = CAUSAL ? (n0 / BQ) * BQ : 0;
  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const __nv_bfloat16* qb = a.q + (long)b * sq * q_rs + (long)hq * d;
    const __nv_bfloat16* dob = a.dout + (long)b * sq * q_rs + (long)hq * d;
    const float* lse_b = a.lse + ((long)b * h + hq) * sq;
    const float* delta_b = a.delta + ((long)b * h + hq) * sq;
    for (int m0 = q_begin; m0 < sq; m0 += BQ) {
      __syncthreads();  // the previous tile is consumed
      stage_rows<DP>(q_s, qb, q_rs, m0, sq, BQ, d, a.vec);
      stage_rows<DP>(do_s, dob, q_rs, m0, sq, BQ, d, a.vec);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = m0 + i < sq;
        // Rows past the end read finite zeros (their p is selected to 0).
        lse_s[i] = in ? lse_b[m0 + i] * kLog2e : 0.f;
        delta_s[i] = in ? delta_b[m0 + i] : 0.f;
        if (HAS_SEG) qseg_s[i] = in ? a.qseg[(long)b * sq + m0 + i] : 0;
      }
      __syncthreads();

      // Transposed tiles: rows are this warp's 16 keys, columns the queries.
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb) {
        st[nb][0] = st[nb][1] = st[nb][2] = st[nb][3] = 0.f;
        dpt[nb][0] = dpt[nb][1] = dpt[nb][2] = dpt[nb][3] = 0.f;
      }
      dot_rows<DP, BQ / 8>(st, k_s, warp * 16, q_s, g, t);    // s^T = k q^T
      dot_rows<DP, BQ / 8>(dpt, v_s, warp * 16, do_s, g, t);  // dp^T = v do^T

#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + 2 * t + (e & 1);
          const int row = m0 + col;  // the query
          const int key = e < 2 ? kr0 : kr1;
          bool ok = key < sk && row < sq;
          if (CAUSAL) ok = ok && key <= row;
          if (HAS_SEG) {
            const int ksv = e < 2 ? ks0 : ks1;
            const int qsv = qseg_s[col];
            ok = ok && qsv != 0 && qsv == ksv;
          }
          const float p = ok ? exp2f(st[nb][e] * scale_log2 - lse_s[col]) : 0.f;
          st[nb][e] = p;
          dpt[nb][e] = ok ? p * (dpt[nb][e] - delta_s[col]) * a.scale : 0.f;  // ds^T
        }
      }
      accumulate<DP, BQ / 8>(dv, st, do_s, g, t);  // dv += p^T do
      accumulate<DP, BQ / 8>(dk, dpt, q_s, g, t);  // dk += ds^T q
    }
  }

  __nv_bfloat16* dkb = a.dk + (long)b * sk * kv_rs + (long)hk * d;
  __nv_bfloat16* dvb = a.dv + (long)b * sk * kv_rs + (long)hk * d;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (c < d) {
      if (kr0 < sk) {
        *reinterpret_cast<uint32_t*>(dkb + kr0 * kv_rs + c) = pack_bf16(dk[nd][0], dk[nd][1]);
        *reinterpret_cast<uint32_t*>(dvb + kr0 * kv_rs + c) = pack_bf16(dv[nd][0], dv[nd][1]);
      }
      if (kr1 < sk) {
        *reinterpret_cast<uint32_t*>(dkb + kr1 * kv_rs + c) = pack_bf16(dk[nd][2], dk[nd][3]);
        *reinterpret_cast<uint32_t*>(dvb + kr1 * kv_rs + c) = pack_bf16(dv[nd][2], dv[nd][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int DP, bool CAUSAL, bool HAS_SEG>
cudaError_t launch_dq(const Args& a) {
  constexpr int LDS = DP + 8;
  constexpr int smem = 4 * kTile * LDS * 2 + kTile * 4;
  auto kernel = flash_bwd_dq_kernel<DP, CAUSAL, HAS_SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kTile - 1) / kTile, a.h, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

template <int DP, int BQ, bool CAUSAL, bool HAS_SEG>
cudaError_t launch_dkv(const Args& a) {
  constexpr int LDS = DP + 8;
  constexpr int smem = (2 * kTile + 2 * BQ) * LDS * 2 + BQ * 12;
  auto kernel = flash_bwd_dkv_kernel<DP, BQ, CAUSAL, HAS_SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sk + kTile - 1) / kTile, a.hkv, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

template <bool DKV, bool CAUSAL, bool HAS_SEG>
cudaError_t dispatch_head_dim(const Args& a) {
  if constexpr (DKV) {
    if (a.d <= 64) return launch_dkv<64, 64, CAUSAL, HAS_SEG>(a);
    if (a.d <= 80) return launch_dkv<80, 64, CAUSAL, HAS_SEG>(a);
    return launch_dkv<128, 32, CAUSAL, HAS_SEG>(a);
  } else {
    if (a.d <= 64) return launch_dq<64, CAUSAL, HAS_SEG>(a);
    if (a.d <= 80) return launch_dq<80, CAUSAL, HAS_SEG>(a);
    return launch_dq<128, CAUSAL, HAS_SEG>(a);
  }
}

template <bool DKV>
cudaError_t dispatch(const Args& a, bool causal) {
  if (a.d % 2 != 0 || a.d > 128 || a.hkv <= 0 || a.h % a.hkv != 0 ||
      a.b <= 0 || a.sq <= 0 || a.sk <= 0) {
    return cudaErrorInvalidValue;
  }
  const bool seg = a.qseg != nullptr;
  if (causal) {
    return seg ? dispatch_head_dim<DKV, true, true>(a)
               : dispatch_head_dim<DKV, true, false>(a);
  }
  return seg ? dispatch_head_dim<DKV, false, true>(a)
             : dispatch_head_dim<DKV, false, false>(a);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* qseg,
               const void* kseg, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int b, int sq,
               int sk, int h, int hkv, int d, float scale, void* stream) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.scale = scale;
  a.vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace
}  // namespace radvlm

// K7: dk, dv [B, Sk, Hkv, D] (every element written).
extern "C" int radvlm_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, int b, int sq, int sk, int h, int hkv, int d,
    int causal, float scale, void* stream) {
  using namespace radvlm;
  const Args a = make_args(q, k, v, qseg, kseg, dout, lse, delta, nullptr, dk,
                           dv, b, sq, sk, h, hkv, d, scale, stream);
  return static_cast<int>(dispatch<true>(a, causal != 0));
}

// K8: dq [B, Sq, H, D] (every element written).
extern "C" int radvlm_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* dout, const void* lse, const void* delta,
    void* dq, int b, int sq, int sk, int h, int hkv, int d, int causal,
    float scale, void* stream) {
  using namespace radvlm;
  const Args a = make_args(q, k, v, qseg, kseg, dout, lse, delta, dq, nullptr,
                           nullptr, b, sq, sk, h, hkv, d, scale, stream);
  return static_cast<int>(dispatch<false>(a, causal != 0));
}
