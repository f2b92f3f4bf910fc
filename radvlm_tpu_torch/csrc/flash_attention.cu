// K1 (tower self-attention) and K2 (causal, segment-masked prefill attention)
// for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernels in radvlm_tpu/ops/flash_attention.py:
//   K1  _fwd_short   (single-pass non-causal softmax for the 729-token tiles)
//   K2  _fwd/_fwd_kernel (blocked online softmax, GQA, causal block skipping,
//       segment mask q_seg == k_seg & q_seg != 0), the forward. Its backward
//       (K7, K8) is flash_attention_bwd.cu and reads the lse written here.
//
// Both are one kernel (design notes at the end of this comment).
//
// Contracts:
// - The scale multiplies the f32 scores after the dot (as _fwd_short does),
//   folded with log2(e) into the exp2 argument.
// - Masked scores are -inf and ex2 of -inf is exactly +0, so masked p is 0; a
//   row with no unmasked key (left padding, segment 0) ends with l = 0 and
//   writes o = 0.
// - Causal positions are absolute (query i sees keys <= i); tiles wholly
//   above the diagonal are never loaded.
// - p is rounded to bf16 before the PV product, as the TPU kernel rounds p to
//   v's dtype; l sums the unrounded p.
// - lse (f32 [B, H, Sq], natural-log units: m * scale + ln(l), -inf on a row
//   with l == 0) is written only when its pointer is given; nothing else
//   depends on it, so o is the same bits with and without it. No atomics on
//   the output: every launch gives the same bits.
//
// Layouts are the port's public BSHD: q/o [B, Sq, H, D], k/v [B, Sk, Hkv, D],
// segment ids [B, S] int32. D must be even and at most 128.
//
// Design:
// - A CTA owns 128 query rows of one (batch, head): two warpgroups of 64
//   rows, each running both products with wgmma (m64nNk16, bf16 in, f32
//   sums). S = Q K^T takes Q and K from shared memory (both K-major); O += P
//   V takes P from registers (the S accumulator rounded to bf16 is already
//   wgmma's A fragment) and V from shared memory with the transpose bit (V is
//   MN-major). Every operand sits in wgmma.cuh's 128-byte swizzled layout
//   of 64-column blocks: D = 72 (SigLIP) takes two blocks, contracts over 80
//   in QK and runs PV at N = 72.
// - K/V tiles of 64 keys stream through a ring of two stages, so tile n + 1
//   is in flight while tile n computes; Q is staged once. Where head_dim % 8
//   == 0 and q, k, v are 16-byte aligned, one thread fills a stage with TMA
//   (one box of 64 columns x 64 rows a column block, landing in the swizzled
//   layout, zeros past the sequence and past head_dim) counted on the
//   stage's mbarrier; elsewhere every thread copies 4 bytes at a time with
//   cp.async into the same layout (one kernel choosing its copy width, not a
//   second route). One barrier a tile frees the stage the next copy
//   overwrites.
// - Clean and masked tiles, as the TPU kernel splits them: a warp skips the
//   per-element mask on a tile wholly inside the sequence, wholly at or
//   below the diagonal for its 16 rows, and (with segment ids) whose keys
//   all carry the one non-zero segment id its rows share (min = max, reduced
//   once a tile). A tile none of whose keys shares a segment with a row of
//   the CTA is skipped (every p would be 0), and a CTA whose rows all have
//   segment 0 (left padding) loads nothing and writes o = 0, lse = -inf.
// - Grid (heads, query tiles, batch): the g query heads of one kv head are
//   neighbouring CTAs (their K/V tiles stay in L2) and query tiles run from
//   the last, so the heaviest causal CTAs start first.
// - Two CTAs an SM (128 registers a thread): four warpgroups interleave, so
//   one's softmax runs beside another's products.
// What bounds it: each warpgroup runs a tile as one dependent chain (the
// ring's barrier, QK, mask and softmax, PV), and four warpgroups an SM do
// not hide its latency: 11-41% of the tensor-core bound at the main-path
// shapes (PERF.md section 6, with the variants that measured no faster:
// PV of tile n - 1 overlapped with tile n's softmax inside a warpgroup,
// 128-key tiles, 256-row CTAs, a third stage, copies issued behind QK).
// The copies cost by the box: with 32-byte swizzled boxes of 16 columns
// (ten a tile at D = 72, sixteen at D = 128) the kernel took 1.12-1.24x
// its time with these 64-column ones (1.00-1.01x at the packed 0.5B shape).

#include "common.cuh"
#include "wgmma.cuh"

#include <limits.h>
#include <math.h>

#include <mutex>

namespace radvlm {
namespace {

constexpr int kBlockM = 128;  // query rows a CTA owns: two warpgroups of 64
constexpr int kBlockN = 64;   // keys a K/V tile holds
constexpr int kStages = 2;    // K/V tiles in shared memory
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory for head dims padded to DP, in bytes: Q, each stage's K and
// V tiles (kCols columns: whole 64-column blocks), each stage's key segment
// ids, the CTA's segment range, each stage's mbarrier.
template <int DP>
struct Smem {
  static constexpr int kCols = (DP + 63) / 64 * 64;
  static constexpr int kQ = kBlockM * kCols * 2;
  static constexpr int kTile = kBlockN * kCols * 2;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kSeg = kQ + kStages * kStage;
  static constexpr int kRange = kSeg + kStages * kBlockN * 4;
  static constexpr int kBar = kRange + 8;
  static constexpr int kBytes = kBar + kStages * 8;
};

struct Params {
  CUtensorMap tq, tk, tv;  // read where tma: [B, S, H, D] in boxes of 16 x rows
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* qseg;  // null: no segment ids
  const int* kseg;
  __nv_bfloat16* o;
  float* lse;  // null: not written
  int sq, sk, h, hkv, d, n_qtiles;
  float scale_log2;
  bool causal;
  bool tma;  // else 4-byte cp.async copies
};

// DP: head_dim padded to a multiple of 16 (the QK contraction); DV: the PV
// product's N, head_dim padded to a multiple of 8.
template <int DP, int DV>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(const __grid_constant__ Params p) {
  using S = Smem<DP>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);
  const int* kseg_s = reinterpret_cast<const int*>(smem + S::kSeg);

  const int hq = blockIdx.x, b = blockIdx.z;
  const int qtile = p.n_qtiles - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int hk = hq / (p.h / p.hkv);
  const int q0 = qtile * kBlockM;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + wg * 64 + warp * 16;  // this warp's first query row
  const int r0 = wrow + g, r1 = r0 + 8;
  const bool seg = p.qseg != nullptr;

  const long q_rs = (long)p.h * p.d, kv_rs = (long)p.hkv * p.d;
  const int* ksegb = seg ? p.kseg + (long)b * p.sk : nullptr;

  // qs0 / qs1: the segment ids of rows r0 / r1; wq: the one non-zero id all
  // 16 rows of this warp share, or -1; [cta_lo, cta_hi]: the range of the
  // CTA's non-zero ids.
  int qs0 = 1, qs1 = 1, wq = 0, cta_lo = 1, cta_hi = 1;
  bool any = true;
  if (seg) {
    int* range = reinterpret_cast<int*>(smem + S::kRange);
    if (threadIdx.x == 0) {
      range[0] = INT_MAX;
      range[1] = INT_MIN;
    }
    qs0 = r0 < p.sq ? p.qseg[(long)b * p.sq + r0] : 0;
    qs1 = r1 < p.sq ? p.qseg[(long)b * p.sq + r1] : 0;
    const int lo = __reduce_min_sync(0xffffffffu, min(qs0, qs1));
    const int hi = __reduce_max_sync(0xffffffffu, max(qs0, qs1));
    wq = lo == hi && lo != 0 ? lo : -1;
    __syncthreads();
    if (qs0 != 0) {
      atomicMin(&range[0], qs0);
      atomicMax(&range[1], qs0);
    }
    if (qs1 != 0) {
      atomicMin(&range[0], qs1);
      atomicMax(&range[1], qs1);
    }
    any = __syncthreads_or(qs0 != 0 || qs1 != 0);
    cta_lo = range[0];
    cta_hi = range[1];
  }
  const int kv_end = p.causal ? min(p.sk, q0 + kBlockM) : p.sk;
  const int n_tiles = any ? (kv_end + kBlockN - 1) / kBlockN : 0;

  if (p.tma && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(sbase + S::kBar + i * 8, 1);
    fence_mbar_init();
  }
  if (p.tma) __syncthreads();

  // Tile `tile` (and Q with tile 0) into its stage of the ring; one
  // cp.async commit group a call (the segment ids, and K / V where not
  // tma), empty past the last tile, so that "all but the newest kStages - 2
  // groups" always means "up to the tile about to be computed".
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      const int st = tile % kStages, n0 = tile * kBlockN;
      const uint32_t ks = sbase + S::kQ + st * S::kStage, vs = ks + S::kTile;
      if (p.tma) {
        if (threadIdx.x == 0) {
          const uint32_t bar = sbase + S::kBar + st * 8;
          mbar_expect_tx(bar, S::kStage + (tile == 0 ? S::kQ : 0));
#pragma unroll
          for (int c = 0; c < S::kCols / 64; ++c) {
            if (tile == 0) tma_load_4d(sbase + c * kBlockM * 128, &p.tq, bar, c * 64, hq, q0, b);
            tma_load_4d(ks + c * kBlockN * 128, &p.tk, bar, c * 64, hk, n0, b);
            tma_load_4d(vs + c * kBlockN * 128, &p.tv, bar, c * 64, hk, n0, b);
          }
        }
      } else {
        const long kv_off = (long)b * p.sk * kv_rs + (long)hk * p.d;
        if (tile == 0) {
          stage_tile<kBlockM, DP, kThreads>(
              sbase, p.q + (long)b * p.sq * q_rs + (long)hq * p.d, q_rs, q0, p.sq, p.d);
        }
        stage_tile<kBlockN, DP, kThreads>(ks, p.k + kv_off, kv_rs, n0, p.sk, p.d);
        stage_tile<kBlockN, DP, kThreads>(vs, p.v + kv_off, kv_rs, n0, p.sk, p.d);
      }
      if (seg && threadIdx.x < kBlockN) {
        const int key = n0 + threadIdx.x;
        cp_async4(sbase + S::kSeg + (st * kBlockN + threadIdx.x) * 4,
                  key < p.sk ? ksegb + key : ksegb, key < p.sk);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  // Running max of the raw scores and partial row sums (rows r0 and r1; each
  // thread sums its own columns, the four threads of a row combine at the end).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale_log2;
  const uint32_t q_s = sbase + wg * 64 * 128;  // this warpgroup's 64 rows of Q

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages, n0 = n * kBlockN;
    if (p.tma) mbar_wait(sbase + S::kBar + st * 8, (n / kStages) & 1);
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile n landed for every thread; tile n - 1's stage is free
    issue(n + kStages - 1);
    const uint32_t k_s = sbase + S::kQ + st * S::kStage, v_s = k_s + S::kTile;
    const int* ks_tile = kseg_s + st * kBlockN;

    bool clean = n0 + kBlockN <= p.sk;
    if (p.causal) clean = clean && n0 + kBlockN - 1 <= wrow;
    if (seg) {
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int i = lane; i < kBlockN; i += 32) {
        lo = min(lo, ks_tile[i]);
        hi = max(hi, ks_tile[i]);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      // No key shares a segment with a row of the CTA: every p is 0, and m,
      // l and O stay as they are.
      if (hi < cta_lo || lo > cta_hi) continue;
      clean = clean && wq > 0 && lo == wq && hi == wq;
    }

    // S = Q K^T: 64 rows x kBlockN keys a warpgroup.
    float s[kBlockN / 2];  // the first k-step overwrites it (scale-d 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      // Column block kk / 4, 32 bytes a k16 step into it.
      Wgmma<kBlockN>::ss(s, desc_k_major(q_s + (kk >> 2) * kBlockM * 128 + (kk & 3) * 32),
                         desc_k_major(k_s + (kk >> 2) * kBlockN * 128 + (kk & 3) * 32),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (!clean) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1), key = n0 + col;
          bool ok = key < p.sk;
          if (p.causal) ok = ok && key <= (e < 2 ? r0 : r1);
          if (seg) {
            const int qv = e < 2 ? qs0 : qs1;
            ok = ok && qv != 0 && qv == ks_tile[col];
          }
          if (!ok) s[j * 4 + e] = -INFINITY;
        }
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j * 4], s[j * 4 + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // exp reference: 0 while a row has seen no unmasked key (no -inf - -inf).
    const float ref0 = mx0 == -INFINITY ? 0.f : mx0;
    const float ref1 = mx1 == -INFINITY ? 0.f : mx1;
    const float a0 = ex2((m0 - ref0) * sl2), a1 = ex2((m1 - ref1) * sl2);
    const float nb0 = -ref0 * sl2, nb1 = -ref1 * sl2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j * 4] = ex2(fmaf(s[j * 4], sl2, nb0));
      s[j * 4 + 1] = ex2(fmaf(s[j * 4 + 1], sl2, nb0));
      s[j * 4 + 2] = ex2(fmaf(s[j * 4 + 2], sl2, nb1));
      s[j * 4 + 3] = ex2(fmaf(s[j * 4 + 3], sl2, nb1));
      rs0 += s[j * 4] + s[j * 4 + 1];
      rs1 += s[j * 4 + 2] + s[j * 4 + 3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mx0;
    m1 = mx1;

    // P as wgmma A fragments: the accumulators of two adjacent 8-key blocks
    // are one k16 step.
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[kk * 8], s[kk * 8 + 1]);
      pa[kk][1] = pack_bf16(s[kk * 8 + 2], s[kk * 8 + 3]);
      pa[kk][2] = pack_bf16(s[kk * 8 + 4], s[kk * 8 + 5]);
      pa[kk][3] = pack_bf16(s[kk * 8 + 6], s[kk * 8 + 7]);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[j * 4] *= a0;
      acc[j * 4 + 1] *= a0;
      acc[j * 4 + 2] *= a1;
      acc[j * 4 + 3] *= a1;
    }

    // O += P V over the tile's keys, 16 a step.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      Wgmma<DV>::rs(acc, pa[kk], desc_mn_major(v_s + kk * 16 * 128, kBlockN * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = p.o + (long)b * p.sq * q_rs + (long)hq * p.d;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (c < p.d) {
      if (r0 < p.sq) {
        *reinterpret_cast<uint32_t*>(ob + r0 * q_rs + c) =
            pack_bf16(acc[j * 4] * inv0, acc[j * 4 + 1] * inv0);
      }
      if (r1 < p.sq) {
        *reinterpret_cast<uint32_t*>(ob + r1 * q_rs + c) =
            pack_bf16(acc[j * 4 + 2] * inv1, acc[j * 4 + 3] * inv1);
      }
    }
  }
  if (p.lse != nullptr && t == 0) {
    // m is the max of the raw scores: lse = m * scale + ln(l), with
    // scale = scale_log2 * ln(2).
    float* lb = p.lse + ((long)b * p.h + hq) * p.sq;
    if (r0 < p.sq) lb[r0] = l0 > 0.f ? m0 * (sl2 * kLn2) + logf(l0) : -INFINITY;
    if (r1 < p.sq) lb[r1] = l1 > 0.f ? m1 * (sl2 * kLn2) + logf(l1) : -INFINITY;
  }
}

// Sets the instantiation's dynamic shared memory limit once per device,
// before its first launch (never inside a graph capture that follows).
template <int DP, int DV>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int kBytes = Smem<DP>::kBytes;
  static std::mutex mu;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev]) {
      err = cudaFuncSetAttribute(flash_fwd_kernel<DP, DV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (err != cudaSuccess) return err;
      ready[dev] = true;
    }
  }
  flash_fwd_kernel<DP, DV><<<dim3(p.h, p.n_qtiles, b), kThreads, kBytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(Params p, int b, cudaStream_t stream) {
  if (p.d <= 0 || p.d % 2 != 0 || p.d > 128 || p.hkv <= 0 || p.h % p.hkv != 0) {
    return cudaErrorInvalidValue;
  }
  p.n_qtiles = (p.sq + kBlockM - 1) / kBlockM;
  if (p.n_qtiles == 0 || p.h == 0 || b == 0) return cudaSuccess;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                         reinterpret_cast<uintptr_t>(p.v);
  p.tma = p.d % 8 == 0 && addr % 16 == 0 && p.sk > 0;
  if (p.tma) {
    cudaError_t err = encode(&p.tq, p.q, b, p.sq, p.h, p.d, kBlockM);
    if (err == cudaSuccess) err = encode(&p.tk, p.k, b, p.sk, p.hkv, p.d, kBlockN);
    if (err == cudaSuccess) err = encode(&p.tv, p.v, b, p.sk, p.hkv, p.d, kBlockN);
    if (err != cudaSuccess) return err;
  }
  if (p.d <= 32) return launch<32, 32>(p, b, stream);
  if (p.d <= 64) return launch<64, 64>(p, b, stream);
  if (p.d <= 72) return launch<80, 72>(p, b, stream);
  return launch<128, 128>(p, b, stream);
}

Params make_params(const void* q, const void* k, const void* v, const void* qseg,
                   const void* kseg, void* o, void* lse, int sq, int sk, int h, int hkv,
                   int d, bool causal, float scale) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.hkv = hkv;
  p.d = d;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  return p;
}

}  // namespace
}  // namespace radvlm
extern "C" int radvlm_tower_attention(const void* q, const void* k, const void* v, void* o,
                                      int b, int s, int h, int d, float scale, void* stream) {
  using namespace radvlm;
  const Params p = make_params(q, k, v, nullptr, nullptr, o, nullptr, s, s, h, h, d, false, scale);
  return static_cast<int>(dispatch(p, b, static_cast<cudaStream_t>(stream)));
}

extern "C" int radvlm_prefill_attention(const void* q, const void* k, const void* v,
                                        const void* qseg, const void* kseg, void* o, int b,
                                        int sq, int sk, int h, int hkv, int d, int causal,
                                        float scale, void* stream) {
  using namespace radvlm;
  if ((qseg == nullptr) != (kseg == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p =
      make_params(q, k, v, qseg, kseg, o, nullptr, sq, sk, h, hkv, d, causal != 0, scale);
  return static_cast<int>(dispatch(p, b, static_cast<cudaStream_t>(stream)));
}

// K2 with the lse output: o as `radvlm_prefill_attention` gives it, bit for
// bit (the same kernel; only the epilogue writes the lse), and lse f32 [B, H,
// Sq] for the backward kernels.
extern "C" int radvlm_prefill_attention_lse(const void* q, const void* k, const void* v,
                                            const void* qseg, const void* kseg, void* o,
                                            void* lse, int b, int sq, int sk, int h, int hkv,
                                            int d, int causal, float scale, void* stream) {
  using namespace radvlm;
  if (lse == nullptr || (qseg == nullptr) != (kseg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(q, k, v, qseg, kseg, o, lse, sq, sk, h, hkv, d, causal != 0, scale);
  return static_cast<int>(dispatch(p, b, static_cast<cudaStream_t>(stream)));
}
