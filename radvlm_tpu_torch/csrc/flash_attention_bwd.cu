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
// Contracts (both kernels):
// - p = exp2(s * scale * log2(e) - lse * log2(e)), the scale applied to the
//   f32 scores after the dot, as K2 applies it.
// - p is SELECTED by the mask (causal, segment ids, the ragged tails), never
//   multiplied by it: a row with nothing to attend has lse = -inf, and exp2
//   of +inf is inf. Rows past the end of the sequence read lse = 0, delta =
//   0 and zero q / do. Causal positions are absolute (query i sees keys <= i).
// - p and ds are rounded to bf16 before the tensor-core products.
// - No atomics on the outputs: every sum runs in one fixed order, so two
//   launches give the same bits.
//
// Layouts: q / do / dq [B, Sq, H, D], k / v / dk / dv [B, Sk, Hkv, D] bf16;
// lse, delta [B, H, Sq] f32; segment ids [B, S] int32. D even, <= 128.
//
// Design (csrc/wgmma.cuh's toolkit, as K2 in flash_attention.cu uses it):
// - Every product is a wgmma m64nNk16 (bf16 in, f32 sums) on operands in the
//   128-byte swizzled layout of 64-column blocks. The scores are SS products
//   (both operands K-major in shared memory); the accumulating products take
//   p or ds from registers (the score accumulators rounded to bf16 are
//   already wgmma's A fragments) and read their B operand MN-major through
//   the transpose bit. D = 72 contracts over 80 and accumulates at N = 72.
// - Tiles stream through a ring of three stages (two where K8's 128-key
//   tiles at D = 72 leave room for no more) that one thread fills with TMA
//   boxes of 64 columns, counted on per-stage mbarriers; where head_dim % 8
//   != 0 or a view is not 16-byte aligned every thread copies 4 bytes at a
//   time with cp.async into the same layout. lse, delta and segment ids
//   arrive by cp.async.
// - The exp2 of a tile run as one straight loop and the per-element mask
//   after it, under one branch a warp (the per-warp clean/masked split): a
//   test inside the loop left a branch after every exp2 and serialized them.
// - K8 (dq) is K2's loop: a CTA owns 128 query rows of one (batch, head) in
//   two warpgroups; Q and dO are staged once, K / V tiles of 128 keys (64
//   at D = 128) pass through the ring; S = Q K^T and dP = dO V^T (SS), dQ
//   += dS K (RS, K MN-major). Heavy causal tiles first; key tiles that no
//   row's segment reaches are skipped; a CTA of padding rows loads nothing.
// - K7 (dk, dv) is the transposed loop: a CTA owns 128 keys (64 a
//   warpgroup); K and V are staged once, Q / dO tiles of 128 queries at D <=
//   64 and 64 above (with their lse, delta and segment ids) pass through the
//   ring; S^T = K Q^T and dP^T = V dO^T (SS), so that P^T and dS^T land in
//   registers as the A operands of dV += P^T dO and dK += dS^T Q (RS, dO and
//   Q MN-major); p is computed while dP^T is in flight, ds while dV's is.
//   The grid runs over query heads: the g heads of a GQA group are split
//   over a thread-block cluster of c CTAs (c the largest divisor of g that
//   is at most 8; each CTA walks g / c heads and every query tile). Each CTA
//   keeps f32 dK, dV for its keys; then every CTA of the cluster writes them
//   into its own shared memory (K, V and the drained ring), and CTA r sums
//   its 1/c share of the elements over ranks 0..c-1 in rank order through
//   distributed shared memory, casts once to bf16 and writes. No f32 tensor
//   leaves the kernel, as the JAX package sums its per-head f32 dk / dv
//   before the cast. Grid (Hkv c, key tiles, B): the heads of one key tile
//   are neighbours and key tile 0, the heaviest under a causal mask, comes
//   first; the CTAs of a cluster share a key tile and so carry one load.
// Both run one CTA an SM (176-254 registers a thread, no spills).
// What bounds them on the H100: the tensor-core rate (four products in K7,
// three in K8), of which they reach 17-38% at the training shapes: each
// warpgroup runs a tile as one dependent chain (scores, exp2, products),
// and two warpgroups an SM hide little of it (PERF.md section 6).

#include "common.cuh"
#include "wgmma.cuh"

#include <limits.h>
#include <math.h>

#include <mutex>

namespace radvlm {
namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap tq, tdo, tk, tv;  // read where tma
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const int* qseg;  // null: no segment ids
  const int* kseg;
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int sq, sk, h, hkv, d;
  int cluster;  // K7: the CTAs a GQA group's heads are split over
  float scale, scale_log2;
  bool causal;
  bool tma;  // else 4-byte cp.async copies
};

// The segment ids of this thread's two rows r0 and r0 + 8 (0 past `n`), the
// one non-zero id all 16 rows of its warp share (else -1), the range of the
// CTA's non-zero ids and whether it has any. Every thread of the CTA calls
// it; `range` is two ints of shared memory.
struct Segments {
  int s0, s1, warp_id, lo, hi;
  bool any;
};

__device__ __forceinline__ Segments row_segments(const int* ids, int r0, int n, int* range) {
  Segments s;
  if (threadIdx.x == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  s.s0 = r0 < n ? ids[r0] : 0;
  s.s1 = r0 + 8 < n ? ids[r0 + 8] : 0;
  const int lo = __reduce_min_sync(0xffffffffu, min(s.s0, s.s1));
  const int hi = __reduce_max_sync(0xffffffffu, max(s.s0, s.s1));
  s.warp_id = lo == hi && lo != 0 ? lo : -1;
  __syncthreads();
  if (s.s0 != 0) {
    atomicMin(&range[0], s.s0);
    atomicMax(&range[1], s.s0);
  }
  if (s.s1 != 0) {
    atomicMin(&range[0], s.s1);
    atomicMax(&range[1], s.s1);
  }
  s.any = __syncthreads_or(s.s0 != 0 || s.s1 != 0);
  s.lo = range[0];
  s.hi = range[1];
  return s;
}

// The least and largest of a tile's N segment ids in shared memory, reduced
// by one warp.
template <int N>
__device__ __forceinline__ void tile_range(const int* ids, int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int i = lane; i < N; i += 32) {
    lo = min(lo, ids[i]);
    hi = max(hi, ids[i]);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

template <int kStages>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i * 8, 1);
    fence_mbar_init();
  }
  __syncthreads();
}

// Tile n of the ring has landed for every thread, and tile n - 1's stage is
// free for the next copy. Every issue commits one cp.async group, so "all
// but the newest kStages - 2" means "up to tile n".
template <int kStages>
__device__ __forceinline__ void ring_wait(bool tma, uint32_t bars, int n) {
  if (tma) mbar_wait(bars + (n % kStages) * 8, (n / kStages) & 1);
  cp_async_wait<kStages - 2>();
  fence_proxy_async();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K8: dq
// ---------------------------------------------------------------------------

// K8's tiles for head dims padded to DP: BN keys a stage (the N of the
// score products) and the ring's stages, within 227 KB of shared memory.
template <int DP>
struct DqCfg {
  static constexpr int BN = DP <= 80 ? 128 : 64;
  static constexpr int kStages = DP <= 64 || DP > 80 ? 3 : 2;
};

// Shared memory in bytes: Q and dO of the CTA's 128 rows, each stage's K
// and V tiles of BN keys, each stage's key segment ids, the CTA's segment
// range, each stage's mbarrier.
template <int DP>
struct DqSmem : DqCfg<DP> {
  using DqCfg<DP>::BN;
  using DqCfg<DP>::kStages;
  static constexpr int kCols = (DP + 63) / 64 * 64;
  static constexpr int kQ = 128 * kCols * 2;
  static constexpr int kTile = BN * kCols * 2;
  static constexpr int kRing = 2 * kQ;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kSeg = kRing + kStages * kStage;
  static constexpr int kRange = kSeg + kStages * BN * 4;
  static constexpr int kBar = kRange + 8;
  static constexpr int kBytes = kBar + kStages * 8;
};

// DP: head_dim padded to a multiple of 16 (the contractions over D); DV: the
// accumulating product's N, head_dim padded to a multiple of 8.
template <int DP, int DV>
__global__ void __launch_bounds__(kThreads, 1) bwd_dq_kernel(const __grid_constant__ Params p) {
  using S = DqSmem<DP>;
  constexpr int BN = S::BN, kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);
  const int* kseg_s = reinterpret_cast<const int*>(smem + S::kSeg);

  const int hq = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;  // the heaviest causal tiles first
  const int hk = hq / (p.h / p.hkv);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + wg * 64 + warp * 16;  // this warp's first query row
  const int r0 = wrow + g, r1 = r0 + 8;
  const bool seg = p.qseg != nullptr;
  const long q_rs = (long)p.h * p.d, kv_rs = (long)p.hkv * p.d;
  const int* ksegb = seg ? p.kseg + (long)b * p.sk : nullptr;

  Segments sg{1, 1, 0, 1, 1, true};
  if (seg) {
    sg = row_segments(p.qseg + (long)b * p.sq, r0, p.sq,
                      reinterpret_cast<int*>(smem + S::kRange));
  }
  const int kv_end = p.causal ? min(p.sk, q0 + 128) : p.sk;
  const int n_tiles = sg.any ? (kv_end + BN - 1) / BN : 0;

  // -lse in log2 units and delta of rows r0 and r1; rows past the end read 0.
  const long lrow = ((long)b * p.h + hq) * p.sq;
  const float nl0 = r0 < p.sq ? -p.lse[lrow + r0] * kLog2e : 0.f;
  const float nl1 = r1 < p.sq ? -p.lse[lrow + r1] * kLog2e : 0.f;
  const float dl0 = r0 < p.sq ? p.delta[lrow + r0] : 0.f;
  const float dl1 = r1 < p.sq ? p.delta[lrow + r1] : 0.f;

  const uint32_t bars = sbase + S::kBar;
  if (p.tma) init_bars<kStages>(bars);

  // Tile `tile` (and Q, dO with tile 0) into its stage; one cp.async commit
  // group a call, empty past the last tile.
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      const int st = tile % kStages, n0 = tile * BN;
      const uint32_t ks = sbase + S::kRing + st * S::kStage, vs = ks + S::kTile;
      if (p.tma) {
        if (threadIdx.x == 0) {
          const uint32_t bar = bars + st * 8;
          mbar_expect_tx(bar, S::kStage + (tile == 0 ? 2 * S::kQ : 0));
#pragma unroll
          for (int c = 0; c < S::kCols / 64; ++c) {
            if (tile == 0) {
              tma_load_4d(sbase + c * 128 * 128, &p.tq, bar, c * 64, hq, q0, b);
              tma_load_4d(sbase + S::kQ + c * 128 * 128, &p.tdo, bar, c * 64, hq, q0, b);
            }
            tma_load_4d(ks + c * BN * 128, &p.tk, bar, c * 64, hk, n0, b);
            tma_load_4d(vs + c * BN * 128, &p.tv, bar, c * 64, hk, n0, b);
          }
        }
      } else {
        if (tile == 0) {
          const long q_off = (long)b * p.sq * q_rs + (long)hq * p.d;
          stage_tile<128, DP, kThreads>(sbase, p.q + q_off, q_rs, q0, p.sq, p.d);
          stage_tile<128, DP, kThreads>(sbase + S::kQ, p.dout + q_off, q_rs, q0, p.sq, p.d);
        }
        const long kv_off = (long)b * p.sk * kv_rs + (long)hk * p.d;
        stage_tile<BN, DP, kThreads>(ks, p.k + kv_off, kv_rs, n0, p.sk, p.d);
        stage_tile<BN, DP, kThreads>(vs, p.v + kv_off, kv_rs, n0, p.sk, p.d);
      }
      if (seg && threadIdx.x < BN) {
        const int key = n0 + threadIdx.x;
        cp_async4(sbase + S::kSeg + (st * BN + threadIdx.x) * 4,
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
  const float sl2 = p.scale_log2, scale = p.scale;
  const uint32_t q_s = sbase + wg * 64 * 128, do_s = q_s + S::kQ;  // this warpgroup's rows

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages, n0 = n * BN;
    ring_wait<kStages>(p.tma, bars, n);
    issue(n + kStages - 1);
    const uint32_t k_s = sbase + S::kRing + st * S::kStage, v_s = k_s + S::kTile;
    const int* ks_tile = kseg_s + st * BN;

    // Under the causal mask no row of this warpgroup sees the tile.
    if (p.causal && n0 > q0 + wg * 64 + 63) continue;
    bool clean = n0 + BN <= p.sk;
    if (p.causal) clean = clean && n0 + BN - 1 <= wrow;
    if (seg) {
      int lo, hi;
      tile_range<BN>(ks_tile, lane, lo, hi);
      // No key shares a segment with a row of the CTA: every ds is 0.
      if (hi < sg.lo || lo > sg.hi) continue;
      clean = clean && sg.warp_id > 0 && lo == sg.warp_id && hi == sg.warp_id;
    }

    // S = Q K^T and dP = dO V^T: 64 rows x BN keys a warpgroup, two commit
    // groups, so that p is computed while dP is still in flight.
    float s[BN / 2], dp[BN / 2];  // the first k-step overwrites them (scale-d 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BN>::ss(s, desc_k_major(q_s + (kk >> 2) * 128 * 128 + (kk & 3) * 32),
                    desc_k_major(k_s + (kk >> 2) * BN * 128 + (kk & 3) * 32), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BN>::ss(dp, desc_k_major(do_s + (kk >> 2) * 128 * 128 + (kk & 3) * 32),
                    desc_k_major(v_s + (kk >> 2) * BN * 128 + (kk & 3) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // p into s, then selected by the mask (one branch a warp: the exp2 of a
    // tile stay one straight run of independent instructions).
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = ex2(fmaf(s[i], sl2, (i & 2) ? nl1 : nl0));
    if (!clean) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1), key = n0 + col;
          bool ok = key < p.sk;
          if (p.causal) ok = ok && key <= (e < 2 ? r0 : r1);
          if (seg) {
            const int qv = e < 2 ? sg.s0 : sg.s1;
            ok = ok && qv != 0 && qv == ks_tile[col];
          }
          s[j * 4 + e] = ok ? s[j * 4 + e] : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // ds = p (dp - delta) scale, into s.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j * 4 + e] = s[j * 4 + e] * (dp[j * 4 + e] - (e < 2 ? dl0 : dl1)) * scale;
      }
    }
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) da[kk][i] = pack_bf16(s[kk * 8 + 2 * i], s[kk * 8 + 2 * i + 1]);
    }

    // dQ += dS K over the tile's keys, 16 a step.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      Wgmma<DV>::rs(acc, da[kk], desc_mn_major(k_s + kk * 16 * 128, BN * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  __nv_bfloat16* dqb = p.dq + (long)b * p.sq * q_rs + (long)hq * p.d;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (c < p.d) {
      if (r0 < p.sq) {
        *reinterpret_cast<uint32_t*>(dqb + r0 * q_rs + c) = pack_bf16(acc[j * 4], acc[j * 4 + 1]);
      }
      if (r1 < p.sq) {
        *reinterpret_cast<uint32_t*>(dqb + r1 * q_rs + c) =
            pack_bf16(acc[j * 4 + 2], acc[j * 4 + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7: dk, dv, summed over the GQA group
// ---------------------------------------------------------------------------

// K7's tiles for head dims padded to DP: BQ queries a stage (the N of the
// score products; 64 from DP 80, where 128 spill) and the ring's stages.
template <int DP>
struct DkvCfg {
  static constexpr int BQ = DP <= 64 ? 128 : 64;
  static constexpr int kStages = 3;
};

// Shared memory in bytes: K and V of the CTA's 128 keys, each stage's Q and
// dO tiles of BQ queries, each stage's lse, delta and query segment ids (BQ
// each), the CTA's segment range, each stage's mbarrier. The cluster's sum
// overwrites the start with the f32 dK and dV [128, DV] (at most 1024 DP
// bytes: within K, V and the ring).
template <int DP>
struct DkvSmem : DkvCfg<DP> {
  using DkvCfg<DP>::BQ;
  using DkvCfg<DP>::kStages;
  static constexpr int kCols = (DP + 63) / 64 * 64;
  static constexpr int kKV = 128 * kCols * 2;
  static constexpr int kTile = BQ * kCols * 2;
  static constexpr int kRing = 2 * kKV;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRows = kRing + kStages * kStage;
  static constexpr int kRange = kRows + kStages * 3 * BQ * 4;
  static constexpr int kBar = kRange + 8;
  static constexpr int kBytes = kBar + kStages * 8;
};

template <int DP, int DV>
__global__ void __launch_bounds__(kThreads, 1) bwd_dkv_kernel(const __grid_constant__ Params p) {
  using S = DkvSmem<DP>;
  constexpr int BQ = S::BQ, kStages = S::kStages;
  static_assert(2 * 128 * DV * 4 <= S::kRows, "the f32 partials must fit K, V and the ring");
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);

  const int c = p.cluster, heads = p.h / p.hkv / c;  // the query heads this CTA walks
  const int rank = c > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int hk = blockIdx.x / c, b = blockIdx.z;
  const int h0 = hk * (p.h / p.hkv) + rank * heads;
  const int n0 = blockIdx.y * 128;  // key tile 0 first
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = n0 + wg * 64 + warp * 16;  // this warp's first key
  const int k0 = wkey + g, k1 = k0 + 8;
  const bool seg = p.qseg != nullptr;
  const long q_rs = (long)p.h * p.d, kv_rs = (long)p.hkv * p.d;
  const int* qsegb = seg ? p.qseg + (long)b * p.sq : nullptr;

  Segments sg{1, 1, 0, 1, 1, true};
  if (seg) {
    sg = row_segments(p.kseg + (long)b * p.sk, k0, p.sk,
                      reinterpret_cast<int*>(smem + S::kRange));
  }
  // Query tiles of BQ; under the causal mask the first is the one that
  // holds query n0. The ring walks (head, query tile) pairs, heads outermost.
  const int n_qt_all = (p.sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? min(n0 / BQ, n_qt_all) : 0;
  const int n_qt = n_qt_all - qt0;
  const int n_tiles = sg.any ? heads * n_qt : 0;

  const uint32_t bars = sbase + S::kBar;
  if (p.tma) init_bars<kStages>(bars);

  // Tile `tile` (and K, V with tile 0) into its stage; one cp.async commit
  // group a call (lse, delta, segment ids, and Q / dO where not tma), empty
  // past the last tile.
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      const int st = tile % kStages;
      const int hq = h0 + tile / n_qt, m0 = (qt0 + tile % n_qt) * BQ;
      const uint32_t qs = sbase + S::kRing + st * S::kStage, dos = qs + S::kTile;
      if (p.tma) {
        if (threadIdx.x == 0) {
          const uint32_t bar = bars + st * 8;
          mbar_expect_tx(bar, S::kStage + (tile == 0 ? 2 * S::kKV : 0));
#pragma unroll
          for (int cb = 0; cb < S::kCols / 64; ++cb) {
            if (tile == 0) {
              tma_load_4d(sbase + cb * 128 * 128, &p.tk, bar, cb * 64, hk, n0, b);
              tma_load_4d(sbase + S::kKV + cb * 128 * 128, &p.tv, bar, cb * 64, hk, n0, b);
            }
            tma_load_4d(qs + cb * BQ * 128, &p.tq, bar, cb * 64, hq, m0, b);
            tma_load_4d(dos + cb * BQ * 128, &p.tdo, bar, cb * 64, hq, m0, b);
          }
        }
      } else {
        if (tile == 0) {
          const long kv_off = (long)b * p.sk * kv_rs + (long)hk * p.d;
          stage_tile<128, DP, kThreads>(sbase, p.k + kv_off, kv_rs, n0, p.sk, p.d);
          stage_tile<128, DP, kThreads>(sbase + S::kKV, p.v + kv_off, kv_rs, n0, p.sk, p.d);
        }
        const long q_off = (long)b * p.sq * q_rs + (long)hq * p.d;
        stage_tile<BQ, DP, kThreads>(qs, p.q + q_off, q_rs, m0, p.sq, p.d);
        stage_tile<BQ, DP, kThreads>(dos, p.dout + q_off, q_rs, m0, p.sq, p.d);
      }
      // The lse, delta and segment ids of the tile's queries, BQ each, one
      // value a thread a pass; zeros past the end.
#pragma unroll
      for (int pass = 0; pass < (3 * BQ + kThreads - 1) / kThreads; ++pass) {
        const int x = pass * kThreads + threadIdx.x;
        if (x >= (seg ? 3 : 2) * BQ) break;
        const int i = x % BQ, which = x / BQ;
        const bool ok = m0 + i < p.sq;
        const long row = ((long)b * p.h + hq) * p.sq + m0 + i;
        const void* base = which == 0 ? static_cast<const void*>(p.lse)
                           : which == 1 ? static_cast<const void*>(p.delta)
                                        : static_cast<const void*>(qsegb);
        const void* src = which == 0 ? static_cast<const void*>(p.lse + row)
                          : which == 1 ? static_cast<const void*>(p.delta + row)
                                       : static_cast<const void*>(qsegb + m0 + i);
        cp_async4(sbase + S::kRows + ((st * 3 + which) * BQ + i) * 4, ok ? src : base, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float dk[DV / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dk[i] = dv[i] = 0.f;
  const float sl2 = p.scale_log2, scale = p.scale;
  const uint32_t k_s = sbase + wg * 64 * 128, v_s = k_s + S::kKV;  // this warpgroup's keys
  const int wg_key = n0 + wg * 64;

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages, m0 = (qt0 + n % n_qt) * BQ;
    ring_wait<kStages>(p.tma, bars, n);
    issue(n + kStages - 1);
    const uint32_t q_s = sbase + S::kRing + st * S::kStage, do_s = q_s + S::kTile;
    const float* lse_s = reinterpret_cast<const float*>(smem + S::kRows + st * 3 * BQ * 4);
    const float* delta_s = lse_s + BQ;
    const int* qseg_s = reinterpret_cast<const int*>(lse_s + 2 * BQ);

    // Under the causal mask no query of the tile sees this warpgroup's keys.
    if (p.causal && wg_key > m0 + BQ - 1) continue;
    bool clean = m0 + BQ <= p.sq && wkey + 16 <= p.sk;
    if (p.causal) clean = clean && wkey + 15 <= m0;
    if (seg) {
      int lo, hi;
      tile_range<BQ>(qseg_s, lane, lo, hi);
      // No query shares a segment with a key of the CTA: every p is 0.
      if (hi < sg.lo || lo > sg.hi) continue;
      clean = clean && sg.warp_id > 0 && lo == sg.warp_id && hi == sg.warp_id;
    }

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries a warpgroup, two
    // commit groups: p is computed while dP^T is in flight, and ds while dV
    // += P^T dO is.
    float sc[BQ / 2], dpt[BQ / 2];  // the first k-step overwrites them (scale-d 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BQ>::ss(sc, desc_k_major(k_s + (kk >> 2) * 128 * 128 + (kk & 3) * 32),
                    desc_k_major(q_s + (kk >> 2) * BQ * 128 + (kk & 3) * 32), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BQ>::ss(dpt, desc_k_major(v_s + (kk >> 2) * 128 * 128 + (kk & 3) * 32),
                    desc_k_major(do_s + (kk >> 2) * BQ * 128 + (kk & 3) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // p into sc, then selected by the mask (one branch a warp: the exp2 of
    // a tile stay one straight run). Column 8j + 2t (+1) is a query, row k0
    // / k1 a key.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + j * 8 + 2 * t);
      const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j * 4 + e] = ex2(fmaf(sc[j * 4 + e], sl2, nl[e & 1]));
    }
    if (!clean) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const int query = m0 + col, key = e < 2 ? k0 : k1;
          bool ok = query < p.sq && key < p.sk;
          if (p.causal) ok = ok && key <= query;
          if (seg) {
            const int qv = qseg_s[col];
            ok = ok && qv != 0 && qv == (e < 2 ? sg.s0 : sg.s1);
          }
          sc[j * 4 + e] = ok ? sc[j * 4 + e] : 0.f;
        }
      }
    }
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[kk * 8 + 2 * i], sc[kk * 8 + 2 * i + 1]);
    }
    // dV += P^T dO over the tile's queries, 16 a step.
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Wgmma<DV>::rs(dv, pa[kk], desc_mn_major(do_s + kk * 16 * 128, BQ * 128));
    }
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed; dV's product may still run
    fence_regs(dpt);

    // ds = p (dp - delta) scale into dpt.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[j * 4 + e] = sc[j * 4 + e] * (dpt[j * 4 + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
    }
    uint32_t da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        da[kk][i] = pack_bf16(dpt[kk * 8 + 2 * i], dpt[kk * 8 + 2 * i + 1]);
      }
    }
    // dK += dS^T Q over the tile's queries.
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Wgmma<DV>::rs(dk, da[kk], desc_mn_major(q_s + kk * 16 * 128, BQ * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  }

  __nv_bfloat16* dkb = p.dk + (long)b * p.sk * kv_rs + (long)hk * p.d;
  __nv_bfloat16* dvb = p.dv + (long)b * p.sk * kv_rs + (long)hk * p.d;
  if (c == 1) {  // the whole group in this CTA: straight to the output
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < p.d) {
        if (k0 < p.sk) {
          *reinterpret_cast<uint32_t*>(dkb + k0 * kv_rs + col) =
              pack_bf16(dk[j * 4], dk[j * 4 + 1]);
          *reinterpret_cast<uint32_t*>(dvb + k0 * kv_rs + col) =
              pack_bf16(dv[j * 4], dv[j * 4 + 1]);
        }
        if (k1 < p.sk) {
          *reinterpret_cast<uint32_t*>(dkb + k1 * kv_rs + col) =
              pack_bf16(dk[j * 4 + 2], dk[j * 4 + 3]);
          *reinterpret_cast<uint32_t*>(dvb + k1 * kv_rs + col) =
              pack_bf16(dv[j * 4 + 2], dv[j * 4 + 3]);
        }
      }
    }
    return;
  }

  // The cluster's sum. Every product of this CTA is done, so K, V and the
  // ring are free: f32 dK, then dV, [128, DV] each, from the start.
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  const int kr = wg * 64 + warp * 16 + g;  // this thread's first key, within the tile
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = j * 8 + 2 * t;
    *reinterpret_cast<float2*>(part + kr * DV + col) = make_float2(dk[j * 4], dk[j * 4 + 1]);
    *reinterpret_cast<float2*>(part + (kr + 8) * DV + col) =
        make_float2(dk[j * 4 + 2], dk[j * 4 + 3]);
    *reinterpret_cast<float2*>(part + (128 + kr) * DV + col) =
        make_float2(dv[j * 4], dv[j * 4 + 1]);
    *reinterpret_cast<float2*>(part + (136 + kr) * DV + col) =
        make_float2(dv[j * 4 + 2], dv[j * 4 + 3]);
  }
  cluster_sync();
  // Rank r sums pairs [r P / c, (r + 1) P / c) of the P = 128 DV float pairs
  // of dK and dV over ranks 0..c-1, in rank order.
  constexpr int kPairs = 128 * DV;
  const int end = (rank + 1) * kPairs / c;
  for (int i = rank * kPairs / c + threadIdx.x; i < end; i += kThreads) {
    const uint32_t addr = sbase + i * 8;
    float2 x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < c) x[r] = ld_cluster_f2(addr, r);
    }
    float2 sum = x[0];
#pragma unroll
    for (int r = 1; r < 8; ++r) {
      if (r < c) {
        sum.x += x[r].x;
        sum.y += x[r].y;
      }
    }
    const int e = 2 * i, rem = e % (128 * DV), row = rem / DV, col = rem % DV;
    const int key = n0 + row;
    if (key < p.sk && col < p.d) {
      __nv_bfloat16* out = e < 128 * DV ? dkb : dvb;
      *reinterpret_cast<uint32_t*>(out + key * kv_rs + col) = pack_bf16(sum.x, sum.y);
    }
  }
  cluster_sync();  // no CTA leaves while another still reads its shared memory
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Sets a kernel's dynamic shared memory limit once per device, before its
// first launch (never inside a graph capture that follows).
cudaError_t smem_once(const void* kernel, int bytes, std::mutex& mu, bool (&ready)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

// The tensor maps where the copies are TMA boxes: q and do in boxes of
// `q_rows` rows, k and v of `k_rows`.
cudaError_t encode_maps(Params& p, int b, int q_rows, int k_rows) {
  if (!p.tma) return cudaSuccess;
  cudaError_t err = encode(&p.tq, p.q, b, p.sq, p.h, p.d, q_rows);
  if (err == cudaSuccess) err = encode(&p.tdo, p.dout, b, p.sq, p.h, p.d, q_rows);
  if (err == cudaSuccess) err = encode(&p.tk, p.k, b, p.sk, p.hkv, p.d, k_rows);
  if (err == cudaSuccess) err = encode(&p.tv, p.v, b, p.sk, p.hkv, p.d, k_rows);
  return err;
}

template <int DP, int DV>
cudaError_t launch_dq(Params p, int b, cudaStream_t stream) {
  constexpr int kBytes = DqSmem<DP>::kBytes;
  static std::mutex mu;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = encode_maps(p, b, 128, DqCfg<DP>::BN);
  if (err != cudaSuccess) return err;
  err = smem_once(reinterpret_cast<const void*>(bwd_dq_kernel<DP, DV>), kBytes, mu, ready);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<DP, DV><<<dim3(p.h, (p.sq + 127) / 128, b), kThreads, kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, int DV>
cudaError_t launch_dkv(Params p, int b, cudaStream_t stream) {
  constexpr int kBytes = DkvSmem<DP>::kBytes;
  static std::mutex mu;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = encode_maps(p, b, DkvCfg<DP>::BQ, 128);
  if (err != cudaSuccess) return err;
  err = smem_once(reinterpret_cast<const void*>(bwd_dkv_kernel<DP, DV>), kBytes, mu, ready);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.hkv * p.cluster, (p.sk + 127) / 128, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_dkv_kernel<DP, DV>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The CTAs a GQA group of g query heads is split over: the largest divisor
// of g that is at most 8, the portable cluster size (1 for a prime g > 8:
// one CTA walks the whole group).
int cluster_size(int g) {
  for (int c = 8; c > 1; --c) {
    if (g % c == 0) return c;
  }
  return 1;
}

template <bool DKV>
cudaError_t dispatch(Params p, int b, cudaStream_t stream) {
  if (p.d <= 0 || p.d % 2 != 0 || p.d > 128 || p.hkv <= 0 || p.h % p.hkv != 0 || b <= 0 ||
      p.sq <= 0 || p.sk <= 0) {
    return cudaErrorInvalidValue;
  }
  p.cluster = cluster_size(p.h / p.hkv);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                         reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.dout);
  p.tma = p.d % 8 == 0 && addr % 16 == 0;
  if constexpr (DKV) {
    if (p.d <= 32) return launch_dkv<32, 32>(p, b, stream);
    if (p.d <= 64) return launch_dkv<64, 64>(p, b, stream);
    if (p.d <= 72) return launch_dkv<80, 72>(p, b, stream);
    return launch_dkv<128, 128>(p, b, stream);
  } else {
    if (p.d <= 32) return launch_dq<32, 32>(p, b, stream);
    if (p.d <= 64) return launch_dq<64, 64>(p, b, stream);
    if (p.d <= 72) return launch_dq<80, 72>(p, b, stream);
    return launch_dq<128, 128>(p, b, stream);
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* qseg,
                   const void* kseg, const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int sq, int sk, int h, int hkv, int d,
                   int causal, float scale) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.hkv = hkv;
  p.d = d;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal != 0;
  return p;
}

}  // namespace
}  // namespace radvlm

// K7: dk, dv [B, Sk, Hkv, D] (every element written).
extern "C" int radvlm_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* qseg, const void* kseg,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int b,
                                              int sq, int sk, int h, int hkv, int d, int causal,
                                              float scale, void* stream) {
  using namespace radvlm;
  if ((qseg == nullptr) != (kseg == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, qseg, kseg, dout, lse, delta, nullptr, dk, dv, sq, sk,
                               h, hkv, d, causal, scale);
  return static_cast<int>(dispatch<true>(p, b, static_cast<cudaStream_t>(stream)));
}

// K8: dq [B, Sq, H, D] (every element written).
extern "C" int radvlm_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* qseg, const void* kseg,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, int b, int sq, int sk,
                                             int h, int hkv, int d, int causal, float scale,
                                             void* stream) {
  using namespace radvlm;
  if ((qseg == nullptr) != (kseg == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, qseg, kseg, dout, lse, delta, dq, nullptr, nullptr, sq,
                               sk, h, hkv, d, causal, scale);
  return static_cast<int>(dispatch<false>(p, b, static_cast<cudaStream_t>(stream)));
}
