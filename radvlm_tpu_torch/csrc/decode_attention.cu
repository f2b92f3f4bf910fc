// K9: single-token GQA decode attention over one layer of the bf16 KV cache,
// for Hopper (sm_90a), written by hand. K4, its counterpart over the int8
// cache, shares the grid and the combine kernel (decode_partial_q8_kernel
// and radvlm_decode_attention_q8 below), and so do K10 and K11, the verify
// windows of speculative decoding over the two caches
// (decode_window_partial_kernel and radvlm_decode_attention_window[_q8]).
//
// Replaces the Pallas TPU kernel radvlm_tpu/ops/decode_attention.py
// decode_attention_stacked / _fused_heads_kernel: one query token per row,
// all heads, scores over the [B, Smax, Hkv*D] cache of one layer, slots whose
// segment id is 0 masked, online softmax over blocks of S.
//
// What bounds it on the H100: device-memory bandwidth. Each step reads the
// written part of the layer's K and V once (B * Smax * Hkv * D * 2 bytes
// each at most) and does ~2 flops per byte. With one CTA per (row, kv
// head), as the TPU grid has, B * Hkv is 4-16 CTAs on 132 SMs and the card
// idles. So S is split across CTAs (flash-decoding): grid (nsplit, B *
// Hkv), each CTA runs an online softmax over its chunk and writes f32
// partials (max, sum, unnormalised output); a second small kernel combines
// the partials per (row, head). One CTA serves the g = H / Hkv query heads
// of one kv head, so each K/V byte is read once. At W = 1 the tensor cores
// are not the lever, bytes in flight are: K9 keeps a ring of three 64-key
// K/V stages in flight (16-byte cp.async where it can), loads only the
// tiles that hold a visible key (left padding and the unwritten tail are
// skipped), and spreads scores and PV over 256 threads (design note at
// decode_partial_kernel). Its per-row arithmetic is K10's, through shared
// helpers, so a verify window's row equals K9 bit for bit.
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
#include "wgmma.cuh"

#include <math.h>

#include <type_traits>

namespace radvlm {
namespace {

constexpr int kTile = 64;  // keys per shared-memory tile (two per lane)
constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;
constexpr int kMaxD = 128;
constexpr int kLds = kMaxD + 2;  // 65 words a row: column reads are conflict-free

// The per-row arithmetic K9 and K10 share (K11 shares the last two with
// K4's inline copy, which computes the same operations): a query row's
// running max m and sum l, and its f32 output, over 64-key tiles in key
// order. A row of a K10 window equals K9 over the keys the row sees because
// both kernels go through these helpers in the same order: explicit
// __fmaf_rn / __fmul_rn, so no contraction choice of the compiler can differ.

// dot += q0 * k[c] + q1 * k[c + 1] as two fused steps, c then c + 1; `k2`
// holds the two bf16 values (k[c] in the low half).
__device__ __forceinline__ float dot2(float dot, float q0, float q1, uint32_t k2) {
  dot = __fmaf_rn(q0, __uint_as_float(k2 << 16), dot);
  return __fmaf_rn(q1, __uint_as_float(k2 & 0xffff0000u), dot);
}

// One 64-key softmax step of one row, by one warp: x0 / x1 are the scores of
// keys lane and lane + 32 (-inf where masked), m_old / l_old the row's
// running max and sum. p0 / p1 are the keys' f32 weights against the new
// max; lane 0's m_new, l_new and alpha (the factor on the old sums) are the
// row's.
__device__ __forceinline__ void softmax_tile(float x0, float x1, float m_old, float l_old,
                                             float scale_log2, float& p0, float& p1,
                                             float& m_new, float& l_new, float& alpha) {
  float mx = fmaxf(x0, x1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  m_new = fmaxf(m_old, mx);
  const float ref = m_new == -INFINITY ? 0.f : m_new;
  p0 = x0 == -INFINITY ? 0.f : exp2f(__fmul_rn(x0 - ref, scale_log2));
  p1 = x1 == -INFINITY ? 0.f : exp2f(__fmul_rn(x1 - ref, scale_log2));
  float sum = p0 + p1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  alpha = exp2f(__fmul_rn(m_old - ref, scale_log2));
  l_new = __fmaf_rn(l_old, alpha, sum);
}

// acc += p * v, one key.
__device__ __forceinline__ float pv_step(float acc, float p, float v) {
  return __fmaf_rn(p, v, acc);
}

// K9. A CTA serves the g query heads of one (row, kv head) over one split's
// chunk of keys with 256 threads and a ring of kStages 64-key
// stages (K, V and the keys' segment ids) that every thread fills with
// cp.async: 16-byte copies where D % 8 == 0 and the cache is 16-byte
// aligned (kVec16), 4-byte ones elsewhere, zeros past S and past D. A
// first pass over the chunk's segment ids marks the tiles that hold a
// visible key; only those are loaded and computed (a wholly masked tile
// leaves m, l and o as they are: alpha = 1 and p = 0, or everything still
// 0 while m = -inf). Scores: thread -> key tid % 64 and heads tid / 64 and
// tid / 64 + 4, K read 16 bytes at a time, q broadcast from shared memory.
// Softmax: one warp a head. PV: thread -> columns 2 (tid % 64), + 1 and the
// same two heads, the sums in registers.
constexpr int kK9Threads = 256;
constexpr int kStages = 3;  // the ring's depth, all of it in flight before the first tile
constexpr int kMaxVisTiles = 1024;  // chunks beyond 65536 keys: later tiles are not skipped

// Shared memory of K9 at head dims padded to dp (a multiple of 16).
struct K9Smem {
  int row;    // bytes a staged K or V row: 16-byte chunks, an odd number of them
  int tile;   // one K or V tile
  int stage;  // K, V, segment ids
  int qs, sc, ml, vis, bytes;
  __host__ __device__ explicit K9Smem(int dp) {
    row = dp * 2 + 16;
    tile = kTile * row;
    stage = 2 * tile + kTile * 4;
    qs = kStages * stage;
    sc = qs + kMaxGroup * dp * 4;
    ml = sc + kMaxGroup * kTile * 4;
    vis = ml + 3 * kMaxGroup * 4;
    bytes = vis + kMaxVisTiles;
  }
};

__device__ __forceinline__ void cp_async16z(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// kDP: the padded head dim where it is fixed at compile time (0: d's).
template <bool kVec16, int kDP>
__global__ void __launch_bounds__(kK9Threads, 2) decode_partial_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, H, D]
    const __nv_bfloat16* __restrict__ ck,  // [B, S, Hkv * D], one layer
    const __nv_bfloat16* __restrict__ cv,
    const int* __restrict__ seg,  // [B, S]
    float* __restrict__ part_o,   // [B, H, nsplit, D]
    float* __restrict__ part_ml,  // [B, H, nsplit, 2]: max, sum
    int s, int hkv, int group, int d, int chunk, float scale_log2) {
  extern __shared__ __align__(16) uint8_t k9_smem[];
  const int dp = kDP > 0 ? kDP : (d + 15) / 16 * 16;
  const K9Smem L(dp);
  const uint32_t sbase = smem_u32(k9_smem);
  float* qs = reinterpret_cast<float*>(k9_smem + L.qs);  // [kMaxGroup][dp]
  float* sc = reinterpret_cast<float*>(k9_smem + L.sc);  // [kMaxGroup][kTile]
  float* m_s = reinterpret_cast<float*>(k9_smem + L.ml);
  float* l_s = m_s + kMaxGroup;
  float* alpha_s = l_s + kMaxGroup;
  uint8_t* vis = k9_smem + L.vis;  // a tile holds a visible key

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / hkv, kvh = blockIdx.y % hkv;
  const int h = hkv * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long hd = (long)hkv * d;
  const __nv_bfloat16* kb = ck + (long)b * s * hd + (long)kvh * d;
  const __nv_bfloat16* vb = cv + (long)b * s * hd + (long)kvh * d;
  const int* sb = seg + (long)b * s;
  const int c0 = split * chunk, c1 = min(s, c0 + chunk);
  const int n_tiles = c0 < c1 ? (c1 - c0 + kTile - 1) / kTile : 0;

#pragma unroll 4
  for (int i = tid; i < kMaxGroup * dp; i += kK9Threads) {
    const int hh = i / dp, dd = i % dp;
    qs[i] = hh < group && dd < d ? __bfloat162float(q[((long)b * h + kvh * group + hh) * d + dd])
                                 : 0.f;
  }
  if (tid < kMaxGroup) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // The visible tiles, in the same phase as q: warp w ballots tiles w, w +
  // 8, ... (tiles past kMaxVisTiles count as visible).
  for (int t = warp; t < min(n_tiles, kMaxVisTiles); t += kK9Threads / 32) {
    const int k0 = c0 + t * kTile + lane, k1 = k0 + 32;
    const bool any =
        __any_sync(0xffffffffu, (k0 < c1 && sb[k0] != 0) || (k1 < c1 && sb[k1] != 0));
    if (lane == 0) vis[t] = any;
  }
  __syncthreads();
  // The first visible tile at or after t (n_tiles if none).
  auto next_visible = [&](int t) {
    while (t < n_tiles && t < kMaxVisTiles && !vis[t]) ++t;
    return t;
  };

  // Tile t into stage st: one commit group a call (empty past the last).
  auto issue = [&](int t, int st) {
    if (t < n_tiles) {
      const int n0 = c0 + t * kTile;
      const uint32_t kst = sbase + st * L.stage, vst = kst + L.tile;
      if (kVec16) {
        const int vecs = dp / 8;
        for (int i = tid; i < kTile * vecs; i += kK9Threads) {
          const int r = i / vecs, c = (i % vecs) * 8;
          const bool ok = n0 + r < c1 && c < d;
          const long off = ok ? (long)(n0 + r) * hd + c : 0;
          cp_async16z(kst + r * L.row + c * 2, kb + off, ok);
          cp_async16z(vst + r * L.row + c * 2, vb + off, ok);
        }
      } else {
        const int pairs = dp / 2;
        for (int i = tid; i < kTile * pairs; i += kK9Threads) {
          const int r = i / pairs, c = (i % pairs) * 2;
          const bool ok = n0 + r < c1 && c < d;
          const long off = ok ? (long)(n0 + r) * hd + c : 0;
          cp_async4(kst + r * L.row + c * 2, kb + off, ok);
          cp_async4(vst + r * L.row + c * 2, vb + off, ok);
        }
      }
      if (tid < kTile) {
        const bool ok = n0 + tid < c1;
        cp_async4(vst + L.tile + tid * 4, ok ? sb + n0 + tid : sb, ok);
      }
    }
    cp_async_commit();
  };

  const int key = tid & (kTile - 1), hs = tid >> 6;  // scores: one key, heads hs, hs + 4
  const int cp = tid & 63;                           // PV: columns 2 cp, 2 cp + 1
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  int t_issue = next_visible(0);
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    issue(t_issue, i);
    if (t_issue < n_tiles) t_issue = next_visible(t_issue + 1);
  }
  int i = 0;
  for (int t = next_visible(0); t < n_tiles; t = next_visible(t + 1), ++i) {
    const int st = i % kStages;
    // Tile i is commit group i: the prologue's kStages groups, then one a
    // loop iteration from the second on.
    if (i == 0) {
      cp_async_wait<kStages - 1>();
    } else {
      cp_async_wait<kStages - 2>();
    }
    __syncthreads();  // tile t has landed; the stage of the tile before is consumed
    if (i > 0) {      // that stage takes the next tile
      issue(t_issue, (i - 1) % kStages);
      if (t_issue < n_tiles) t_issue = next_visible(t_issue + 1);
    }

    const uint8_t* krow = k9_smem + st * L.stage + key * L.row;
    const int* seg_s = reinterpret_cast<const int*>(k9_smem + st * L.stage + 2 * L.tile);
    {
      float dot0 = 0.f, dot1 = 0.f;
      const float* q0 = qs + hs * dp;
      const float* q1 = qs + (hs + 4) * dp;
      const bool two = hs + 4 < group;
      if (hs < group) {
#pragma unroll
        for (int c = 0; c < dp; c += 8) {
          const uint4 kv = *reinterpret_cast<const uint4*>(krow + c * 2);
          const float4 a0 = *reinterpret_cast<const float4*>(q0 + c);
          const float4 a1 = *reinterpret_cast<const float4*>(q0 + c + 4);
          dot0 = dot2(dot2(dot2(dot2(dot0, a0.x, a0.y, kv.x), a0.z, a0.w, kv.y), a1.x, a1.y, kv.z),
                      a1.z, a1.w, kv.w);
          if (two) {
            const float4 b0 = *reinterpret_cast<const float4*>(q1 + c);
            const float4 b1 = *reinterpret_cast<const float4*>(q1 + c + 4);
            dot1 = dot2(dot2(dot2(dot2(dot1, b0.x, b0.y, kv.x), b0.z, b0.w, kv.y), b1.x, b1.y,
                             kv.z),
                        b1.z, b1.w, kv.w);
          }
        }
        const bool visible = seg_s[key] != 0;
        sc[hs * kTile + key] = visible ? dot0 : -INFINITY;
        if (two) sc[(hs + 4) * kTile + key] = visible ? dot1 : -INFINITY;
      }
    }
    __syncthreads();
    if (warp < group) {
      float p0, p1, m_new, l_new, alpha;
      softmax_tile(sc[warp * kTile + lane], sc[warp * kTile + lane + 32], m_s[warp], l_s[warp],
                   scale_log2, p0, p1, m_new, l_new, alpha);
      sc[warp * kTile + lane] = p0;
      sc[warp * kTile + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        alpha_s[warp] = alpha;
        l_s[warp] = l_new;
        m_s[warp] = m_new;
      }
    }
    __syncthreads();
    if (2 * cp < d && hs < group) {
      const uint32_t* vcol =
          reinterpret_cast<const uint32_t*>(k9_smem + st * L.stage + L.tile) + cp;
      const bool two = hs + 4 < group;
      const float al0 = alpha_s[hs], al1 = two ? alpha_s[hs + 4] : 1.f;
      acc[0][0] = __fmul_rn(acc[0][0], al0);
      acc[0][1] = __fmul_rn(acc[0][1], al0);
      acc[1][0] = __fmul_rn(acc[1][0], al1);
      acc[1][1] = __fmul_rn(acc[1][1], al1);
      const float* p0 = sc + hs * kTile;
      const float* p1 = sc + (hs + 4) * kTile;
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) {
        const uint32_t v2 = vcol[kk * (L.row / 4)];
        const float v0 = __uint_as_float(v2 << 16), v1 = __uint_as_float(v2 & 0xffff0000u);
        acc[0][0] = pv_step(acc[0][0], p0[kk], v0);
        acc[0][1] = pv_step(acc[0][1], p0[kk], v1);
        if (two) {
          acc[1][0] = pv_step(acc[1][0], p1[kk], v0);
          acc[1][1] = pv_step(acc[1][1], p1[kk], v1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (2 * cp < d) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int hh = hs + 4 * j;
      if (hh < group) {
        const long row = (long)b * h + kvh * group + hh;
        *reinterpret_cast<float2*>(&part_o[(row * nsplit + split) * d + 2 * cp]) =
            make_float2(acc[j][0], acc[j][1]);
      }
    }
  }
  if (tid < group) {
    const long row = (long)b * h + kvh * group + tid;
    part_ml[(row * nsplit + split) * 2 + 0] = m_s[tid];
    part_ml[(row * nsplit + split) * 2 + 1] = l_s[tid];
  }
}

// K4: the same split-S design over the int8 cache (see the note at the
// bottom of this file).
constexpr int kLdQ8 = kMaxD + 4;  // 33 words a row: per-key word reads are conflict-free

__global__ void __launch_bounds__(kThreads) decode_partial_q8_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, D]
    const int8_t* __restrict__ ck,        // [B, S, Hkv * D] int8, one layer
    const int8_t* __restrict__ cv,
    const float* __restrict__ ksc,  // [B, Hkv, S] per-(token, kv-head) scales
    const float* __restrict__ vsc,
    const int* __restrict__ seg,  // [B, S]
    float* __restrict__ part_o,   // [B, H, nsplit, D]
    float* __restrict__ part_ml,  // [B, H, nsplit, 2]: max, sum
    int s, int hkv, int group, int d, int chunk, float scale_log2) {
  __shared__ float qs[kMaxGroup][kMaxD];
  __shared__ __align__(16) int8_t kt[kTile * kLdQ8];
  __shared__ __align__(16) int8_t vt[kTile * kLdQ8];
  __shared__ float sc[kMaxGroup][kTile];
  __shared__ float ks_s[kTile], vs_s[kTile];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];
  __shared__ int seg_s[kTile];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / hkv, kvh = blockIdx.y % hkv;
  const int h = hkv * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long hd = static_cast<long>(hkv) * d;
  const int8_t* kb = ck + static_cast<long>(b) * s * hd + static_cast<long>(kvh) * d;
  const int8_t* vb = cv + static_cast<long>(b) * s * hd + static_cast<long>(kvh) * d;
  const float* ksb = ksc + (static_cast<long>(b) * hkv + kvh) * s;
  const float* vsb = vsc + (static_cast<long>(b) * hkv + kvh) * s;
  const int* sb = seg + static_cast<long>(b) * s;

  for (int i = tid; i < group * d; i += kThreads) {
    const int hh = i / d, dd = i % d;
    qs[hh][dd] = __bfloat162float(q[(static_cast<long>(b) * h + kvh * group + hh) * d + dd]);
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
    // 16-byte loads of int8 K/V (D is a multiple of 16), stored as words.
    const int vecs = d / 16;
    for (int i = tid; i < kTile * vecs; i += kThreads) {
      const int r = i / vecs, c = (i % vecs) * 16;
      const int key = n0 + r;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (key < c1) {
        kk = *reinterpret_cast<const uint4*>(kb + key * hd + c);
        vv = *reinterpret_cast<const uint4*>(vb + key * hd + c);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(&kt[r * kLdQ8 + c]);
      uint32_t* vd = reinterpret_cast<uint32_t*>(&vt[r * kLdQ8 + c]);
      kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    if (tid < kTile) {
      const bool in = n0 + tid < c1;
      seg_s[tid] = in ? sb[n0 + tid] : 0;
      ks_s[tid] = in ? ksb[n0 + tid] : 0.f;
      vs_s[tid] = in ? vsb[n0 + tid] : 0.f;
    }
    __syncthreads();

    // Scores (q . k_int8) * ks[key]: thread -> key tid % 64, heads tid / 64 + 2i.
    {
      const int key = tid % kTile, h0 = tid / kTile;
      float dot[kMaxGroup / 2];
#pragma unroll
      for (int i = 0; i < kMaxGroup / 2; ++i) dot[i] = 0.f;
      const int8_t* krow = &kt[key * kLdQ8];
      for (int c = 0; c < d; c += 4) {
        const char4 k4 = *reinterpret_cast<const char4*>(krow + c);
        const float k0 = k4.x, k1 = k4.y, k2 = k4.z, k3 = k4.w;
#pragma unroll
        for (int i = 0; i < kMaxGroup / 2; ++i) {
          const int hh = h0 + 2 * i;
          if (hh < group) {
            dot[i] += qs[hh][c] * k0 + qs[hh][c + 1] * k1 + qs[hh][c + 2] * k2 +
                      qs[hh][c + 3] * k3;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxGroup / 2; ++i) {
        const int hh = h0 + 2 * i;
        if (hh < group) sc[hh][key] = seg_s[key] != 0 ? dot[i] * ks_s[key] : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax, one warp per head; p * vs[key] goes into the PV sum.
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
      sc[hh][lane] = p0 * vs_s[lane];
      sc[hh][lane + 32] = p1 * vs_s[lane + 32];
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

    // O = alpha * O + (p * vs) V_int8: thread -> output column tid, all heads.
    if (tid < d) {
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        if (i < group) acc[i] *= alpha_s[i];
      }
      for (int key = 0; key < kTile; ++key) {
        const float vv = static_cast<float>(vt[key * kLdQ8 + tid]);
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
        const long row = static_cast<long>(b) * h + kvh * group + i;
        part_o[(row * nsplit + split) * d + tid] = acc[i];
      }
    }
  }
  if (tid < group) {
    const long row = static_cast<long>(b) * h + kvh * group + tid;
    part_ml[(row * nsplit + split) * 2 + 0] = m_s[tid];
    part_ml[(row * nsplit + split) * 2 + 1] = l_s[tid];
  }
}

// K10 / K11: the verify window of speculative decoding, W = spec_k + 1 queries
// per slot over the bf16 (K10) or int8 (K11) cache; see the note at the
// bottom of this file. One CTA holds the W * g query rows of one (slot, kv
// head, key split): each staged K/V tile serves all of them.
constexpr int kMaxWindow = 16;
constexpr int kMaxRows = kMaxWindow * kMaxGroup;

template <bool kQ8>
constexpr int window_smem_bytes(int rows) {
  return 2 * kTile * (kQ8 ? kLdQ8 : kLds * 2) +
         (2 * rows * kMaxD + rows * kTile + 3 * rows + 2 * kTile + kTile) * 4;
}

template <bool kQ8>
__global__ void __launch_bounds__(kThreads) decode_window_partial_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, W, H, D]
    const void* __restrict__ ck_raw,      // [B, S, Hkv * D] bf16 or int8, one layer
    const void* __restrict__ cv_raw,
    const float* __restrict__ ksc,  // [B, Hkv, S] (int8 cache only)
    const float* __restrict__ vsc,
    const int* __restrict__ seg,   // [B, S]
    const int* __restrict__ widx,  // [B] cache index of window row 0
    float* __restrict__ part_o,    // [B, W, H, nsplit, D]
    float* __restrict__ part_ml,   // [B, W, H, nsplit, 2]: max, sum
    int s, int hkv, int group, int d, int w, int chunk, float scale_log2) {
  using KV = std::conditional_t<kQ8, int8_t, __nv_bfloat16>;
  constexpr int kLd = kQ8 ? kLdQ8 : kLds;
  extern __shared__ __align__(16) unsigned char window_smem[];
  const int rows = w * group;  // row r = window row r / group, head r % group
  KV* kt = reinterpret_cast<KV*>(window_smem);
  KV* vt = kt + kTile * kLd;
  float* qs = reinterpret_cast<float*>(vt + kTile * kLd);  // [rows][kMaxD]
  float* acc_s = qs + rows * kMaxD;                        // [rows][kMaxD]
  float* sc = acc_s + rows * kMaxD;                        // [rows][kTile]
  float* m_s = sc + rows * kTile;
  float* l_s = m_s + rows;
  float* alpha_s = l_s + rows;
  float* ks_s = alpha_s + rows;
  float* vs_s = ks_s + kTile;
  int* seg_s = reinterpret_cast<int*>(vs_s + kTile);

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / hkv, kvh = blockIdx.y % hkv;
  const int h = hkv * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long hd = static_cast<long>(hkv) * d;
  const KV* kb = static_cast<const KV*>(ck_raw) + static_cast<long>(b) * s * hd +
                 static_cast<long>(kvh) * d;
  const KV* vb = static_cast<const KV*>(cv_raw) + static_cast<long>(b) * s * hd +
                 static_cast<long>(kvh) * d;
  const float* ksb = kQ8 ? ksc + (static_cast<long>(b) * hkv + kvh) * s : nullptr;
  const float* vsb = kQ8 ? vsc + (static_cast<long>(b) * hkv + kvh) * s : nullptr;
  const int* sb = seg + static_cast<long>(b) * s;
  const int wi = widx[b];

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, dd = i % d;
    const long qrow = (static_cast<long>(b) * w + r / group) * h + kvh * group + r % group;
    qs[r * kMaxD + dd] = __bfloat162float(q[qrow * d + dd]);
    acc_s[r * kMaxD + dd] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // No query of the window sees a key past wi + w - 1: the loop ends there,
  // and a split that lies wholly above it writes m = -inf, l = 0, o = 0.
  const int c0 = split * chunk, c1 = min(min(s, c0 + chunk), wi + w);
  for (int n0 = c0; n0 < c1; n0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    if constexpr (kQ8) {
      const int vecs = d / 16;
      for (int i = tid; i < kTile * vecs; i += kThreads) {
        const int r = i / vecs, c = (i % vecs) * 16;
        const int key = n0 + r;
        uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
        if (key < c1) {
          kk = *reinterpret_cast<const uint4*>(kb + key * hd + c);
          vv = *reinterpret_cast<const uint4*>(vb + key * hd + c);
        }
        uint32_t* kd = reinterpret_cast<uint32_t*>(&kt[r * kLd + c]);
        uint32_t* vd = reinterpret_cast<uint32_t*>(&vt[r * kLd + c]);
        kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
        vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
      }
    } else {
      for (int i = tid; i < kTile * (d / 2); i += kThreads) {
        const int r = i / (d / 2), c = (i % (d / 2)) * 2;
        const int key = n0 + r;
        uint32_t kk = 0u, vv = 0u;
        if (key < c1) {
          kk = *reinterpret_cast<const uint32_t*>(kb + key * hd + c);
          vv = *reinterpret_cast<const uint32_t*>(vb + key * hd + c);
        }
        *reinterpret_cast<uint32_t*>(&kt[r * kLd + c]) = kk;
        *reinterpret_cast<uint32_t*>(&vt[r * kLd + c]) = vv;
      }
    }
    if (tid < kTile) {
      const bool in = n0 + tid < c1;
      seg_s[tid] = in ? sb[n0 + tid] : 0;
      if constexpr (kQ8) {
        ks_s[tid] = in ? ksb[n0 + tid] : 0.f;
        vs_s[tid] = in ? vsb[n0 + tid] : 0.f;
      }
    }
    __syncthreads();

    // Scores, one window row at a time with K9's / K4's arithmetic: thread ->
    // key tid % 64, heads tid / 64 + 2i. Window row ww sees keys <= wi + ww.
    for (int ww = 0; ww < w; ++ww) {
      const int key = tid % kTile, h0 = tid / kTile;
      const float* qw = qs + ww * group * kMaxD;
      float dot[kMaxGroup / 2];
#pragma unroll
      for (int i = 0; i < kMaxGroup / 2; ++i) dot[i] = 0.f;
      const KV* krow = &kt[key * kLd];
      if constexpr (kQ8) {
        for (int c = 0; c < d; c += 4) {
          const char4 k4 = *reinterpret_cast<const char4*>(krow + c);
          const float k0 = k4.x, k1 = k4.y, k2 = k4.z, k3 = k4.w;
#pragma unroll
          for (int i = 0; i < kMaxGroup / 2; ++i) {
            const int hh = h0 + 2 * i;
            if (hh < group) {
              const float* qh = qw + hh * kMaxD;
              dot[i] += qh[c] * k0 + qh[c + 1] * k1 + qh[c + 2] * k2 + qh[c + 3] * k3;
            }
          }
        }
      } else {
        for (int c = 0; c < d; c += 2) {
          const uint32_t k2 = *reinterpret_cast<const uint32_t*>(krow + c);
#pragma unroll
          for (int i = 0; i < kMaxGroup / 2; ++i) {
            const int hh = h0 + 2 * i;
            if (hh < group) {
              const float* qh = qw + hh * kMaxD;
              dot[i] = dot2(dot[i], qh[c], qh[c + 1], k2);
            }
          }
        }
      }
      // A masked key's score never touches its scale: the scales above the
      // accepted prefix are stale.
      const bool visible = seg_s[key] != 0 && n0 + key <= wi + ww;
#pragma unroll
      for (int i = 0; i < kMaxGroup / 2; ++i) {
        const int hh = h0 + 2 * i;
        if (hh < group) {
          float x = -INFINITY;
          if (visible) x = kQ8 ? dot[i] * ks_s[key] : dot[i];
          sc[(ww * group + hh) * kTile + key] = x;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per row. p is masked, not the product p * vs.
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* sr = sc + r * kTile;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      float p0, p1, m_new, l_new, alpha;
      softmax_tile(x0, x1, m_s[r], l_s[r], scale_log2, p0, p1, m_new, l_new, alpha);
      if constexpr (kQ8) {
        sr[lane] = x0 == -INFINITY ? 0.f : p0 * vs_s[lane];
        sr[lane + 32] = x1 == -INFINITY ? 0.f : p1 * vs_s[lane + 32];
      } else {
        sr[lane] = p0;
        sr[lane + 32] = p1;
      }
      __syncwarp();
      if (lane == 0) {
        alpha_s[r] = alpha;
        l_s[r] = l_new;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V: thread -> output column tid; the g heads of one
    // window row at a time in registers, the running sums in shared memory
    // (each thread reads and writes only its own column).
    if (tid < d) {
      for (int ww = 0; ww < w; ++ww) {
        float acc[kMaxGroup];
#pragma unroll
        for (int i = 0; i < kMaxGroup; ++i) {
          if (i < group) {
            acc[i] = __fmul_rn(acc_s[(ww * group + i) * kMaxD + tid], alpha_s[ww * group + i]);
          }
        }
        const float* sw = sc + ww * group * kTile;
        for (int key = 0; key < kTile; ++key) {
          float vv;
          if constexpr (kQ8) {
            vv = static_cast<float>(vt[key * kLd + tid]);
          } else {
            vv = __bfloat162float(vt[key * kLd + tid]);
          }
#pragma unroll
          for (int i = 0; i < kMaxGroup; ++i) {
            if (i < group) acc[i] = pv_step(acc[i], sw[i * kTile + key], vv);
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxGroup; ++i) {
          if (i < group) acc_s[(ww * group + i) * kMaxD + tid] = acc[i];
        }
      }
    }
  }
  __syncthreads();
  for (int r = 0; r < rows; ++r) {
    const long row = (static_cast<long>(b) * w + r / group) * h + kvh * group + r % group;
    if (tid < d) part_o[(row * nsplit + split) * d + tid] = acc_s[r * kMaxD + tid];
    if (tid == 0) {
      part_ml[(row * nsplit + split) * 2 + 0] = m_s[r];
      part_ml[(row * nsplit + split) * 2 + 1] = l_s[r];
    }
  }
}

// The split combine of K9, K4, K10 and K11: per (row, head), the f32
// partials of the nsplit key chunks, in split order: m = max m_i, w_i =
// 2^((m_i - m) * scale_log2), l = sum l_i w_i, o = sum o_i w_i / l (0 where
// l = 0). The w_i go through shared memory and each column's loads are
// issued eight at a time; the sums keep their order.
constexpr int kCombineThreads = 128;  // one a column (D <= 128)

__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int nsplit, int d, float scale_log2) {
  __shared__ float w_s[kCombineThreads];
  __shared__ float red[kCombineThreads / 32];
  __shared__ float l_s;
  const long row = blockIdx.x;  // b * H + h
  const int tid = threadIdx.x;
  const float* ml = part_ml + row * nsplit * 2;
  float mx = -INFINITY;
  for (int i = tid; i < nsplit; i += kCombineThreads) mx = fmaxf(mx, ml[2 * i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCombineThreads / 32; ++i) mx = fmaxf(mx, red[i]);
  const float ref = mx == -INFINITY ? 0.f : mx;
  float l = 0.f, o = 0.f;
  const float* po = part_o + row * nsplit * d + tid;
  for (int base = 0; base < nsplit; base += kCombineThreads) {
    const int n = min(kCombineThreads, nsplit - base);
    __syncthreads();  // the previous chunk's weights are consumed
    if (tid < n) w_s[tid] = exp2f((ml[2 * (base + tid)] - ref) * scale_log2);
    __syncthreads();
    if (tid == 0) {
#pragma unroll 8
      for (int j = 0; j < n; ++j) l = __fmaf_rn(ml[2 * (base + j) + 1], w_s[j], l);
    }
    if (tid < d) {
#pragma unroll 8
      for (int j = 0; j < n; ++j) o = __fmaf_rn(po[(long)(base + j) * d], w_s[j], o);
    }
  }
  if (tid == 0) l_s = l;
  __syncthreads();
  l = l_s;
  if (tid < d) out[row * d + tid] = __float2bfloat16(l > 0.f ? o / l : 0.f);
}

constexpr float kLog2e = 1.4426950408889634f;

template <bool kQ8>
int launch_window(const void* q, const void* ck, const void* cv, const void* ksc,
                  const void* vsc, const void* seg, const void* widx, void* part_o,
                  void* part_ml, void* out, int b, int s, int h, int hkv, int d, int w,
                  int nsplit, int chunk, float scale, void* stream) {
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxD ||
      d % (kQ8 ? 16 : 2) != 0 || w < 1 || w > kMaxWindow || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Above 48 KB the shared memory is dynamic and opted into, once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_window_partial_kernel<kQ8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      window_smem_bytes<kQ8>(kMaxRows));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  const int group = h / hkv;
  decode_window_partial_kernel<kQ8>
      <<<dim3(nsplit, b * hkv), kThreads, window_smem_bytes<kQ8>(w * group), st>>>(
          static_cast<const __nv_bfloat16*>(q), ck, cv, static_cast<const float*>(ksc),
          static_cast<const float*>(vsc), static_cast<const int*>(seg),
          static_cast<const int*>(widx), static_cast<float*>(part_o),
          static_cast<float*>(part_ml), s, hkv, group, d, w, chunk, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<b * w * h, kCombineThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), nsplit, d, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

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
  using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                         const int*, float*, float*, int, int, int, int, int, float);
  // The Qwen2 head dims at compile time; others, and unaligned caches, at
  // run time.
  const Kernel kernels[4] = {decode_partial_kernel<true, 128>, decode_partial_kernel<true, 64>,
                             decode_partial_kernel<true, 0>, decode_partial_kernel<false, 0>};
  // Above 48 KB the shared memory is dynamic and opted into, once.
  static const cudaError_t attr = [&] {
    for (Kernel k : kernels) {
      const cudaError_t a = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, K9Smem(kMaxD).bytes);
      if (a != cudaSuccess) return a;
    }
    return cudaSuccess;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec16 = d % 8 == 0 && reinterpret_cast<uintptr_t>(ck) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cv) % 16 == 0;
  const Kernel kernel = !vec16 ? kernels[3] : d == 128 ? kernels[0] : d == 64 ? kernels[1]
                                                                              : kernels[2];
  kernel<<<dim3(nsplit, b * hkv), kK9Threads, K9Smem((d + 15) / 16 * 16).bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(cv), static_cast<const int*>(seg),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), s, hkv,
      h / hkv, d, chunk, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<b * h, kCombineThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), nsplit, d, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// K4: single-token GQA decode attention over one layer of the int8 KV cache.
//
// Replaces the Pallas TPU kernel radvlm_tpu/ops/decode_attention.py
// decode_attention_stacked_q8 / _fused_heads_q8_kernel. The cache is int8
// [B, Smax, Hkv*D] with one f32 scale per (token, kv head), [B, Hkv, Smax];
// dequantization folds into the math, as on the TPU: the score of key t is
// (q . k_t) * ks[t] * scale, and p_t * vs[t] multiplies the raw int8 V row.
//
// What bounds it: device-memory bandwidth, half the bytes of K9 per key
// (plus 8 bytes of scales per key and kv head). Same split-S grid and
// combine kernel as K9; K/V tiles come in with 16-byte loads.
//
// Choices against the TPU kernel:
// - p * vs stays f32 in the PV sum (the TPU kernel rounds it to bf16 before
//   its bf16 PV matmul); the plain version does the same;
// - p = 0 where the slot's segment is 0, and a row with no written slot gives
//   o = 0 (the TPU kernel's finite mask value gives mean(v) there);
// - slots of a batch decode at different write indices: only the segment
//   ids mask, as on the TPU.
//
// Limits: D a multiple of 16 and <= 128, H / Hkv <= 8.
extern "C" int radvlm_decode_attention_q8(const void* q, const void* ck, const void* cv,
                                          const void* ksc, const void* vsc,
                                          const void* seg, void* part_o, void* part_ml,
                                          void* out, int b, int s, int h, int hkv,
                                          int d, int nsplit, int chunk, float scale,
                                          void* stream) {
  using namespace radvlm;
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxD ||
      d % 16 != 0 || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  decode_partial_q8_kernel<<<dim3(nsplit, b * hkv), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(ck),
      static_cast<const int8_t*>(cv), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(seg),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), s, hkv, h / hkv, d,
      chunk, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<b * h, kCombineThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), nsplit, d, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// K10 / K11: the verify window of speculative decoding. W = spec_k + 1
// queries per slot attend one layer of the bf16 (K10) or int8 (K11) cache:
// query j of slot b sits at cache index widx[b] + j and sees the keys at
// indices <= widx[b] + j whose segment id is not 0.
//
// Replace the Pallas TPU kernels radvlm_tpu/ops/decode_attention.py
// decode_attention_stacked_window / _fused_heads_window_kernel and
// decode_attention_stacked_window_q8 / _fused_heads_window_q8_kernel. q is
// read as [B, W, H, D]; the TPU kernels' kv-head-major query layout has
// nothing to do here.
//
// What bounds them: device-memory bandwidth, as K9 and K4: one pass over the
// layer's K and V up to the window's end, whatever W is. That is the point
// of the kernel: a loop of W single-query launches would read the cache W
// times, and the plain path dequantizes the whole int8 layer first. The
// split-S grid, the split plan and the combine kernel are K9's; a CTA keeps
// its W * g query rows (35 at W = 5, 112 at W = 16 for Qwen2-7B) in dynamic
// shared memory, as f32 q, running sums and the tile's scores, and walks the
// window rows over each staged K/V tile. The dot products are plain FMA as
// in K9 / K4, so the FMA work grows with W while the bytes do not.
//
// Per query row the arithmetic is K9's / K4's, tile by tile in the same
// order under the same split plan, so a window row equals what K9 / K4
// gives for the same visible keys and greedy speculative decoding emits the
// tokens plain greedy decoding emits. The causal part of the mask keys on
// the cache index. Entries above the accepted prefix are stale until the
// next window overwrites them: p is masked, never the product p * vs, and
// a masked score never reads its scale. A row with no visible key gives 0.
//
// Limits: 1 <= W <= 16, H / Hkv <= 8, D <= 128 (even; a multiple of 16 for
// the int8 cache).
extern "C" int radvlm_decode_attention_window(const void* q, const void* ck, const void* cv,
                                              const void* seg, const void* widx,
                                              void* part_o, void* part_ml, void* out, int b,
                                              int s, int h, int hkv, int d, int w, int nsplit,
                                              int chunk, float scale, void* stream) {
  return radvlm::launch_window<false>(q, ck, cv, nullptr, nullptr, seg, widx, part_o, part_ml,
                                      out, b, s, h, hkv, d, w, nsplit, chunk, scale, stream);
}

extern "C" int radvlm_decode_attention_window_q8(const void* q, const void* ck, const void* cv,
                                                 const void* ksc, const void* vsc,
                                                 const void* seg, const void* widx,
                                                 void* part_o, void* part_ml, void* out, int b,
                                                 int s, int h, int hkv, int d, int w,
                                                 int nsplit, int chunk, float scale,
                                                 void* stream) {
  return radvlm::launch_window<true>(q, ck, cv, ksc, vsc, seg, widx, part_o, part_ml, out, b, s,
                                     h, hkv, d, w, nsplit, chunk, scale, stream);
}

extern "C" const char* radvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
