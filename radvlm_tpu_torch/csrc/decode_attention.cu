// K9: single-token GQA decode attention over one layer of the bf16 KV cache,
// for Hopper (sm_90a), written by hand. One kernel (decode_partial_kernel)
// serves it and its three relatives: K4, the same over the int8 cache (an
// int8 source, kQ8: radvlm_decode_attention_q8 below), and K10 and K11, the
// verify windows of speculative decoding over the two caches, which run it
// over the W x g rows of a window (radvlm_decode_attention_window, _q8).
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
// decode_partial_kernel). K10 runs the same kernel over more rows, with
// the same per-row arithmetic, so a verify window's row equals K9 bit for
// bit; K4 and K11 are the two over the int8 cache, each row equal to the
// other's in the same way.
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

#include <type_traits>  // std::integral_constant

namespace radvlm {
namespace {

constexpr int kTile = 64;  // keys per shared-memory tile (two per lane)
constexpr int kMaxGroup = 8;
constexpr int kMaxD = 128;

// The per-row arithmetic of K9, K10, K4 and K11 (one kernel): a query
// row's running max m and sum l, and its f32 output, over 64-key tiles in
// key order: explicit __fmaf_rn / __fmul_rn, so no contraction choice of
// the compiler can differ between instantiations.

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

// A visible key's score: q . k, times the key's K scale on the int8 cache
// (K4, K11). A masked key's score is -inf by selection and never reads its
// scale.
template <bool kQ8>
__device__ __forceinline__ float key_score(float dot, const float* ks, int key) {
  return kQ8 ? __fmul_rn(dot, ks[key]) : dot;
}

// What multiplies a key's V row in the PV sum: p (0 for a masked key), times
// the key's V scale on the int8 cache, where a masked key gives 0 by
// selection: the scales above a verify window are stale and may be
// anything, NaN included.
template <bool kQ8>
__device__ __forceinline__ float pv_weight(float p, bool visible, const float* vs, int key) {
  return kQ8 ? (visible ? __fmul_rn(p, vs[key]) : 0.f) : p;
}

// K9, K10, K4 and K11. A CTA serves R query rows of one (row, kv head, split): the
// g query heads of one decode row (K9, R = g), or the W x g rows of a
// verify window (K10, R = W g: row r is window row r / g, head r % g, and
// sees the keys at cache indices <= widx[b] + r / g). It walks the split's
// chunk of keys with kT threads and a ring of kSt 64-key stages (K, V and
// the keys' segment ids) that every thread fills with cp.async: 16-byte
// copies where D % 8 == 0 and the cache is 16-byte aligned (kVec16), 4-byte
// ones elsewhere, zeros past S and past D. A first pass over the chunk's
// segment ids marks the tiles that hold a key some row sees; only those
// are loaded and computed. A tile that holds keys other rows see but none
// row r sees leaves row r's m, l and o as they are: alpha = 1 and p = 0 (or
// everything still 0 while m = -inf), so row r equals K9 over its own keys
// bit for bit. K9 (256 threads, kNR = 2): scores thread -> key tid % 64
// and rows tid / 64, + 4, K read 16 bytes at a time, q broadcast from
// shared memory; softmax one warp a row. A window: scores and softmax
// warp -> rows warp + 8i (16i at 512 threads), lane -> keys lane and lane +
// 32, so each q element loaded serves two keys and the warp takes K9's
// softmax step on its rows' scores as they sit in registers (one barrier
// fewer). PV, both: thread -> columns 2 (tid % 64), + 1 and rows tid / 64
// + (kT / 64) i, i < kNR, the sums in registers (a window reads p four keys
// at a time). The window's buckets: 256 threads up to 40 rows (two CTAs an
// SM), 512 above (one CTA, 16 warps). K4 and K11 (kQ8) are the same over
// the int8 cache: a stage holds 64 int8 K and V rows (16-byte cp.async,
// half K9's bytes), the keys' segment ids and their K and V scales from
// [B, Hkv, S]; once the tile has landed, every thread turns 8 bytes at a
// time into an exact bf16 copy (`i8x4_to_bf16`: byte permutes, no
// conversion instruction) that the code above reads as a bf16 stage, so the
// conversion is paid once a CTA (35 rows at W = 5), not once a row. The
// score is (q . k) * ks[key]; p is masked before it multiplies vs[key]
// (`key_score`, `pv_weight`).
constexpr int kK9Threads = 256;
constexpr int kMaxVisTiles = 1024;  // chunks beyond 65536 keys: later tiles are not skipped

// The rows a CTA of `threads` threads and kNR PV rows a thread holds:
// threads / 64 x kNR for PV, rounded up to whole rows of every warp for a
// window's scores (40 at 256 threads and kNR = 9).
__host__ __device__ constexpr int rows_cap(int threads, int nr) {
  return threads / 32 * ((nr + 1) / 2);
}

// Shared memory at head dims padded to dp (a multiple of 16), for `rows`
// query rows and a ring of `stages`, over the bf16 cache or (q8) the int8
// one: there a stage holds the int8 tiles and the keys' two scales, and the
// tile in use is converted once into a bf16 copy (`cvt`) that the bf16
// kernel's code reads as it reads a stage.
struct PartialSmem {
  int row;    // bytes a bf16 K or V row: 16-byte chunks, an odd number of them
  int tile;   // one bf16 K or V tile
  int row8;   // bytes an int8 K or V row (q8): an odd number of 16-byte chunks
  int tile8;  // one int8 tile (q8)
  int stage;  // K, V, segment ids (q8: and the keys' K and V scales)
  int cvt;    // q8: the bf16 copy of the tile in use, K then V
  int qs, sc, ml, vis, bytes;
  __host__ __device__ PartialSmem(int dp, int rows, int stages, bool q8) {
    row = dp * 2 + 16;
    tile = kTile * row;
    row8 = dp + 16;
    tile8 = kTile * row8;
    stage = q8 ? 2 * tile8 + 3 * kTile * 4 : 2 * tile + kTile * 4;
    cvt = stages * stage;
    qs = cvt + (q8 ? 2 * tile : 0);
    sc = qs + rows * dp * 4;
    ml = sc + rows * kTile * 4;
    vis = ml + 3 * rows * 4;
    bytes = vis + kMaxVisTiles;
  }
};

// The ring's depth, all of it in flight before the first tile: K9's three;
// a 256-thread window's two, so that two CTAs share an SM (up to 40 rows at
// D = 128); a 512-thread window's three (one CTA an SM).
constexpr int partial_stages(bool window, int threads) {
  return window && threads == 256 ? 2 : 3;
}

__device__ __forceinline__ void cp_async16z(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// kDP: the padded head dim where it is fixed at compile time (0: d's).
// kQ8: the int8 cache with its scales (K4, K11), else bf16 (K9, K10).
template <bool kVec16, int kDP, int kT, int kNR, int kSt, bool kWindow, bool kQ8>
__global__ void __launch_bounds__(kT, kT == 256 ? 2 : 1) decode_partial_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, W, H, D] (W = 1: K9, K4)
    const void* __restrict__ ck,          // [B, S, Hkv * D], one layer, bf16 or int8
    const void* __restrict__ cv,
    const float* __restrict__ ksc,  // q8: [B, Hkv, S] the keys' K and V scales
    const float* __restrict__ vsc,
    const int* __restrict__ seg,   // [B, S]
    const int* __restrict__ widx,  // [B] cache index of window row 0 (kWindow)
    float* __restrict__ part_o,    // [B, W, H, nsplit, D]
    float* __restrict__ part_ml,   // [B, W, H, nsplit, 2]: max, sum
    int s, int hkv, int group, int d, int w, int chunk, float scale_log2) {
  constexpr int kWarps = kT / 32, kHG = kT / 64;  // warps; PV (and K9 scores) row groups
  constexpr int kRowsCap = rows_cap(kT, kNR);
  constexpr int kWR = kRowsCap / kWarps;  // a window's rows a warp in scores and softmax
  extern __shared__ __align__(16) uint8_t k9_smem[];
  const int dp = kDP > 0 ? kDP : (d + 15) / 16 * 16;
  const PartialSmem L(dp, kRowsCap, kSt, kQ8);
  const uint32_t sbase = smem_u32(k9_smem);
  float* qs = reinterpret_cast<float*>(k9_smem + L.qs);  // [kRowsCap][dp]
  float* sc = reinterpret_cast<float*>(k9_smem + L.sc);  // [kRowsCap][kTile]
  float* m_s = reinterpret_cast<float*>(k9_smem + L.ml);
  float* l_s = m_s + kRowsCap;
  float* alpha_s = l_s + kRowsCap;
  uint8_t* vis = k9_smem + L.vis;  // a tile holds a visible key

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y / hkv, kvh = blockIdx.y % hkv;
  const int h = hkv * group, rows = w * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long hd = (long)hkv * d;
  const long kv0 = (long)b * s * hd + (long)kvh * d;  // this (row, kv head)'s first element
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(ck) + kv0;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(cv) + kv0;
  const int8_t* kb8 = static_cast<const int8_t*>(ck) + kv0;
  const int8_t* vb8 = static_cast<const int8_t*>(cv) + kv0;
  const float* ksb = kQ8 ? ksc + ((long)b * hkv + kvh) * s : nullptr;
  const float* vsb = kQ8 ? vsc + ((long)b * hkv + kvh) * s : nullptr;
  const int* sb = seg + (long)b * s;
  // No row of a window sees a key past wi + w - 1: the chunk ends there,
  // and a split that lies wholly above it writes m = -inf, l = 0, o = 0.
  const int wi = kWindow ? widx[b] : 0;
  const int c0 = split * chunk;
  const int c1 = kWindow ? min(min(s, c0 + chunk), wi + w) : min(s, c0 + chunk);
  const int n_tiles = c0 < c1 ? (c1 - c0 + kTile - 1) / kTile : 0;
  // Row r of the CTA in q, part_o and part_ml.
  auto qrow = [&](int r) -> long {
    return kWindow ? ((long)b * w + r / group) * h + kvh * group + r % group
                   : (long)b * h + kvh * group + r;
  };

#pragma unroll 4
  for (int i = tid; i < kRowsCap * dp; i += kT) {
    const int r = i / dp, dd = i % dp;
    qs[i] = r < rows && dd < d ? __bfloat162float(q[qrow(r) * d + dd]) : 0.f;
  }
  for (int r = tid; r < kRowsCap; r += kT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
    alpha_s[r] = 0.f;
  }
  // The visible tiles, in the same phase as q: warp w ballots tiles w, w +
  // kT / 32, ... (tiles past kMaxVisTiles count as visible).
  for (int t = warp; t < min(n_tiles, kMaxVisTiles); t += kT / 32) {
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
      const uint32_t kst = sbase + st * L.stage, vst = kst + (kQ8 ? L.tile8 : L.tile);
      if (kQ8) {  // 16 int8 a copy (D is a multiple of 16); then segment ids, K and V scales
        const int vecs = dp / 16;
        for (int i = tid; i < kTile * vecs; i += kT) {
          const int r = i / vecs, c = (i % vecs) * 16;
          const bool ok = n0 + r < c1 && c < d;
          const long off = ok ? (long)(n0 + r) * hd + c : 0;
          cp_async16z(kst + r * L.row8 + c, kb8 + off, ok);
          cp_async16z(vst + r * L.row8 + c, vb8 + off, ok);
        }
        if (tid < 3 * kTile) {
          const int which = tid / kTile, key = n0 + tid % kTile;
          const bool ok = key < c1;
          const void* src = which == 0 ? static_cast<const void*>(sb + key)
                                       : which == 1 ? ksb + key : vsb + key;
          cp_async4(vst + L.tile8 + tid * 4, ok ? src : sb, ok);
        }
      } else if (kVec16) {
        const int vecs = dp / 8;
        for (int i = tid; i < kTile * vecs; i += kT) {
          const int r = i / vecs, c = (i % vecs) * 8;
          const bool ok = n0 + r < c1 && c < d;
          const long off = ok ? (long)(n0 + r) * hd + c : 0;
          cp_async16z(kst + r * L.row + c * 2, kb + off, ok);
          cp_async16z(vst + r * L.row + c * 2, vb + off, ok);
        }
      } else {
        const int pairs = dp / 2;
        for (int i = tid; i < kTile * pairs; i += kT) {
          const int r = i / pairs, c = (i % pairs) * 2;
          const bool ok = n0 + r < c1 && c < d;
          const long off = ok ? (long)(n0 + r) * hd + c : 0;
          cp_async4(kst + r * L.row + c * 2, kb + off, ok);
          cp_async4(vst + r * L.row + c * 2, vb + off, ok);
        }
      }
      if (!kQ8 && tid < kTile) {
        const bool ok = n0 + tid < c1;
        cp_async4(vst + L.tile + tid * 4, ok ? sb + n0 + tid : sb, ok);
      }
    }
    cp_async_commit();
  };

  const int key = tid & (kTile - 1), hs = tid >> 6;  // K9's scores: one key, rows hs + 4i
  const int cp = tid & 63;                           // PV: columns 2 cp, 2 cp + 1
  // Which of the thread's PV rows to compute. A window computes all kNR
  // with no branch in its loops: rows past R hold q = 0 and are never
  // stored. K9 skips its second row where g <= 4 + hs, as it always has.
  auto live = [&](int j) { return kWindow || j == 0 || hs + kHG * j < rows; };
  // A window's running max and sum of rows warp + kWarps j (every lane
  // holds them).
  float m_w[kWR], l_w[kWR];
#pragma unroll
  for (int j = 0; j < kWR; ++j) {
    m_w[j] = -INFINITY;
    l_w[j] = 0.f;
  }
  // A window's scores and softmax step of a tile, for the first NJ rows of
  // this warp, warp + kWarps j: lane -> keys lane and lane + 32, so a warp
  // holds a row's 64 scores in registers and takes K9's softmax step on
  // them as it is. Each q element loaded serves two keys.
  auto window_rows = [&](auto nj, const uint8_t* kt, const int* seg_s, const float* ks_s,
                         const float* vs_s, int n0) {
    constexpr int NJ = decltype(nj)::value;
    const uint8_t* krow0 = kt + lane * L.row;  // keys lane and lane + 32
    const uint8_t* krow1 = krow0 + 32 * L.row;
    float d0[NJ], d1[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) d0[j] = d1[j] = 0.f;
#pragma unroll
    for (int c = 0; c < dp; c += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(krow0 + c * 2);
      const uint4 v = *reinterpret_cast<const uint4*>(krow1 + c * 2);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* qr = qs + (warp + kWarps * j) * dp + c;
        const float4 a0 = *reinterpret_cast<const float4*>(qr);
        const float4 a1 = *reinterpret_cast<const float4*>(qr + 4);
        d0[j] = dot2(dot2(dot2(dot2(d0[j], a0.x, a0.y, u.x), a0.z, a0.w, u.y), a1.x, a1.y, u.z),
                     a1.z, a1.w, u.w);
        d1[j] = dot2(dot2(dot2(dot2(d1[j], a0.x, a0.y, v.x), a0.z, a0.w, v.y), a1.x, a1.y, v.z),
                     a1.z, a1.w, v.w);
      }
    }
    const bool w0 = seg_s[lane] != 0, w1 = seg_s[lane + 32] != 0;
    // Every row sees the keys up to wi; past it, row r sees wi + r / g more
    // (only the window's last tile holds such keys).
    const int past0 = n0 + lane - wi, past1 = past0 + 32;
    const bool tail = n0 + kTile - 1 > wi;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = warp + kWarps * j;
      bool v0 = w0, v1 = w1;
      if (tail) {
        const int jr = r / group;
        v0 = w0 && past0 <= jr;
        v1 = w1 && past1 <= jr;
      }
      float p0, p1, m_new, l_new, alpha;
      softmax_tile(v0 ? key_score<kQ8>(d0[j], ks_s, lane) : -INFINITY,
                   v1 ? key_score<kQ8>(d1[j], ks_s, lane + 32) : -INFINITY, m_w[j], l_w[j],
                   scale_log2, p0, p1, m_new, l_new, alpha);
      m_w[j] = m_new;
      l_w[j] = l_new;
      sc[r * kTile + lane] = pv_weight<kQ8>(p0, v0, vs_s, lane);
      sc[r * kTile + lane + 32] = pv_weight<kQ8>(p1, v1, vs_s, lane + 32);
      if (lane == 0) alpha_s[r] = alpha;
    }
  };
  float acc[kNR][2];
#pragma unroll
  for (int i = 0; i < kNR; ++i) acc[i][0] = acc[i][1] = 0.f;

  int t_issue = next_visible(0);
#pragma unroll
  for (int i = 0; i < kSt; ++i) {
    issue(t_issue, i);
    if (t_issue < n_tiles) t_issue = next_visible(t_issue + 1);
  }
  int i = 0;
  for (int t = next_visible(0); t < n_tiles; t = next_visible(t + 1), ++i) {
    const int st = i % kSt;
    // Tile i is commit group i: the prologue's kSt groups, then one a loop
    // iteration from the second on.
    if (i == 0) {
      cp_async_wait<kSt - 1>();
    } else {
      cp_async_wait<kSt - 2>();
    }
    __syncthreads();  // tile t has landed; the stage of the tile before is consumed
    if (i > 0) {      // that stage takes the next tile
      issue(t_issue, (i - 1) % kSt);
      if (t_issue < n_tiles) t_issue = next_visible(t_issue + 1);
    }
    // The tile's K and V (bf16) and its keys' segment ids and scales (q8).
    const uint8_t* stage = k9_smem + st * L.stage;
    const uint8_t* kt = kQ8 ? k9_smem + L.cvt : stage;
    const uint8_t* vt = kt + L.tile;
    const int* seg_s = reinterpret_cast<const int*>(stage + 2 * (kQ8 ? L.tile8 : L.tile));
    const float* ks_s = reinterpret_cast<const float*>(seg_s + kTile);
    const float* vs_s = ks_s + kTile;
    if constexpr (kQ8) {
      // The int8 tile into its exact bf16 copy, once for all rows: 8 bytes a
      // thread a step, one 16-byte store. The copy of the tile before is
      // consumed (the barrier above).
      uint8_t* cvt = k9_smem + L.cvt;
      const int vecs = dp / 8;
      for (int v = tid; v < 2 * kTile * vecs; v += kT) {
        const int kv = v / (kTile * vecs), r = v / vecs % kTile, c = v % vecs * 8;
        const uint2 w8 = *reinterpret_cast<const uint2*>(stage + kv * L.tile8 + r * L.row8 + c);
        uint4 bf;
        i8x4_to_bf16(w8.x, bf.x, bf.y);
        i8x4_to_bf16(w8.y, bf.z, bf.w);
        *reinterpret_cast<uint4*>(cvt + kv * L.tile + r * L.row + 2 * c) = bf;
      }
      __syncthreads();
    }

    if constexpr (kWindow) {
      // This warp's rows: exactly, where it holds kWR or kWR - 1 of them
      // (rows past R hold q = 0 otherwise).
      const int nj = (rows - warp + kWarps - 1) / kWarps;
      if (nj >= kWR) {
        window_rows(std::integral_constant<int, kWR>{}, kt, seg_s, ks_s, vs_s, c0 + t * kTile);
      } else if (nj > 0) {
        window_rows(std::integral_constant<int, (kWR > 1 ? kWR - 1 : 1)>{}, kt, seg_s, ks_s,
                    vs_s, c0 + t * kTile);
      }
      __syncthreads();
    } else {  // K9 / K4: thread -> one key, rows hs and hs + 4; then one warp a row
      const uint8_t* krow = kt + key * L.row;
      float dot[kNR];
#pragma unroll
      for (int j = 0; j < kNR; ++j) dot[j] = 0.f;
      if (hs < rows) {
#pragma unroll
        for (int c = 0; c < dp; c += 8) {
          const uint4 kv = *reinterpret_cast<const uint4*>(krow + c * 2);
#pragma unroll
          for (int j = 0; j < kNR; ++j) {
            if (live(j)) {
              const float* qr = qs + (hs + kHG * j) * dp + c;
              const float4 a0 = *reinterpret_cast<const float4*>(qr);
              const float4 a1 = *reinterpret_cast<const float4*>(qr + 4);
              dot[j] = dot2(dot2(dot2(dot2(dot[j], a0.x, a0.y, kv.x), a0.z, a0.w, kv.y), a1.x,
                                 a1.y, kv.z),
                            a1.z, a1.w, kv.w);
            }
          }
        }
        const bool visible = seg_s[key] != 0;
#pragma unroll
        for (int j = 0; j < kNR; ++j) {
          if (live(j)) {
            sc[(hs + kHG * j) * kTile + key] =
                visible ? key_score<kQ8>(dot[j], ks_s, key) : -INFINITY;
          }
        }
      }
      __syncthreads();
      if (warp < rows) {
        const float x0 = sc[warp * kTile + lane], x1 = sc[warp * kTile + lane + 32];
        float p0, p1, m_new, l_new, alpha;
        softmax_tile(x0, x1, m_s[warp], l_s[warp], scale_log2, p0, p1, m_new, l_new, alpha);
        sc[warp * kTile + lane] = pv_weight<kQ8>(p0, x0 != -INFINITY, vs_s, lane);
        sc[warp * kTile + lane + 32] = pv_weight<kQ8>(p1, x1 != -INFINITY, vs_s, lane + 32);
        __syncwarp();
        if (lane == 0) {
          alpha_s[warp] = alpha;
          l_s[warp] = l_new;
          m_s[warp] = m_new;
        }
      }
      __syncthreads();
    }
    if (2 * cp < d && (kWindow || hs < rows)) {
      const uint32_t* vcol = reinterpret_cast<const uint32_t*>(vt) + cp;
#pragma unroll
      for (int j = 0; j < kNR; ++j) {
        if (live(j)) {
          const float al = alpha_s[hs + kHG * j];
          acc[j][0] = __fmul_rn(acc[j][0], al);
          acc[j][1] = __fmul_rn(acc[j][1], al);
        }
      }
      if constexpr (kWindow) {  // p read four keys at a time
#pragma unroll 2
        for (int kk = 0; kk < kTile; kk += 4) {
          float v0[4], v1[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t v2 = vcol[(kk + u) * (L.row / 4)];
            v0[u] = __uint_as_float(v2 << 16);
            v1[u] = __uint_as_float(v2 & 0xffff0000u);
          }
#pragma unroll
          for (int j = 0; j < kNR; ++j) {
            const float4 p = *reinterpret_cast<const float4*>(sc + (hs + kHG * j) * kTile + kk);
            acc[j][0] = pv_step(pv_step(pv_step(pv_step(acc[j][0], p.x, v0[0]), p.y, v0[1]),
                                        p.z, v0[2]),
                                p.w, v0[3]);
            acc[j][1] = pv_step(pv_step(pv_step(pv_step(acc[j][1], p.x, v1[0]), p.y, v1[1]),
                                        p.z, v1[2]),
                                p.w, v1[3]);
          }
        }
      } else {
#pragma unroll 8
        for (int kk = 0; kk < kTile; ++kk) {
          const uint32_t v2 = vcol[kk * (L.row / 4)];
          const float v0 = __uint_as_float(v2 << 16), v1 = __uint_as_float(v2 & 0xffff0000u);
#pragma unroll
          for (int j = 0; j < kNR; ++j) {
            if (live(j)) {
              acc[j][0] = pv_step(acc[j][0], sc[(hs + kHG * j) * kTile + kk], v0);
              acc[j][1] = pv_step(acc[j][1], sc[(hs + kHG * j) * kTile + kk], v1);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (2 * cp < d) {
#pragma unroll
    for (int j = 0; j < kNR; ++j) {
      const int r = hs + kHG * j;
      if (r < rows) {
        *reinterpret_cast<float2*>(&part_o[(qrow(r) * nsplit + split) * d + 2 * cp]) =
            make_float2(acc[j][0], acc[j][1]);
      }
    }
  }
  if constexpr (kWindow) {
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kWR; ++j) {
        const int r = warp + kWarps * j;
        if (r < rows) {
          part_ml[(qrow(r) * nsplit + split) * 2 + 0] = m_w[j];
          part_ml[(qrow(r) * nsplit + split) * 2 + 1] = l_w[j];
        }
      }
    }
  } else {
    for (int r = tid; r < rows; r += kT) {
      part_ml[(qrow(r) * nsplit + split) * 2 + 0] = m_s[r];
      part_ml[(qrow(r) * nsplit + split) * 2 + 1] = l_s[r];
    }
  }
}

constexpr int kMaxWindow = 16;

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

using PartialKernel = void (*)(const __nv_bfloat16*, const void*, const void*, const float*,
                               const float*, const int*, const int*, float*, float*, int, int,
                               int, int, int, int, float);

// The K9 / K10 / K4 / K11 kernel of kT threads, kNR PV rows a thread
// (rows_cap(kT, kNR) rows a CTA), kWindow and kQ8: D = 128 fixed at compile
// time where the main paths run it (one query, and the windows of 5 and 16
// over Qwen2-7B's g = 7: 35 and 112 rows), the padded D at run time
// elsewhere; 4-byte copies for unaligned bf16 caches and D % 8 != 0 (the
// int8 cache is 16-byte aligned and D a multiple of 16: the wrappers check).
template <int kT, int kNR, bool kWindow, bool kQ8>
PartialKernel partial_kernel(bool vec16, int d) {
  constexpr int st = partial_stages(kWindow, kT);
  if constexpr (!kQ8) {
    if (!vec16) return decode_partial_kernel<false, 0, kT, kNR, st, kWindow, kQ8>;
  }
  if constexpr (!kWindow) {
    if (d == 64) return decode_partial_kernel<true, 64, kT, kNR, st, kWindow, kQ8>;
  }
  if constexpr (!kWindow || (kT == 256 && kNR == 9) || (kT == 512 && kNR == 14)) {
    if (d == 128) return decode_partial_kernel<true, 128, kT, kNR, st, kWindow, kQ8>;
  }
  return decode_partial_kernel<true, 0, kT, kNR, st, kWindow, kQ8>;
}

// Every instantiation of the bucket opted into its shared memory (above 48
// KB it is dynamic), once.
template <int kT, int kNR, bool kWindow, bool kQ8>
cudaError_t partial_attrs() {
  static const cudaError_t attr = [] {
    const int bytes =
        PartialSmem(kMaxD, rows_cap(kT, kNR), partial_stages(kWindow, kT), kQ8).bytes;
    for (bool vec16 : {false, true}) {
      for (int d : {64, 128, 96}) {
        const cudaError_t a = cudaFuncSetAttribute(
            partial_kernel<kT, kNR, kWindow, kQ8>(vec16, d),
            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (a != cudaSuccess) return a;
      }
    }
    return cudaSuccess;
  }();
  return attr;
}

// K9 / K4 (w = 1, widx null) or K10 / K11 over the rows of a (slot, kv head,
// split), then the split combine. ksc / vsc: the int8 cache's scales (kQ8).
template <int kT, int kNR, bool kWindow, bool kQ8>
int launch_partial(const void* q, const void* ck, const void* cv, const void* ksc,
                   const void* vsc, const void* seg, const void* widx, void* part_o,
                   void* part_ml, void* out, int b, int s, int h, int hkv, int d, int w,
                   int nsplit, int chunk, float scale, cudaStream_t st) {
  const cudaError_t attr = partial_attrs<kT, kNR, kWindow, kQ8>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float scale_log2 = scale * kLog2e;
  const bool vec16 = d % 8 == 0 && reinterpret_cast<uintptr_t>(ck) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cv) % 16 == 0;
  if (kQ8 && (!vec16 || d % 16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const int stages = partial_stages(kWindow, kT);
  const PartialKernel kernel = partial_kernel<kT, kNR, kWindow, kQ8>(vec16, d);
  kernel<<<dim3(nsplit, b * hkv), kT,
           PartialSmem((d + 15) / 16 * 16, rows_cap(kT, kNR), stages, kQ8).bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), ck, cv, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(seg),
      static_cast<const int*>(widx), static_cast<float*>(part_o), static_cast<float*>(part_ml),
      s, hkv, h / hkv, d, w, chunk, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<b * w * h, kCombineThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), nsplit, d, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// K10 / K11: W x g rows a CTA in buckets (rows_cap(threads, kNR) rows at
// most): 256 threads and kNR = 4, 9 (up to 16, 40 rows, two CTAs an SM),
// 512 threads and kNR = 14, 16 (up to 112, 128 rows, one CTA an SM).
template <bool kQ8>
int launch_window(const void* q, const void* ck, const void* cv, const void* ksc,
                  const void* vsc, const void* seg, const void* widx, void* part_o,
                  void* part_ml, void* out, int b, int s, int h, int hkv, int d, int w,
                  int nsplit, int chunk, float scale, cudaStream_t st) {
  const int rows = w * (h / hkv);
  auto launch = [&](auto threads, auto nr) {
    return launch_partial<decltype(threads)::value, decltype(nr)::value, true, kQ8>(
        q, ck, cv, ksc, vsc, seg, widx, part_o, part_ml, out, b, s, h, hkv, d, w, nsplit,
        chunk, scale, st);
  };
  using std::integral_constant;
  constexpr integral_constant<int, 256> t256{};
  constexpr integral_constant<int, 512> t512{};
  if (rows <= 16) return launch(t256, integral_constant<int, 4>{});
  if (rows <= 40) return launch(t256, integral_constant<int, 9>{});
  if (rows <= 112) return launch(t512, integral_constant<int, 14>{});
  return launch(t512, integral_constant<int, 16>{});
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
  return launch_partial<kK9Threads, 2, false, false>(
      q, ck, cv, nullptr, nullptr, seg, nullptr, part_o, part_ml, out, b, s, h, hkv, d, 1, nsplit,
      chunk, scale, static_cast<cudaStream_t>(stream));
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
// (plus 8 bytes of scales per key and kv head). It is K9's kernel with an
// int8 source (decode_partial_kernel, kQ8): the same split plan, 256
// threads, a ring of three 64-key stages of int8 K and V (16-byte cp.async)
// with the keys' segment ids and scales, the pass that skips tiles with no
// visible key, and the same per-row arithmetic; the tile in use is turned
// once into an exact bf16 copy that K9's score and PV code reads. So the
// conversion costs once a CTA, not once a row, and K11's window rows, the
// same kernel over W x g rows, equal K4's bit for bit.
//
// Choices against the TPU kernel:
// - p * vs stays f32 in the PV sum (the TPU kernel rounds it to bf16 before
//   its bf16 PV matmul); the plain version does the same;
// - p = 0 where the slot's segment is 0, and a row with no written slot gives
//   o = 0 (the TPU kernel's finite mask value gives mean(v) there);
// - slots of a batch decode at different write indices: only the segment
//   ids mask, as on the TPU.
//
// Limits: D a multiple of 16 and <= 128, H / Hkv <= 8, a 16-byte aligned cache.
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
  return launch_partial<kK9Threads, 2, false, true>(
      q, ck, cv, ksc, vsc, seg, nullptr, part_o, part_ml, out, b, s, h, hkv, d, 1, nsplit, chunk,
      scale, static_cast<cudaStream_t>(stream));
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
// What bounds them: one pass over the layer's K and V up to the window's
// end, whatever W is, so a loop of W single-query launches would read the
// cache W times, and the plain path dequantizes the whole int8 layer
// first. The split-S grid, the split plan and the combine kernel are K9's;
// a CTA holds the W * g query rows of a (slot, kv head, split) (35 at W =
// 5, 112 at W = 16 for Qwen2-7B). The dot products are plain f32 FMA as in
// K9 / K4, so the FMA work grows with W while the bytes do not: at W = 5
// the FMA floor (~1.7 GFLOP at 67 TFLOP/s, 0.026 ms) is twice the byte
// bound (0.013 ms over the bf16 cache, half that over the int8 one) and
// binds. Both are K9's kernel (decode_partial_kernel, design note there)
// over the window's rows: sums in registers, the 64-key K/V ring (two
// stages where that leaves room for two CTAs an SM, up to 40 rows at D =
// 128; three otherwise), and the pass that skips tiles no row sees; K11
// reads the int8 source of K4, each tile converted once into bf16 for all
// W x g rows.
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
// the int8 cache). Both take W x g rows a CTA in the buckets of
// launch_window.
extern "C" int radvlm_decode_attention_window(const void* q, const void* ck, const void* cv,
                                              const void* seg, const void* widx,
                                              void* part_o, void* part_ml, void* out, int b,
                                              int s, int h, int hkv, int d, int w, int nsplit,
                                              int chunk, float scale, void* stream) {
  using namespace radvlm;
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxD || d % 2 != 0 || w < 1 ||
      w > kMaxWindow || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_window<false>(q, ck, cv, nullptr, nullptr, seg, widx, part_o, part_ml, out, b,
                              s, h, hkv, d, w, nsplit, chunk, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int radvlm_decode_attention_window_q8(const void* q, const void* ck, const void* cv,
                                                 const void* ksc, const void* vsc,
                                                 const void* seg, const void* widx,
                                                 void* part_o, void* part_ml, void* out, int b,
                                                 int s, int h, int hkv, int d, int w,
                                                 int nsplit, int chunk, float scale,
                                                 void* stream) {
  using namespace radvlm;
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxD || d % 16 != 0 || w < 1 ||
      w > kMaxWindow || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_window<true>(q, ck, cv, ksc, vsc, seg, widx, part_o, part_ml, out, b, s, h, hkv,
                             d, w, nsplit, chunk, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* radvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
