// K5/K6: skinny W8A16 matmul for decode, y = (x @ w^T) * scale, for Hopper
// (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernels radvlm_tpu/ops/int8_matmul.py
// int8_matmul_stacked / _kernel_stacked (the decode layers' projections, a
// layer picked by a scalar-prefetched index) and int8_matmul / _kernel (the
// flat lm_head). In PyTorch a layer's weight w[l] is a free view, so one
// kernel serves both callers.
//
// x [M, K] bf16 with M <= 64 rows (decode slots, or the W rows of each slot
// in a verify step), w [N, K] int8 (torch's [out, in] layout, K contiguous),
// scale [N] f32 per output column, y [M, N] bf16. f32 sums, times
// scale[col], rounded to bf16 once.
//
// What bounds it on the H100: device-memory bandwidth. Every weight byte is
// used M times (2M flops per byte, M <= 64), far below the ridge, so the
// weights must stream once at 3.35 TB/s: about 3 MB in flight over the card
// at ~1 us of latency under load (Little's law), which is 24 KB an SM. The
// design:
// - A weight ring. One lane of a producer warp keeps a ring of up to 8
//   stages full with TMA boxes counted on mbarriers: a stage is 64 weight
//   rows x 256 bytes of K (two boxes of 128 bytes, 16 KB) and x's K-slice
//   for them (four boxes of 64 bf16 x M rows), all in the 128-byte swizzle,
//   zeros past N, M and K. At 8 rows 8 stages fit (128 KB of weights in
//   flight an SM), at 40 rows 4 (64 KB), at 64 rows 2. Six copies a stage:
//   copies of one weight row (cp.async.bulk) or of 16 bytes a lane
//   (cp.async) from one warp came too slowly to fill the pipe (~65 cycles
//   a copy, 1.1-1.4 TB/s). Eight consumer warps, four K parts of 64 bytes
//   x two halves of the unit's columns, release the stage on its `empty`
//   mbarrier; nothing drains the pipe between steps.
// - Weights on the wide side of the product ("swap AB"): mma.sync
//   m16n8k16 with 16 weight rows (output columns) as A and 8 rows of x as
//   B, so 8 decode rows fill a tile and 40 rows are five n8 tiles; no row
//   is padded to 16. A lane reads 16 contiguous weight bytes of a row (one
//   swizzled chunk) and x permutes K the same way (logical k {2t, 2t+1,
//   2t+8, 2t+9} of sub-step j are bytes 4j .. 4j + 3 of lane t's chunk),
//   which the sum does not see.
// - int8 -> bf16 by byte permutes into the f32 form 2^23 + (v + 128), one
//   subtraction, and the upper halves packed (`i8x4_to_bf16`): exact, no
//   conversion instruction (the I2F it replaces runs at a quarter of the
//   ALU rate).
// - A grid sized to the card: the work units are 64-column blocks x K
//   splits (the plan is the wrapper's, from N, K and the SM count). With
//   more blocks than SMs, persistent CTAs (one an SM) walk whole blocks in
//   a fixed order, and the producer runs on into the next block while the
//   consumers sum the last one. With fewer, K is split in 2-8 while the
//   units still fit the card: the splits of a block are the CTAs of one
//   thread-block cluster, one block a cluster, summed in rank order through
//   distributed shared memory: no second launch and no atomics. The four K
//   parts' sums go through shared memory in part order.
// - Row independence: the plan, the k order and the instruction that
//   computes an output element depend on N and K only, never on M (a row
//   of y is one column of the mma's n8 tile), so a decode row equals the
//   same row inside a 40-row verify step bit for bit.
//
// Limits: 1 <= M <= 64, K a multiple of 16, 16-byte aligned x and w (TMA).
// N is any width: the boxes hold zeros past N and those outputs are not
// stored.

#include "common.cuh"
#include "wgmma.cuh"

namespace radvlm {
namespace {

constexpr int kBlockN = 64;                       // output columns a unit: 4 m16 tiles
constexpr int kStageK = 256;                      // K a stage: two 128-byte TMA boxes of w
constexpr int kKParts = 4;                        // 64 bytes of a stage's K each
constexpr int kColGroups = 2;                     // 32 of the unit's columns each
constexpr int kTiles = kBlockN / 16 / kColGroups;  // m16 column tiles a consumer warp
constexpr int kConsumers = kKParts * kColGroups;  // consumer warps
constexpr int kI8Threads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kWBox = kBlockN * 128;              // one weight box: 64 rows x 128 bytes
constexpr int kRedPitch = kBlockN + 4;            // floats a row of the warps' partial sums
constexpr int kMaxStages = 8;
constexpr int kSmemBytes = 232448;                // the most a CTA may opt into
constexpr int kMaxCluster = 8;

// Shared memory for rows padded to mp (a multiple of 8) and `stages` stages:
// the ring (1024-byte aligned stages of two weight boxes and four x boxes of
// mp rows x 64 bf16, all in the 128-byte swizzle), the K parts' sums
// [part][row][col], the block's sum over them [row][col] (what the cluster
// reads), the mbarriers.
struct I8Smem {
  int stage, red, part, bars, bytes;
  __host__ __device__ constexpr I8Smem(int mp, int stages)
      : stage(2 * kWBox + 4 * mp * 128),
        red(stages * (2 * kWBox + 4 * mp * 128)),
        part(stages * (2 * kWBox + 4 * mp * 128) + kKParts * mp * kRedPitch * 4),
        bars(stages * (2 * kWBox + 4 * mp * 128) + kKParts * mp * kRedPitch * 4 +
             mp * kBlockN * 4),
        bytes(bars + 16 * kMaxStages) {}
};

// The ring's depth at mp rows: what the shared memory holds, at most kMaxStages.
__host__ __device__ constexpr int ring_stages(int mp) {
  return (kSmemBytes - I8Smem(mp, 0).bytes) / I8Smem(mp, 0).stage < kMaxStages
             ? (kSmemBytes - I8Smem(mp, 0).bytes) / I8Smem(mp, 0).stage
             : kMaxStages;
}

struct I8Params {
  CUtensorMap tw;  // w [N, K] int8, boxes of 128 bytes x 64 rows
  CUtensorMap tx;  // x [M, K] bf16, boxes of 64 columns x mp rows
  const float* scale;  // [N]
  __nv_bfloat16* out;  // [M, N]
  int m, n, k;
  int kps;      // K a split (a multiple of 64); the cluster holds nsplit CTAs
  int nsplit;
  int nblocks;  // 64-column blocks
};

// NT: n8 tiles of x rows (M padded to 8 NT).
template <int NT>
__global__ void __launch_bounds__(kI8Threads, 1)
    int8_matmul_kernel(const __grid_constant__ I8Params p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int kMp = 8 * NT;
  constexpr int kStages = ring_stages(kMp);
  const I8Smem L(kMp, kStages);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + L.bars, empty = full + 8 * kMaxStages;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* part = reinterpret_cast<float*>(smem + L.part);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = p.nsplit;
  const int rank = c > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int cid = blockIdx.x / c, nclusters = gridDim.x / c;
  const int k0 = rank * p.kps, k1 = min(p.k, k0 + p.kps);
  const int nst = (k1 - k0 + kStageK - 1) / kStageK;  // stages a unit
  const int units = (p.nblocks - cid + nclusters - 1) / nclusters;
  const int total = units * nst;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer
    for (int it = 0; it < total; ++it) {
      const int s = it % kStages, u = it / nst, ks = it % nst;
      if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const int col0 = (cid + u * nclusters) * kBlockN;
      const int kk = k0 + ks * kStageK;
      if (lane == 0) {  // two boxes of w, four of x; zeros past N, M and K
        const uint32_t st = sbase + s * L.stage, bar = full + 8 * s;
        mbar_expect_tx(bar, L.stage);
        tma_load_2d(st, &p.tw, bar, kk, col0);
        tma_load_2d(st + kWBox, &p.tw, bar, kk + 128, col0);
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          tma_load_2d(st + 2 * kWBox + bb * kMp * 128, &p.tx, bar, kk + 64 * bb, 0);
        }
      }
      __syncwarp();
    }
    if (c > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  // This warp's share of a stage: K part kq, four 16-byte chunks of weight
  // box b (q picks which), 64 bytes in all; column tiles kTiles cg ... of
  // the unit. kb0: the first of its chunks.
  const int kq = warp % kKParts, cg = warp / kKParts;
  const int b = kq >> 1, q = kq & 1, kb0 = 128 * b + 16 * q;
  float acc[kTiles][NT][4];
#pragma unroll
  for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ct][nt][i] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int s = it % kStages, u = it / nst, ks = it % nst;
    const int kk = k0 + ks * kStageK;
    const int len = min(kStageK, k1 - kk);
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    if (kb0 < len) {
      // Lane t's 16 bytes of a weight row are chunk c = 2t + (q ^ t / 2) of
      // box b: {0, 2, 5, 7} or {1, 3, 4, 6}. Under the swizzle (chunk ^= row
      // % 8) the chunks of rows g and g + 1 fall in disjoint banks, and the
      // lanes' x chunks (2 (c % 4), + 1) differ too. Past the split's K (a
      // box reads on into the next split) w and x are zeros in registers;
      // past N, M and K the boxes hold zeros.
      const int c = 2 * t + (q ^ (t >> 1));
      const bool in_k = 128 * b + 16 * c < len;
      const uint8_t* st = smem + s * L.stage;
      const uint8_t* wb = st + b * kWBox + ((c ^ g) << 4) + cg * kTiles * 16 * 128;
      uint4 wv[kTiles][2];
#pragma unroll
      for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wv[ct][h] = in_k ? *reinterpret_cast<const uint4*>(wb + (ct * 16 + g + 8 * h) * 128)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
      // x's K of this lane: box 2b + t / 2, chunks 2 (c % 4) and + 1, each
      // the four bf16 of two sub-steps.
      const uint8_t* xb = st + 2 * kWBox + (2 * b + (t >> 1)) * kMp * 128 + g * 128;
      const int cx = 2 * (c & 3);
      uint4 xv[NT];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((j & 1) == 0) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            xv[nt] = in_k ? *reinterpret_cast<const uint4*>(
                                xb + nt * 8 * 128 + (((cx + (j >> 1)) ^ g) << 4))
                          : make_uint4(0u, 0u, 0u, 0u);
          }
        }
        uint32_t a[kTiles][4];
#pragma unroll
        for (int ct = 0; ct < kTiles; ++ct) {
          i8x4_to_bf16(word_of(wv[ct][0], j), a[ct][0], a[ct][2]);  // row g: k 2t.., 2t+8..
          i8x4_to_bf16(word_of(wv[ct][1], j), a[ct][1], a[ct][3]);  // row g + 8
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t b0 = (j & 1) ? xv[nt].z : xv[nt].x, b1 = (j & 1) ? xv[nt].w : xv[nt].y;
#pragma unroll
          for (int ct = 0; ct < kTiles; ++ct) mma_16816(acc[ct][nt], a[ct], b0, b1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (ks != nst - 1) continue;

    // The end of a unit: the four K parts' sums in part order, then (K
    // split) the cluster's in rank order, times the column scale.
    const int col0 = (cid + u * nclusters) * kBlockN;
    float* rw = red + kq * kMp * kRedPitch;
#pragma unroll
    for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = nt * 8 + 2 * t, col = (cg * kTiles + ct) * 16 + g;
        rw[row * kRedPitch + col] = acc[ct][nt][0];
        rw[(row + 1) * kRedPitch + col] = acc[ct][nt][1];
        rw[row * kRedPitch + col + 8] = acc[ct][nt][2];
        rw[(row + 1) * kRedPitch + col + 8] = acc[ct][nt][3];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[ct][nt][i] = 0.f;
      }
    named_sync(1, 32 * kConsumers);
    for (int e = tid; e < p.m * kBlockN; e += 32 * kConsumers) {
      const int row = e / kBlockN, col = e % kBlockN;
      float v = red[row * kRedPitch + col];
#pragma unroll
      for (int w = 1; w < kKParts; ++w) v += red[(w * kMp + row) * kRedPitch + col];
      if (c == 1) {
        if (col0 + col < p.n) {
          p.out[(long)row * p.n + col0 + col] = __float2bfloat16(v * p.scale[col0 + col]);
        }
      } else {
        part[e] = v;
      }
    }
    named_sync(1, 32 * kConsumers);  // red is free for the next unit
    if (c > 1) {  // a K-split cluster holds one block (the launch's grid)
      cluster_sync();
      // The cluster's CTAs share the block's elements; each sums the ranks'
      // partials in rank order.
      const uint32_t pa = smem_u32(part);
      for (int e = rank * 32 * kConsumers + tid; e < p.m * kBlockN; e += c * 32 * kConsumers) {
        const int row = e / kBlockN, col = e % kBlockN;
        if (col0 + col >= p.n) continue;
        float v = ld_cluster_f32(pa + 4 * e, 0);
        for (int r = 1; r < c; ++r) v += ld_cluster_f32(pa + 4 * e, r);
        p.out[(long)row * p.n + col0 + col] = __float2bfloat16(v * p.scale[col0 + col]);
      }
    }
  }
  if (c > 1) cluster_sync();  // no CTA leaves while another reads it
}

template <int NT>
cudaError_t launch_nt(const I8Params& p, cudaStream_t st) {
  constexpr int kMp = 8 * NT;
  constexpr int bytes = I8Smem(kMp, ring_stages(kMp)).bytes;
  static_assert(ring_stages(kMp) >= 2, "a ring of at least two stages");
  static_assert(bytes <= kSmemBytes, "shared memory");
  return launch_units<int8_matmul_kernel<NT>>(p, kI8Threads, bytes, p.nsplit, p.nblocks, st);
}

}  // namespace
}  // namespace radvlm

// nsplit: the K splits, one CTA of a thread-block cluster each (1-8);
// k_per_split: K a split, a multiple of 64. part: unused (the splits are
// summed inside the cluster), must be null. x and w are read by TMA: their
// bases must be 16-byte aligned (K, a multiple of 16, keeps every row so).
extern "C" int radvlm_int8_matmul(const void* x, const void* w, const void* scale,
                                  void* out, void* part, int m, int n, int k,
                                  int nsplit, int k_per_split, void* stream) {
  using namespace radvlm;
  if (m < 1 || m > 64 || n < 1 || k < 16 || k % 16 != 0 || nsplit < 1 ||
      nsplit > kMaxCluster || k_per_split < 64 || k_per_split % 64 != 0 ||
      static_cast<long>(nsplit) * k_per_split < k ||
      static_cast<long>(nsplit - 1) * k_per_split >= k || part != nullptr ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  I8Params p;
  const int nt = (m + 7) / 8;
  cudaError_t err = encode_2d(&p.tw, w, false, n, k, kBlockN);
  if (err == cudaSuccess) err = encode_2d(&p.tx, x, true, m, k, 8 * nt);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.n = n;
  p.k = k;
  p.kps = k_per_split;
  p.nsplit = nsplit;
  p.nblocks = (n + kBlockN - 1) / kBlockN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: err = launch_nt<1>(p, st); break;
    case 2: err = launch_nt<2>(p, st); break;
    case 3: err = launch_nt<3>(p, st); break;
    case 4: err = launch_nt<4>(p, st); break;
    case 5: err = launch_nt<5>(p, st); break;
    case 6: err = launch_nt<6>(p, st); break;
    case 7: err = launch_nt<7>(p, st); break;
    default: err = launch_nt<8>(p, st); break;
  }
  return static_cast<int>(err);
}
