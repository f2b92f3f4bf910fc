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
// What bounds it on the H100: device-memory bandwidth (0.53 bytes of
// nibbles and scales a weight, 2M flops a weight, M <= 64), and behind it
// the issue rate of dequantizing: at 3.35 TB/s an SM must turn ~29 nibbles a
// cycle into bf16, and each costs ~3.6 instructions (below), so the consumer
// warps issue near one instruction a cycle on every SM sub-partition when
// the weights stream at the byte bound. The design is K5/K6's
// (csrc/int8_matmul.cu) with the scales in the stage:
// - A weight ring. One lane of a producer warp keeps a ring of up to 8
//   stages full with TMA boxes counted on mbarriers: a stage is 64 weight
//   rows x 256 bytes (512 k; two boxes of 128 bytes, 16 KB), x's K-slice
//   for them (eight boxes of 64 bf16 x M rows) and the stage's 4 groups x
//   64 columns of scales (one f32 box of 1 KB), zeros past N, M and K. At 8
//   rows 8 stages fit (128 KB of weights in flight an SM, where Little's
//   law asks ~24 KB), at 16 rows 6, at 24 4, at 32-40 3, above 2. TMA needs
//   a scale row pitch of 16 bytes (N % 4 == 0, every Qwen2 width): for
//   other N the producer's 32 lanes copy the scales 4 bytes at a time
//   (cp.async) onto the same mbarrier. Eight consumer warps, four K parts
//   of 64 bytes x two halves of the unit's 64 columns, release the stage
//   on its `empty` mbarrier.
// - Weights on the wide side of the product ("swap AB"): mma.sync
//   m16n8k16 with 16 weight rows (output columns) as A and 8 rows of x as
//   B, so 8 decode rows fill a tile and 40 rows are five n8 tiles; no row
//   is padded to 16. A lane reads 16 contiguous weight bytes of a row (32
//   k, one swizzled chunk, inside one scale group) and x permutes K the
//   same way: the 8 nibbles of word j of the chunk are sub-steps 2j and
//   2j + 1, logical k {2t, 2t+1, 2t+8, 2t+9} being nibbles {0,1,2,3} and
//   {4,5,6,7}; x's matching 8 bf16 are one 16-byte chunk. Lanes of odd t
//   take their words in the order 2, 3, 0, 1 (two 8-byte loads, halves
//   swapped), so that the four lanes' x chunks fall in distinct banks. The
//   sum does not see the order.
// - Dequantization by the float's bits: nibble i of a half-word, masked in
//   place under the exponent of 2^23 with its sign bit flipped (one LOP3,
//   `(w & (0xF << 4i)) ^ (0x4B000000 | 8 << 4i)`, the flip word held in a
//   register), is the float 2^23 + (n + 8) 2^(4i); subtracting 2^23 + 8
//   2^(4i) leaves n 2^(4i) exactly, and multiplying by scale 2^(-4i) (four
//   such scales a column and group, made once a stage) rounds n x scale
//   once, bit for bit f32(n) * scale (a power of two commutes with rounding
//   away from subnormals: scales above 2^-114). One shift a word brings the
//   upper half-word down. Then pairs are rounded to bf16 (one F2FP). Per 8
//   weights: 9 integer instructions, 16 f32 ones and 4 conversions.
// - A grid sized to the card: the work units are 64-column blocks x K
//   splits (the plan is the wrapper's, from N, K and the SM count, in
//   whole stages, so whole 128-k groups: a stage never straddles a split).
//   With more blocks than SMs, persistent CTAs (one an SM) walk whole
//   blocks in a fixed order, and the producer runs on into the next block
//   while the consumers sum the last one. With fewer, K is split in 2-8
//   while the units still fit the card: the splits of a block are the CTAs
//   of one thread-block cluster, summed in rank order through distributed
//   shared memory: no second launch, no f32 partials in device memory, no
//   atomics. K parts 1-3 hand their sums to part 0 through shared memory,
//   which adds them in part order.
// - Row independence: the plan, the k order and the instruction that
//   computes an output element depend on N and K only, never on M (a row
//   of y is one column of the mma's n8 tile), so a decode row equals the
//   same row inside a 40-row verify step bit for bit: greedy speculative
//   tokens rely on that.
//
// Limits: 1 <= M <= 64, K a multiple of 128, 16-byte aligned x and w (TMA),
// 4-byte aligned scales. N is any width: the boxes hold zeros past N and
// those outputs are not stored.

#include "common.cuh"
#include "wgmma.cuh"

namespace radvlm {
namespace {

constexpr int kGroup = 128;                        // k a scale group
constexpr int kBlockN = 64;                        // output columns a unit: 4 m16 tiles
constexpr int kStageK = 512;                       // k a stage: two 128-byte boxes of w
constexpr int kStageGroups = kStageK / kGroup;     // 4
constexpr int kKParts = 4;                         // 64 bytes of a stage's row each
constexpr int kColGroups = 2;                      // 32 of the unit's columns each
constexpr int kTiles = kBlockN / 16 / kColGroups;  // m16 column tiles a consumer warp
constexpr int kConsumers = kKParts * kColGroups;   // consumer warps
constexpr int kQ4Threads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kWBox = kBlockN * 128;               // one weight box: 64 rows x 128 bytes
constexpr int kXBoxes = kStageK / 64;              // boxes of 64 bf16 of x a stage
constexpr int kScaleBytes = kStageGroups * kBlockN * 4;
constexpr int kMaxStages = 8;
constexpr int kSmemBytes = 232448;                 // the most a CTA may opt into
constexpr int kMaxCluster = 8;

// Shared memory for rows padded to mp (a multiple of 8) and `stages` stages:
// the ring (1024-byte aligned stages of two weight boxes, eight x boxes of
// mp rows x 64 bf16, both in the 128-byte swizzle, and the scales [4][64]
// f32), the sums of K parts 1-3 in each lane's accumulator layout, the
// block's sum [row][col] (what a cluster reads), the mbarriers.
struct Q4Smem {
  int stage, red, part, bars, bytes;
  __host__ __device__ constexpr Q4Smem(int mp, int stages)
      : stage(2 * kWBox + kXBoxes * mp * 128 + kScaleBytes),
        red(stages * (2 * kWBox + kXBoxes * mp * 128 + kScaleBytes)),
        part(stages * (2 * kWBox + kXBoxes * mp * 128 + kScaleBytes) +
             kColGroups * (kKParts - 1) * kTiles * (mp / 8) * 32 * 16),
        bars(stages * (2 * kWBox + kXBoxes * mp * 128 + kScaleBytes) +
             kColGroups * (kKParts - 1) * kTiles * (mp / 8) * 32 * 16 + mp * kBlockN * 4),
        bytes(bars + 16 * kMaxStages) {}
};

// The ring's depth at mp rows: what the shared memory holds, at most kMaxStages.
__host__ __device__ constexpr int ring_stages(int mp) {
  return (kSmemBytes - Q4Smem(mp, 0).bytes) / Q4Smem(mp, 0).stage < kMaxStages
             ? (kSmemBytes - Q4Smem(mp, 0).bytes) / Q4Smem(mp, 0).stage
             : kMaxStages;
}

struct Q4Params {
  CUtensorMap tw;  // w [N, K/2] uint8, boxes of 128 bytes x 64 rows
  CUtensorMap tx;  // x [M, K] bf16, boxes of 64 columns x mp rows
  CUtensorMap ts;  // scale [K/128, N] f32, boxes of 64 columns x 4 groups (scale_tma)
  const float* scale;  // [K/128, N]
  __nv_bfloat16* out;  // [M, N]
  int m, n, k;
  int kps;      // K a split (whole stages); the cluster holds nsplit CTAs
  int nsplit;
  int nblocks;  // 64-column blocks
  int scale_tma;  // the scales come by TMA (N % 4 == 0, 16-byte aligned), else by cp.async
  // 0x4B000000, the bits of 2^23, passed in so that the compiler keeps the
  // four nibbles' flip words in registers and masks a nibble in one LOP3
  // (with two immediates it splits the AND and the XOR).
  uint32_t magic;
};

// Arrives on `bar` once this thread's earlier cp.async copies have landed;
// the barrier's count includes the arrival (.noinc).
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Nibble i (0-3) of the half-word in the low 16 bits of h, times s (the
// group scale times 2^(-4i)), as f32: bit for bit f32(n) * scale. flip is
// 0x4B000000 | 8 << 4i.
template <int I>
__device__ __forceinline__ float nibble_times(uint32_t h, uint32_t flip, float s) {
  constexpr float kBias = 8388608.0f + 8.0f * static_cast<float>(1 << (4 * I));
  uint32_t bits;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(bits) : "r"(h), "r"(0xFu << (4 * I)), "r"(flip));
  return __fmul_rn(__fsub_rn(__uint_as_float(bits), kBias), s);
}

// The 8 nibbles of `w` (k 0..7 of the word), dequantized with the scales
// s[i] = scale * 2^(-4i), as four bf16 pairs: o[0] = k 0, 1; o[1] = k 2, 3;
// o[2] = k 4, 5; o[3] = k 6, 7.
__device__ __forceinline__ void q4x8_to_bf16(uint32_t w, const uint32_t (&flip)[4],
                                             const float (&s)[4], uint32_t (&o)[4]) {
  const uint32_t hi = w >> 16;
  o[0] = pack_bf16(nibble_times<0>(w, flip[0], s[0]), nibble_times<1>(w, flip[1], s[1]));
  o[1] = pack_bf16(nibble_times<2>(w, flip[2], s[2]), nibble_times<3>(w, flip[3], s[3]));
  o[2] = pack_bf16(nibble_times<0>(hi, flip[0], s[0]), nibble_times<1>(hi, flip[1], s[1]));
  o[3] = pack_bf16(nibble_times<2>(hi, flip[2], s[2]), nibble_times<3>(hi, flip[3], s[3]));
}

// NT: n8 tiles of x rows (M padded to 8 NT).
template <int NT>
__global__ void __launch_bounds__(kQ4Threads, 1)
    int4_matmul_kernel(const __grid_constant__ Q4Params p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int kMp = 8 * NT;
  constexpr int kStages = ring_stages(kMp);
  constexpr int kXOff = 2 * kWBox;                     // x boxes in a stage
  constexpr int kSOff = 2 * kWBox + kXBoxes * kMp * 128;  // the scales in a stage
  const Q4Smem L(kMp, kStages);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + L.bars, empty = full + 8 * kMaxStages;
  float4* red = reinterpret_cast<float4*>(smem + L.red);
  float* part = reinterpret_cast<float*>(smem + L.part);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = p.nsplit;
  const int rank = c > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int cid = blockIdx.x / c, nclusters = gridDim.x / c;
  const int k0 = rank * p.kps, k1 = min(p.k, k0 + p.kps);
  const int nst = (k1 - k0 + kStageK - 1) / kStageK;  // stages a unit
  const int units = (p.nblocks - cid + nclusters - 1) / nclusters;
  const int total = units * nst;
  const int groups = p.k / kGroup;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the TMA lane's arrival + every producer lane's
      mbar_init(empty + 8 * s, kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer
    // Stage s of the ring, its pass `ph`, unit u, stage ks of the unit.
    for (int it = 0, s = 0, ph = 0, u = 0, ks = 0; it < total; ++it) {
      if (it >= kStages) mbar_wait(empty + 8 * s, ph ^ 1);
      const int col0 = (cid + u * nclusters) * kBlockN;
      const int kk = k0 + ks * kStageK;
      const uint32_t st = sbase + s * L.stage, bar = full + 8 * s;
      if (!p.scale_tma) {  // 4 groups x 64 columns, 8 a lane; zeros past N and K
#pragma unroll
        for (int i = 0; i < kStageGroups * kBlockN / 32; ++i) {
          const int e = i * 32 + lane, grp = kk / kGroup + e / kBlockN, col = col0 + e % kBlockN;
          const bool ok = grp < groups && col < p.n;
          cp_async4(st + kSOff + 4 * e, ok ? p.scale + (long)grp * p.n + col : p.scale, ok);
        }
      }
      cp_async_arrive_noinc(bar);
      if (lane == 0) {  // two boxes of w, eight of x, (one of scales); zeros past N, M and K
        mbar_expect_tx(bar, 2 * kWBox + kXBoxes * kMp * 128 + (p.scale_tma ? kScaleBytes : 0));
        tma_load_2d(st, &p.tw, bar, kk / 2, col0);
        tma_load_2d(st + kWBox, &p.tw, bar, kk / 2 + 128, col0);
#pragma unroll
        for (int bb = 0; bb < kXBoxes; ++bb) {
          tma_load_2d(st + kXOff + bb * kMp * 128, &p.tx, bar, kk + 64 * bb, 0);
        }
        if (p.scale_tma) tma_load_2d(st + kSOff, &p.ts, bar, col0, kk / kGroup);
      }
      __syncwarp();
      if (++s == kStages) s = 0, ph ^= 1;
      if (++ks == nst) ks = 0, ++u;
    }
    if (c > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  // This warp's share of a stage: K part kq (weight box b, half q), column
  // tiles kTiles cg ... of the unit. Lane t's 16 bytes of a weight row are
  // chunk ch = 2t + (q ^ t / 2) of box b: {0, 2, 5, 7} or {1, 3, 4, 6}, so
  // that under the swizzle (chunk ^= row % 8) the chunks of rows g and g + 1
  // fall in disjoint banks; lanes t = 0, 1 read the box's first scale group,
  // t = 2, 3 its second. Its x is box 4b + ch / 2, chunks 4 (ch % 2) + word.
  // Odd lanes take their words in the order 2, 3, 0, 1 (two 8-byte loads,
  // halves swapped), so that the four lanes' x chunks fall in distinct banks.
  // Every offset is the same in each stage.
  const int kq = warp % kKParts, cg = warp / kKParts;
  const int b = kq >> 1, q = kq & 1;
  const int ch = 2 * t + (q ^ (t >> 1));
  const int rot = t & 1;
  const int wrow = cg * kTiles * 16 + g;  // the lane's first weight row of the unit
  uint32_t woff[kTiles][2];
#pragma unroll
  for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      woff[ct][h] = b * kWBox + (wrow + ct * 16 + 8 * h) * 128 + ((ch ^ g) << 4) + 8 * rot;
    }
  const uint32_t soff = kSOff + 4 * ((2 * b + (t >> 1)) * kBlockN + wrow);
  const uint32_t xoff = kXOff + (4 * b + (ch >> 1)) * kMp * 128 + g * 128;
  const int xpos = ((4 * (ch & 1)) | (2 * rot)) ^ g;
  const uint32_t flip[4] = {p.magic | 8u, p.magic | 0x80u, p.magic | 0x800u, p.magic | 0x8000u};
  float acc[kTiles][NT][4];
#pragma unroll
  for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ct][nt][i] = 0.f;

  // Stage s of the ring, its pass `ph`, unit u, stage ks of the unit.
  for (int it = 0, s = 0, ph = 0, u = 0, ks = 0; it < total; ++it) {
    mbar_wait(full + 8 * s, ph);
    // A split is whole stages; past N, M and K the boxes hold zeros.
    const uint8_t* st = smem + s * L.stage;
    float sc[kTiles][2][4];
    uint4 wv[kTiles][2];
#pragma unroll
    for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s0 = *reinterpret_cast<const float*>(st + soff + 4 * (ct * 16 + 8 * h));
        sc[ct][h][0] = s0;
        sc[ct][h][1] = __fmul_rn(s0, 0.0625f);
        sc[ct][h][2] = __fmul_rn(s0, 0.00390625f);
        sc[ct][h][3] = __fmul_rn(s0, 0.000244140625f);
        const uint2 lo = *reinterpret_cast<const uint2*>(st + woff[ct][h]);
        const uint2 hi = *reinterpret_cast<const uint2*>(st + (woff[ct][h] ^ 8));
        wv[ct][h] = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // Word j of each row (after the rotation): sub-steps A (k 0-3) and B (4-7).
      uint32_t a[kTiles][2][4];
#pragma unroll
      for (int ct = 0; ct < kTiles; ++ct) {
        uint32_t lo[4], hi[4];
        q4x8_to_bf16(word_of(wv[ct][0], j), flip, sc[ct][0], lo);  // row g
        q4x8_to_bf16(word_of(wv[ct][1], j), flip, sc[ct][1], hi);  // row g + 8
        a[ct][0][0] = lo[0];
        a[ct][0][1] = hi[0];
        a[ct][0][2] = lo[1];
        a[ct][0][3] = hi[1];
        a[ct][1][0] = lo[2];
        a[ct][1][1] = hi[2];
        a[ct][1][2] = lo[3];
        a[ct][1][3] = hi[3];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 xv =
            *reinterpret_cast<const uint4*>(st + xoff + nt * 8 * 128 + ((xpos ^ j) << 4));
#pragma unroll
        for (int ct = 0; ct < kTiles; ++ct) {
          mma_16816(acc[ct][nt], a[ct][0], xv.x, xv.y);
          mma_16816(acc[ct][nt], a[ct][1], xv.z, xv.w);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (++s == kStages) s = 0, ph ^= 1;
    if (++ks != nst) continue;
    ks = 0;

    // The end of a unit: K parts 1-3 hand their sums to part 0 through
    // shared memory (each lane's accumulators, float4 a tile), which adds
    // them in part order and stores (or, K split, leaves the block's sums
    // for the cluster, which adds the ranks' in rank order).
    const int col0 = (cid + u * nclusters) * kBlockN;
    float4* rw = red + (cg * (kKParts - 1)) * kTiles * NT * 32 + lane;
    if (kq != 0) {
#pragma unroll
      for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          rw[(((kq - 1) * kTiles + ct) * NT + nt) * 32] =
              make_float4(acc[ct][nt][0], acc[ct][nt][1], acc[ct][nt][2], acc[ct][nt][3]);
        }
    }
    named_sync(1, 32 * kConsumers);
    if (kq == 0) {
#pragma unroll
      for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float v[4] = {acc[ct][nt][0], acc[ct][nt][1], acc[ct][nt][2], acc[ct][nt][3]};
#pragma unroll
          for (int w = 1; w < kKParts; ++w) {
            const float4 o = rw[(((w - 1) * kTiles + ct) * NT + nt) * 32];
            v[0] += o.x;
            v[1] += o.y;
            v[2] += o.z;
            v[3] += o.w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = nt * 8 + 2 * t + (i & 1);
            const int col = (cg * kTiles + ct) * 16 + g + 8 * (i >> 1);
            if (c == 1) {
              if (row < p.m && col0 + col < p.n) {
                p.out[(long)row * p.n + col0 + col] = __float2bfloat16(v[i]);
              }
            } else {
              part[row * kBlockN + col] = v[i];
            }
          }
        }
    }
#pragma unroll
    for (int ct = 0; ct < kTiles; ++ct)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[ct][nt][i] = 0.f;
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
        p.out[(long)row * p.n + col0 + col] = __float2bfloat16(v);
      }
    }
    ++u;
  }
  if (c > 1) cluster_sync();  // no CTA leaves while another reads it
}

template <int NT>
cudaError_t launch_nt(const Q4Params& p, cudaStream_t st) {
  constexpr int kMp = 8 * NT;
  constexpr int bytes = Q4Smem(kMp, ring_stages(kMp)).bytes;
  static_assert(ring_stages(kMp) >= 2, "a ring of at least two stages");
  static_assert(bytes <= kSmemBytes, "shared memory");
  return launch_units<int4_matmul_kernel<NT>>(p, kQ4Threads, bytes, p.nsplit, p.nblocks, st);
}

// scale [groups, n] f32 as a 2-D tensor map read in boxes of 64 columns x 4
// groups (no swizzle), zeros past its bounds.
cudaError_t encode_scales(CUtensorMap* map, const void* base, int groups, int n) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)groups};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBlockN, (cuuint32_t)kStageGroups};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace radvlm

// nsplit: the K splits, one CTA of a thread-block cluster each (1-8);
// k_per_split: K a split, a multiple of 512 (whole stages, so whole scale
// groups). part:
// unused (the splits are summed inside the cluster), must be null. x and w
// are read by TMA: their bases must be 16-byte aligned (K, a multiple of
// 128, keeps every row so).
extern "C" int radvlm_int4_matmul(const void* x, const void* w, const void* scale,
                                  void* out, void* part, int m, int n, int k,
                                  int nsplit, int k_per_split, void* stream) {
  using namespace radvlm;
  if (m < 1 || m > 64 || n < 1 || k < kGroup || k % kGroup != 0 || nsplit < 1 ||
      nsplit > kMaxCluster || k_per_split < kStageK || k_per_split % kStageK != 0 ||
      static_cast<long>(nsplit) * k_per_split < k ||
      static_cast<long>(nsplit - 1) * k_per_split >= k || part != nullptr ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scale) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Q4Params p = {};
  const int nt = (m + 7) / 8;
  cudaError_t err = encode_2d(&p.tw, w, false, n, k / 2, kBlockN);
  if (err == cudaSuccess) err = encode_2d(&p.tx, x, true, m, k, 8 * nt);
  p.scale_tma = n % 4 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  if (err == cudaSuccess && p.scale_tma) err = encode_scales(&p.ts, scale, k / kGroup, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.n = n;
  p.k = k;
  p.kps = k_per_split;
  p.nsplit = nsplit;
  p.nblocks = (n + kBlockN - 1) / kBlockN;
  p.magic = 0x4B000000u;
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
