// K9 and K10: the entry points over the bf16 cache (the kernel and its
// design in decode_attention.cuh).

#include "decode_attention.cuh"

extern "C" int radvlm_decode_attention(const void* q, const void* ck,
                                       const void* cv, const void* seg,
                                       void* part_o, void* part_ml, void* out,
                                       int b, int s, int h, int hkv, int d,
                                       int nsplit, int chunk, float scale,
                                       void* stream) {
  using namespace radvlm;
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxDWide ||
      d % 2 != 0 || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_partial<kK9Threads, 2, false, false>(
      q, ck, cv, nullptr, nullptr, seg, nullptr, part_o, part_ml, out, b, s, h, hkv, d, 1, 1,
      nsplit, chunk, scale, static_cast<cudaStream_t>(stream));
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
// Limits: 1 <= W <= 16, H / Hkv <= 8, D <= 256 (even, a multiple of 8
// above 128; a multiple of 16 for the int8 cache). Both take W x g rows a
// CTA in the buckets of launch_window.
extern "C" int radvlm_decode_attention_window(const void* q, const void* ck, const void* cv,
                                              const void* seg, const void* widx,
                                              void* part_o, void* part_ml, void* out, int b,
                                              int s, int h, int hkv, int d, int w, int nsplit,
                                              int chunk, float scale, void* stream) {
  using namespace radvlm;
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxDWide || d % 2 != 0 || w < 1 ||
      w > kMaxWindow || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_window<false>(q, ck, cv, nullptr, nullptr, seg, widx, part_o, part_ml, out, b,
                              s, h, hkv, d, w, nsplit, chunk, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* radvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
