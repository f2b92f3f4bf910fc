// K4 and K11: the entry points over the int8 cache (the kernel and its
// design in decode_attention.cuh).

#include "decode_attention.cuh"

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
// Limits: D a multiple of 16 and <= 256, H / Hkv <= 8, a 16-byte aligned cache.
extern "C" int radvlm_decode_attention_q8(const void* q, const void* ck, const void* cv,
                                          const void* ksc, const void* vsc,
                                          const void* seg, void* part_o, void* part_ml,
                                          void* out, int b, int s, int h, int hkv,
                                          int d, int nsplit, int chunk, float scale,
                                          void* stream) {
  using namespace radvlm;
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxDWide ||
      d % 16 != 0 || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_partial<kK9Threads, 2, false, true>(
      q, ck, cv, ksc, vsc, seg, nullptr, part_o, part_ml, out, b, s, h, hkv, d, 1, 1, nsplit,
      chunk, scale, static_cast<cudaStream_t>(stream));
}

// K11: K10 over the int8 cache (its comment in decode_attention.cu).
extern "C" int radvlm_decode_attention_window_q8(const void* q, const void* ck, const void* cv,
                                                 const void* ksc, const void* vsc,
                                                 const void* seg, const void* widx,
                                                 void* part_o, void* part_ml, void* out, int b,
                                                 int s, int h, int hkv, int d, int w,
                                                 int nsplit, int chunk, float scale,
                                                 void* stream) {
  using namespace radvlm;
  if (hkv <= 0 || h % hkv != 0 || h / hkv > kMaxGroup || d > kMaxDWide || d % 16 != 0 || w < 1 ||
      w > kMaxWindow || nsplit <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_window<true>(q, ck, cv, ksc, vsc, seg, widx, part_o, part_ml, out, b, s, h, hkv,
                             d, w, nsplit, chunk, scale, static_cast<cudaStream_t>(stream));
}
