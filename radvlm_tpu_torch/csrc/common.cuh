// Shared device helpers for the port's kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace radvlm {

// Two floats -> one 32-bit register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two raw bf16 values (as stored) -> one 32-bit register, lo in the low half.
__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16& lo,
                                             const __nv_bfloat16& hi) {
  uint32_t a = *reinterpret_cast<const unsigned short*>(&lo);
  uint32_t b = *reinterpret_cast<const unsigned short*>(&hi);
  return a | (b << 16);
}

// Word j (0-3) of a 16-byte vector.
__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// d += A(16x16, row-major) * B(16x8, col-major); bf16 inputs, f32 sums.
// Fragment layout (g = lane / 4, t = lane % 4):
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..]   a[2] = A[g][2t+8..]
//   a[3] = A[g+8][2t+8..]   b0 = B[2t..2t+1][g]   b1 = B[2t+8..][g]
//   d[0..1] = D[g][2t..2t+1]                       d[2..3] = D[g+8][2t..]
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (one word, byte 0 first) -> two bf16 pairs, exact: lo = bytes
// 0, 1 and hi = bytes 2, 3. Byte v + 128 goes into the low mantissa byte of
// 2^23 (bits 0x4B0000uu), 2^23 + 128 comes off, and the upper halves of two
// such floats are the bf16 pair (|v| <= 128 needs 8 significant bits).
__device__ __forceinline__ void i8x4_to_bf16(uint32_t word, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)), 8388736.f);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)), 8388736.f);
  const float f2 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)), 8388736.f);
  const float f3 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)), 8388736.f);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

}  // namespace radvlm
