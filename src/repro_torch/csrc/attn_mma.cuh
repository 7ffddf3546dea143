// mma.sync helpers shared by the attention kernels (flash_attention.cu,
// paged_gqa_verify.cu, paged_mla_verify.cu): ldmatrix loads of bf16 tiles
// in shared memory, bf16 packing, the hi + lo split of f32 values, and the
// fold of online-softmax partials.
#pragma once

#include "nm_mma.cuh"

namespace attn {

using bf16 = __nv_bfloat16;
using nm::mma::commit;
using nm::mma::cp16;
using nm::mma::mma_bf16;
using nm::mma::smem_addr;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// lanes 0-7 address the rows of the first 8x8 matrix, 8-15 the second
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) = hi + lo, hi = bf16(x, y) and lo = bf16 of the remainder: two
// bf16 mma on hi and lo carry about 16 bits of an f32 operand
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// Fold a partial of max mc into a running max m: the running state then
// scales by *sa, the partial by *sb, and m becomes the larger max.  From
// the empty state (m = -1e30, l = acc = 0) the fold copies the partial.
__device__ __forceinline__ void merge_weights(float& m, float mc, float* sa,
                                              float* sb) {
  const float mn = fmaxf(m, mc);
  *sa = exp2f((m - mn) * kLog2e);
  *sb = exp2f((mc - mn) * kLog2e);
  m = mn;
}

}  // namespace attn
