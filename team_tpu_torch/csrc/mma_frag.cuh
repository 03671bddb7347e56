// Warp-level tensor-core pieces for Hopper (sm_90a): the bf16 and s8 mma,
// ldmatrix and cp.async, with no tile or launch constants, so that any source of this
// directory can include it beside its own (csrc/attn_block.cu beside
// attention_common.cuh).
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for lane
// l with g = l / 4 and t = l % 4:
//   A (16 x 16): a0 = row g, cols 2t and 2t+1; a1 = row g+8, the same cols;
//                a2 = row g, cols 2t+8 and 2t+9; a3 = row g+8, the same;
//   B (16 x 8, the "col" operand, stored [n][k]): b0 = col g, k 2t and 2t+1;
//                b1 = col g, k 2t+8 and 2t+9;
//   C (16 x 8, f32): c0, c1 = row g, cols 2t and 2t+1; c2, c3 = row g+8.
// Each 32-bit register holds two bf16, the lower column in the low half.
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes, 16-byte aligned) and receives from each
// matrix the two values of row l / 4 at columns 2(l % 4) and 2(l % 4) + 1
// (.trans: of column l / 4 at rows 2(l % 4) and 2(l % 4) + 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma_frag {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, an exact int32 sum: A (16 x
// 32 s8) a0 = row g, cols 4t..4t+3; a1 = row g+8, the same cols; a2, a3 = rows
// g, g+8, cols 16+4t..16+4t+3; B (32 x 8, stored [n][k]) b0 = col g, k 4t..4t+3;
// b1 = col g, k 16+4t..16+4t+3; C as the bf16 form's, in int32. Each register
// holds four s8, the lowest column in the low byte. ldmatrix's 8 x 8 b16
// matrix of 8 rows of 16 bytes is one s8 B register (or A register) as it stands.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the .x2 forms: two matrices, addressed by lanes 0-15 (the others' ignored)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16 bytes from device to shared memory, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n of this thread's committed groups are still in flight
// (n is clamped to 0..4: the instruction takes an immediate)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else if (n == 2) {
    asm volatile("cp.async.wait_group 2;\n" ::);
  } else if (n == 3) {
    asm volatile("cp.async.wait_group 3;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 4;\n" ::);
  }
}

// two floats rounded to bf16 (round to nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

}  // namespace mma_frag
