// The int8 GEMMs' epilogue arithmetic, shared by csrc/int8_gemm.cu's kernels:
// both gelu_quant kernels (mma.sync and wgmma) take it from here, so their q
// and s agree bit for bit by construction. Every product and sum is rounded
// on its own in the TPU kernel's order (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc
// would contract a*b + c into one FMA).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;

// jax.nn.gelu(approximate=True) and torch's gelu(approximate="tanh"):
// 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float beta = 0.7978845608028654f, kappa = 0.044715f;
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(beta, __fadd_rn(x, __fmul_rn(kappa, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

__device__ __forceinline__ float dequant(int acc, float xs, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), b);
}

// a block's scale from the largest |y| of its row: amax * f32(1/127), 1 where amax = 0
__device__ __forceinline__ float quant_scale(float amax) {
  return amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
}

__device__ __forceinline__ int8_t quant_step(float y, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f));
}

}  // namespace
