// int8 quantize producers of the int8 tiers, for Hopper (sm_90a).
//
// Replaces three TPU kernels of team_tpu/ops/int8_matmul.py:
//   _ln_quant_static_kernel  (entry ln_quantize_static, :382) -> team_ln_quantize_static
//   _row_quant_static_kernel (entry row_quant_static,   :464) -> team_row_quant_static
//   _ln_quant_kernel         (entry ln_quantize,        :337) -> team_ln_quantize
// and serves a fourth, _ln_quant_static3_kernel (ln_quantize_static3, :427),
// through team_ln_quantize_static on the contiguous [B*S, D] view of its
// [B, S, D] input. Each reads a bf16 activation [M, D] once and writes int8
// [M, D] once:
//   ln_quantize_static: mean and variance in f32 in two passes over the row
//   (jnp.mean, then jnp.var = mean((x - mean)^2)), y = (x - mean) *
//   rsqrt(var + 1e-5), y = y * gamma + beta, y = y * inv_a (the calibrated
//   per-channel scale, folded into the next GEMM's weight), each product and
//   sum rounded on its own as the TPU kernel writes them (__fmul_rn,
//   __fadd_rn: nvcc would contract a*b + c into one FMA), rsqrt as an IEEE
//   square root and division;
//   ln_quantize (the dynamic tiers): the same layer norm without inv_a, then
//   the row's amax, s = amax * f32(1/127) (1 where amax = 0), y / s as an IEEE
//   division; it also writes s [M] float32;
//   row_quant_static: y = float(x) * inv_a;
// then rint (half to even, as jnp.round), clipped to +-127. The TPU wrappers
// pad M to a multiple of their 512-row block and slice the result; here the
// ragged edge is masked by index and nothing is copied.
//
// Layout: the layer norms give each row of D <= 1024 to one warp (at the
// ViT-B/16 width of 768, 24 values a lane, read as three 16-byte words of
// eight bf16); the sums and the amax are warp shuffles, so the row is read
// from device memory once and stays in registers. The quantize is a flat
// elementwise pass: each thread reads 16 bytes (eight bf16) and writes 8.
//
// What bounds them on an H100: bytes. At M = 25,216 rows (B=128, S=197) and
// D=768 each moves 38.7 MB of bf16 in and 19.4 MB of int8 out, 0.0173 ms at
// 3.35 TB/s; their arithmetic (about 15 operations an element for the
// layer norm) is far below the card's rate. The design reads and writes each
// byte once, with 16-byte loads and 8-byte stores, so that the memory
// system, not the instruction issue, is the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;      // rows per block of the layer norm
constexpr int kMaxChunks = 4;  // 16-byte words a lane holds: D <= 4 * 32 * 8
constexpr int kThreads = 256;  // threads per block of the quantize
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t quant_byte(float y) {
  const float r = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(r)));
}

// eight bf16 from one 16-byte word
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// eight float32 from two 16-byte words
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// quantize eight values and store them as one 8-byte word
__device__ __forceinline__ void store8(int8_t* p, const float (&y)[8]) {
  uint2 w;
  w.x = quant_byte(y[0]) | quant_byte(y[1]) << 8 | quant_byte(y[2]) << 16 | quant_byte(y[3]) << 24;
  w.y = quant_byte(y[4]) | quant_byte(y[5]) << 8 | quant_byte(y[6]) << 16 | quant_byte(y[7]) << 24;
  *reinterpret_cast<uint2*>(p) = w;
}

// the row's values (v, kMaxChunks words of eight a lane), its mean and
// 1/sqrt(var + 1e-5), both sums in f32 over the warp
__device__ __forceinline__ void row_stats(const __nv_bfloat16* xr, int d, int lane,
                                          float (&v)[kMaxChunks][8], float& mean, float& rstd) {
  const float n = static_cast<float>(d);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < d) {
      load8(xr + col, v[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = __fadd_rn(sum, v[c][i]);
    }
  }
  mean = __fdiv_rn(warp_sum(sum), n);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if ((c * 32 + lane) * 8 < d) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = __fsub_rn(v[c][i], mean);
        sq = __fadd_rn(sq, __fmul_rn(t, t));
      }
    }
  }
  const float var = __fdiv_rn(warp_sum(sq), n);
  rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
}

__global__ void __launch_bounds__(kWarps * 32)
ln_quant_static_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ inv_a,
                       int8_t* __restrict__ q, int rows, int d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the ragged edge
  float v[kMaxChunks][8], mean, rstd;
  row_stats(x + static_cast<size_t>(row) * d, d, lane, v, mean, rstd);

  int8_t* qr = q + static_cast<size_t>(row) * d;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < d) {
      float g[8], b[8], a[8], y[8];
      load8(gamma + col, g);
      load8(beta + col, b);
      load8(inv_a + col, a);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = __fmul_rn(__fsub_rn(v[c][i], mean), rstd);
        y[i] = __fmul_rn(__fadd_rn(__fmul_rn(t, g[i]), b[i]), a[i]);
      }
      store8(qr + col, y);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
ln_quant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, int8_t* __restrict__ q, float* __restrict__ s,
                int rows, int d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the ragged edge
  float v[kMaxChunks][8], mean, rstd;
  row_stats(x + static_cast<size_t>(row) * d, d, lane, v, mean, rstd);

  float amax = 0.f;  // y replaces x in v
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < d) {
      float g[8], b[8];
      load8(gamma + col, g);
      load8(beta + col, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = __fmul_rn(__fsub_rn(v[c][i], mean), rstd);
        v[c][i] = __fadd_rn(__fmul_rn(t, g[i]), b[i]);
        amax = fmaxf(amax, fabsf(v[c][i]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  if (lane == 0) s[row] = scale;

  int8_t* qr = q + static_cast<size_t>(row) * d;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < d) {
      float y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __fdiv_rn(v[c][i], scale);
      store8(qr + col, y);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
row_quant_static_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ inv_a,
                        int8_t* __restrict__ q, size_t words, int words_per_row) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < words;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(i % words_per_row) * 8;
    float v[8], a[8], y[8];
    load8(x + i * 8, v);
    load8(inv_a + col, a);
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = __fmul_rn(v[k], a[k]);
    store8(q + i * 8, y);
  }
}

bool shape_ok(int rows, int d) { return rows >= 0 && d > 0 && d % 8 == 0; }

}  // namespace

// The widest row the layer norm takes.
extern "C" int team_ln_quantize_static_max_width() { return kMaxChunks * 32 * 8; }

// Pointers are device pointers: x bf16 [rows, d] (16-byte aligned); gamma,
// beta, inv_a float32 [d] (16-byte aligned); q int8 [rows, d] (8-byte
// aligned); d a multiple of 8, at most team_ln_quantize_static_max_width().
// Returns the cudaError_t of the launch (0 on success).
extern "C" int team_ln_quantize_static(const void* x, const void* gamma, const void* beta,
                                       const void* inv_a, void* q, int rows, int d,
                                       void* stream) {
  if (!shape_ok(rows, d) || d > kMaxChunks * 32 * 8) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  ln_quant_static_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(inv_a),
      static_cast<int8_t*>(q), rows, d);
  return cudaGetLastError();
}

// x bf16 [rows, d] (16-byte aligned); inv_a float32 [d] (16-byte aligned);
// q int8 [rows, d] (8-byte aligned); d a multiple of 8.
extern "C" int team_row_quant_static(const void* x, const void* inv_a, void* q, int rows, int d,
                                     void* stream) {
  if (!shape_ok(rows, d)) return cudaErrorInvalidValue;
  const size_t words = static_cast<size_t>(rows) * (d / 8);
  if (words == 0) return cudaSuccess;
  const size_t want = (words + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 64 ? want : 132 * 64);
  row_quant_static_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(inv_a),
      static_cast<int8_t*>(q), words, d / 8);
  return cudaGetLastError();
}

// x bf16 [rows, d] (16-byte aligned); gamma, beta float32 [d] (16-byte
// aligned); q int8 [rows, d] (8-byte aligned); s float32 [rows]; d a multiple
// of 8, at most team_ln_quantize_static_max_width().
extern "C" int team_ln_quantize(const void* x, const void* gamma, const void* beta, void* q,
                                void* s, int rows, int d, void* stream) {
  if (!shape_ok(rows, d) || d > kMaxChunks * 32 * 8) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  ln_quant_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<int8_t*>(q), static_cast<float*>(s), rows, d);
  return cudaGetLastError();
}
