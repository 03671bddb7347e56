// The bf16 towers' elementwise work around their GEMMs, for Hopper (sm_90a).
//
// Replaces no TPU kernel: team_tpu leaves this work to XLA, which fuses it
// into its dots and layer-norm fusions. The port ran it as PyTorch's eager
// composition (backbone/clip.py: _layer_norm, _linear, _residual, F.gelu),
// about 35 elementwise launches a block, most of them reading and writing
// float32 copies of the residual stream. Three kernels take it over, each
// reading its inputs once, computing in float32 registers and writing its
// bf16 outputs once:
//   team_bias_act: y <- bf16(act(bf16(y + b))) in place over a GEMM's bf16
//     output [M, N] and a bf16 bias [N]; act none (the qkv bias), the erf
//     GELU (F.gelu's approximate="none": CLIP) or the tanh GELU (SigLIP);
//   team_residual_ln: x' = bf16(bf16(x + y) + b), the order of clip._residual
//     (x + h @ w + b), written over y; optionally in the same pass h =
//     bf16(LN(x') * gamma + beta), float32 statistics (population variance),
//     the given eps and float32 gamma, beta: the attention half's residual
//     with its block's LN2, the MLP half's with the next block's LN1;
//   team_layer_norm: h = bf16(LN(x) * gamma + beta) over rows ldx apart
//     (ln_pre, a first LN1, ln_post on the CLS rows x[:, 0], the heads').
// Every bf16 add is done in float32 and rounded where the eager ops round, and
// the GELU is PyTorch's own float formula with its constants (its CUDA
// kernel's, ActivationGeluKernel.cu), so bias, GELU and residual are the
// composition's bits. The layer norm sums in another order than PyTorch's
// reductions (mean by a warp's shuffles, the variance in two passes, not
// Welford's), so its output may sit one bf16 step off the composition's
// where the float32 value lies at a rounding edge; its affine is the
// composition's: ((x - mean) * rstd) * gamma + beta, each step rounded on its
// own (__fmul_rn, __fadd_rn: nvcc would contract a*b + c into one FMA, which
// PyTorch's separate kernels do not).
//
// What bounds them on an H100: bytes. Their arithmetic (about 10 operations
// an element, the GELU about 30) is far below the card's rate. At ViT-B/16's
// B=128 (M = 25,216 rows) a block's four passes move 852 MB, 0.254 ms at
// 3.35 TB/s; at SigLIP So400m/14-384's (M = 93,312, D 1152, MLP 4304) 4,616 MB.
// The design reads and writes each byte once with 16-byte loads and stores:
// - bias_act is a flat pass: each thread owns eight consecutive columns,
//   keeps their bias in registers and walks rows a fixed stride apart, four
//   rows' loads in flight, one full wave of blocks (the occupancy API);
// - the row kernels give each row to one warp, held in registers as CH
//   16-byte words a lane (D = 512, 768, 1152: 2, 3 and 5 words, 1152's last
//   word masked on half the lanes), the sums by warp shuffles, rows a grid's
//   warps apart, one full wave; the block's bias, gamma and beta in shared
//   memory as float32; the statistics are rows_common.cuh's row_stats (two
//   passes, rsqrtf), which the int8 layer norms share.

#include "rows_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFlatThreads = 256;
constexpr int kFlatRows = 4;  // rows whose loads a bias_act thread has in flight
constexpr int kRowWarps = 8;  // warps, each a row at a time, of a row kernel's block
constexpr int kMaxWords = 8;  // 16-byte words a lane holds: D <= 8 * 32 * 8

enum Act { kActNone = 0, kActGeluErf = 1, kActGeluTanh = 2 };

// F.gelu(approximate="none") on CUDA: x * 0.5 * (1 + erf(x * M_SQRT1_2)) in float
__device__ __forceinline__ float gelu_erf(float x) {
  constexpr float kAlpha = static_cast<float>(0.70710678118654752440);
  return x * 0.5f * (1.f + erff(x * kAlpha));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kActGeluErf) return gelu_erf(v);
  if (ACT == kActGeluTanh) return gelu_tanh(v);
  return v;
}

// Thread t owns columns [8g, 8g + 8) with g = t % groups and the rows
// t / groups + k * row_step; row_step * groups threads run.
template <int ACT>
__global__ void __launch_bounds__(kFlatThreads)
bias_act_kernel(bf16* __restrict__ y, const bf16* __restrict__ bias, int rows, int groups,
                int row_step) {
  const int t = blockIdx.x * kFlatThreads + threadIdx.x;
  const int col = (t % groups) * 8;
  const int row0 = t / groups;
  if (row0 >= row_step) return;
  const size_t n = static_cast<size_t>(groups) * 8;
  float b[8];
  load8(bias + col, b);
  for (int row = row0; row < rows; row += kFlatRows * row_step) {
    uint4 raw[kFlatRows];
#pragma unroll
    for (int u = 0; u < kFlatRows; ++u) {
      const int r = row + u * row_step;
      if (r < rows) raw[u] = *reinterpret_cast<const uint4*>(y + r * n + col);
    }
#pragma unroll
    for (int u = 0; u < kFlatRows; ++u) {
      const int r = row + u * row_step;
      if (r < rows) {
        float v[8];
        unpack8(raw[u], v);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = activate<ACT>(round_bf16(__fadd_rn(v[i], b[i])));
        *reinterpret_cast<uint4*>(y + r * n + col) = pack8(v);
      }
    }
  }
}

// h = bf16(((v - mean) * rstd) * gamma + beta), gamma and beta in shared memory
template <int CH>
__device__ __forceinline__ void store_norm(const float (&v)[CH][8], float mean, float rstd,
                                           const float* sg, const float* sb, bf16* h, int d,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < d) {
      float g[8], b[8], o[8];
      load8(sg + col, g);
      load8(sb + col, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c][i], mean), rstd), g[i]), b[i]);
      *reinterpret_cast<uint4*>(h + col) = pack8(o);
    }
  }
}

// gamma and beta (and a bf16 bias) of `d` columns into the block's shared memory
__device__ __forceinline__ void stage_vectors(const float* gamma, const float* beta,
                                              const bf16* bias, float* sg, float* sb, float* sbias,
                                              int d) {
  for (int col = threadIdx.x; col < d; col += kRowWarps * 32) {
    if (gamma != nullptr) {
      sg[col] = gamma[col];
      sb[col] = beta[col];
    }
    if (bias != nullptr) sbias[col] = __bfloat162float(bias[col]);
  }
  __syncthreads();
}

template <int CH, bool LN>
__global__ void __launch_bounds__(kRowWarps * 32)
residual_ln_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, const bf16* __restrict__ bias,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   bf16* __restrict__ h, int rows, int d, float eps) {
  __shared__ __align__(16) float sbias[CH * 256];
  __shared__ __align__(16) float sg[LN ? CH * 256 : 1];
  __shared__ __align__(16) float sb[LN ? CH * 256 : 1];
  stage_vectors(LN ? gamma : nullptr, beta, bias, sg, sb, sbias, d);
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kRowWarps) {
    const size_t off = static_cast<size_t>(row) * d;
    uint4 xr[CH], yr[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * 32 + lane) * 8;
      if (col < d) {
        xr[c] = *reinterpret_cast<const uint4*>(x + off + col);
        yr[c] = *reinterpret_cast<const uint4*>(y + off + col);
      }
    }
    float v[1][CH][8];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * 32 + lane) * 8;
      if (col < d) {
        float a[8], p[8], b[8];
        unpack8(xr[c], a);
        unpack8(yr[c], p);
        load8(sbias + col, b);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[0][c][i] = round_bf16(__fadd_rn(round_bf16(__fadd_rn(a[i], p[i])), b[i]));
        *reinterpret_cast<uint4*>(y + off + col) = pack8(v[0][c]);
      }
    }
    if (LN) {
      float mean[1], rstd[1];
      row_stats<1, CH, kStatsTwoPass>(v, d, 1, lane, eps, mean, rstd);
      store_norm<CH>(v[0], mean[0], rstd[0], sg, sb, h + off, d, lane);
    }
  }
}

template <int CH>
__global__ void __launch_bounds__(kRowWarps * 32)
layer_norm_kernel(const bf16* __restrict__ x, long long ldx, const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ h, int rows, int d,
                  float eps) {
  __shared__ __align__(16) float sg[CH * 256];
  __shared__ __align__(16) float sb[CH * 256];
  stage_vectors(gamma, beta, nullptr, sg, sb, nullptr, d);
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kRowWarps) {
    float v[1][CH][8], mean[1], rstd[1];
    load_rows<1, CH>(x + static_cast<size_t>(row) * ldx, ldx, d, 1, lane, v);
    row_stats<1, CH, kStatsTwoPass>(v, d, 1, lane, eps, mean, rstd);
    store_norm<CH>(v[0], mean[0], rstd[0], sg, sb, h + static_cast<size_t>(row) * d, d, lane);
  }
}

template <int ACT>
void launch_bias_act(cudaStream_t stream, bf16* y, const bf16* bias, int rows, int n) {
  unsigned blocks;
  const int step = flat_grid<bias_act_kernel<ACT>>(rows, n / 8, kFlatThreads, blocks);
  bias_act_kernel<ACT><<<blocks, kFlatThreads, 0, stream>>>(y, bias, rows, n / 8, step);
}

// a row kernel's grid: a warp a row, at most one full wave of blocks
template <auto kernel>
unsigned row_blocks(int rows) {
  return wave_blocks<kernel>((rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32);
}

template <int CH>
void launch_residual_ln(cudaStream_t stream, const bf16* x, bf16* y, const bf16* bias,
                        const float* gamma, const float* beta, bf16* h, int rows, int d,
                        float eps) {
  if (gamma != nullptr) {
    residual_ln_kernel<CH, true><<<row_blocks<residual_ln_kernel<CH, true>>(rows),
                                   kRowWarps * 32, 0, stream>>>(x, y, bias, gamma, beta, h,
                                                                rows, d, eps);
  } else {
    residual_ln_kernel<CH, false><<<row_blocks<residual_ln_kernel<CH, false>>(rows),
                                    kRowWarps * 32, 0, stream>>>(x, y, bias, gamma, beta, h,
                                                                 rows, d, eps);
  }
}

template <int CH>
void launch_layer_norm(cudaStream_t stream, const bf16* x, long long ldx, const float* gamma,
                       const float* beta, bf16* h, int rows, int d, float eps) {
  layer_norm_kernel<CH><<<row_blocks<layer_norm_kernel<CH>>(rows), kRowWarps * 32, 0, stream>>>(
      x, ldx, gamma, beta, h, rows, d, eps);
}

bool width_ok(int rows, int d) { return rows >= 0 && d > 0 && d % 8 == 0; }

}  // namespace

// The widest row the row kernels take.
extern "C" int team_tower_bf16_max_width() { return kMaxWords * 32 * 8; }

// y bf16 [rows, n] (16-byte aligned, contiguous), written in place; bias
// bf16 [n] (16-byte aligned); n a multiple of 8; act 0 (none), 1 (erf GELU),
// 2 (tanh GELU). Returns the cudaError_t of the launch (0 on success).
extern "C" int team_bias_act(void* y, const void* bias, int rows, int n, int act, void* stream) {
  if (!width_ok(rows, n) || act < kActNone || act > kActGeluTanh) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto* yp = static_cast<bf16*>(y);
  const auto* b = static_cast<const bf16*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  if (act == kActGeluErf) {
    launch_bias_act<kActGeluErf>(st, yp, b, rows, n);
  } else if (act == kActGeluTanh) {
    launch_bias_act<kActGeluTanh>(st, yp, b, rows, n);
  } else {
    launch_bias_act<kActNone>(st, yp, b, rows, n);
  }
  return cudaGetLastError();
}

// x, y bf16 [rows, d] (16-byte aligned, contiguous), x' written over y; bias
// bf16 [d]; gamma, beta float32 [d], or both null for no layer norm; h bf16
// [rows, d] (16-byte aligned, contiguous) where gamma is given; d a multiple
// of 8, at most team_tower_bf16_max_width().
extern "C" int team_residual_ln(const void* x, void* y, const void* bias, const void* gamma,
                                const void* beta, void* h, int rows, int d, float eps,
                                void* stream) {
  if (!width_ok(rows, d) || d > kMaxWords * 256) return cudaErrorInvalidValue;
  if ((gamma == nullptr) != (beta == nullptr) || (gamma != nullptr && h == nullptr))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto* xp = static_cast<const bf16*>(x);
  auto* yp = static_cast<bf16*>(y);
  const auto* b = static_cast<const bf16*>(bias);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto* hp = static_cast<bf16*>(h);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((d + 255) / 256) {
    case 1: launch_residual_ln<1>(st, xp, yp, b, g, be, hp, rows, d, eps); break;
    case 2: launch_residual_ln<2>(st, xp, yp, b, g, be, hp, rows, d, eps); break;
    case 3: launch_residual_ln<3>(st, xp, yp, b, g, be, hp, rows, d, eps); break;
    case 4: launch_residual_ln<4>(st, xp, yp, b, g, be, hp, rows, d, eps); break;
    case 5: launch_residual_ln<5>(st, xp, yp, b, g, be, hp, rows, d, eps); break;
    case 6: launch_residual_ln<6>(st, xp, yp, b, g, be, hp, rows, d, eps); break;
    default: launch_residual_ln<kMaxWords>(st, xp, yp, b, g, be, hp, rows, d, eps); break;
  }
  return cudaGetLastError();
}

// x bf16 [rows, d] with rows ldx elements apart (16-byte aligned, ldx a
// multiple of 8, at least d); gamma, beta float32 [d]; h bf16 [rows, d]
// (16-byte aligned, contiguous); d a multiple of 8, at most
// team_tower_bf16_max_width().
extern "C" int team_layer_norm(const void* x, long long ldx, const void* gamma, const void* beta,
                               void* h, int rows, int d, float eps, void* stream) {
  if (!width_ok(rows, d) || d > kMaxWords * 256 || ldx < d || ldx % 8) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto* hp = static_cast<bf16*>(h);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((d + 255) / 256) {
    case 1: launch_layer_norm<1>(st, xp, ldx, g, be, hp, rows, d, eps); break;
    case 2: launch_layer_norm<2>(st, xp, ldx, g, be, hp, rows, d, eps); break;
    case 3: launch_layer_norm<3>(st, xp, ldx, g, be, hp, rows, d, eps); break;
    case 4: launch_layer_norm<4>(st, xp, ldx, g, be, hp, rows, d, eps); break;
    case 5: launch_layer_norm<5>(st, xp, ldx, g, be, hp, rows, d, eps); break;
    case 6: launch_layer_norm<6>(st, xp, ldx, g, be, hp, rows, d, eps); break;
    default: launch_layer_norm<kMaxWords>(st, xp, ldx, g, be, hp, rows, d, eps); break;
  }
  return cudaGetLastError();
}
