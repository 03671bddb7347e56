// Helpers shared by the row and elementwise kernels of this directory
// (int8_quant.cu, tower_bf16.cu), for Hopper (sm_90a):
//   - warp sums, and eight values from 16-byte words;
//   - PyTorch's tanh GELU in its own float formula;
//   - a layer norm's row statistics, the mean and 1/sqrt(var + eps), over
//     rows a warp holds in registers, in the three arithmetics the kernels
//     use (LnStats);
//   - the grids: one full wave of blocks, sized by the occupancy API.
//
// Nothing here allocates or launches. The sources are compiled on their own
// (one nvcc each), so the helpers live in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// PyTorch's tanh GELU (F.gelu(approximate="tanh") on CUDA) in its order and
// its float constants; nvcc contracts it as it does PyTorch's kernel
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

// How a layer norm takes its rows' statistics, the mean and 1/sqrt(var + eps):
enum LnStats {
  kStatsExact = 0,    // #22-#25: two passes, 1/sqrt as an IEEE square root and division
  kStatsTwoPass = 1,  // two passes, rsqrtf (_ln_quant3's; the bf16 towers' layer norms)
  kStatsOnePass = 2,  // _ln_quant3's one pass, var = max(E[x^2] - E[x]^2, 0), rsqrtf
};

// ROWS rows of a warp, `ld` elements apart (those at or past `valid`
// skipped), CH words of eight a lane (those at or past `d` skipped), into v
template <int ROWS, int CH>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* x, size_t ld, int d, int valid,
                                          int lane, float (&v)[ROWS][CH][8]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * 32 + lane) * 8;
      if (r < valid && col < d) load8(x + r * ld + col, v[r][c]);
    }
  }
}

// The means and 1/sqrt(var + eps) of the ROWS rows a warp holds in v (as
// load_rows lays them out), both sums in f32 over the warp, each product
// and sum rounded on its own
template <int ROWS, int CH, int STATS>
__device__ __forceinline__ void row_stats(const float (&v)[ROWS][CH][8], int d, int valid,
                                          int lane, float eps, float (&mean)[ROWS],
                                          float (&rstd)[ROWS]) {
  const float n = static_cast<float>(d);
  float sum[ROWS], sq[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    sum[r] = 0.f;
    sq[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (r < valid && (c * 32 + lane) * 8 < d) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sum[r] = __fadd_rn(sum[r], v[r][c][i]);
          if (STATS == kStatsOnePass) sq[r] = __fadd_rn(sq[r], __fmul_rn(v[r][c][i], v[r][c][i]));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) mean[r] = __fdiv_rn(warp_sum(sum[r]), n);
  if (STATS != kStatsOnePass) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (r < valid && (c * 32 + lane) * 8 < d) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float t = __fsub_rn(v[r][c][i], mean[r]);
            sq[r] = __fadd_rn(sq[r], __fmul_rn(t, t));
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float s2 = __fdiv_rn(warp_sum(sq[r]), n);
    const float var =
        STATS == kStatsOnePass ? fmaxf(__fsub_rn(s2, __fmul_rn(mean[r], mean[r])), 0.f) : s2;
    rstd[r] = STATS == kStatsExact ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)))
                                   : rsqrtf(__fadd_rn(var, eps));
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// The blocks of `threads` threads that one SM holds of `kernel` (one kernel
// instantiation: its registers and shared memory), asked once.
template <auto kernel>
int resident_blocks(int threads) {
  static int blocks = 0;
  if (blocks == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
    if (blocks < 1) blocks = 1;
  }
  return blocks;
}

// A row kernel's grid: `want` blocks of `threads`, at most one full wave.
template <auto kernel>
unsigned wave_blocks(long long want, int threads) {
  const long long wave = static_cast<long long>(sm_count()) * resident_blocks<kernel>(threads);
  return static_cast<unsigned>(want < wave ? want : wave);
}

// A flat pass's grid, where thread t owns columns [8g, 8g + 8) with g = t %
// groups and the rows t / groups + k * row_step: one full wave of blocks of
// `threads` on every SM, each thread walking at least one row; returns the
// row step, sets the blocks.
template <auto kernel>
int flat_grid(int rows, int groups, int threads, unsigned& blocks) {
  const long long target =
      static_cast<long long>(sm_count()) * resident_blocks<kernel>(threads) * threads;
  long long step = target / groups;
  if (step < 1) step = 1;
  if (step > rows) step = rows;
  blocks = static_cast<unsigned>((step * groups + threads - 1) / threads);
  return static_cast<int>(step);
}

}  // namespace
