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
//
// The static int8 tower's epilogues (team_tpu's XLA fuses them into its
// dots; backbone/quant.py:_static_linear3 and _ln_quant3 are the compositions
// they replace, in the same arithmetic and order):
//   team_static_requant: int32 [M, N] -> int8, v = f32(acc) * scale[n] +
//     b[n] (two roundings, no FMA), then none, PyTorch's tanh GELU or
//     x * sigmoid(1.702x), then rint(v * inv_a[n]) clipped to +-127;
//   team_static_residual: int32 [M, N] (+ bf16 residual [M, N], rows
//     ldx apart) -> bf16, r = bf16(f32(acc) * scale[n] + b[n]), out =
//     bf16(f32(x) + f32(r)) (r alone without a residual);
//   team_ln_quant_folded: bf16 [M, D] -> int8, the layer norm with
//     var = max(E[x^2] - E[x]^2, 0) (one pass) or the two-pass mean and
//     variance, y = (x - mean) * rsqrtf(var + 1e-5), q = rint(y * (gamma *
//     inv_a) + beta * inv_a) clipped to +-127.
// Each thread of the two epilogues owns eight consecutive columns, keeps
// their vectors in registers and walks rows a fixed stride apart, four rows'
// streaming loads in flight, one full wave of blocks; the layer norm gives
// a warp two rows at a time, takes their statistics through the row_stats of
// #22-#25 and keeps the folded affine in shared memory. At M = 25,216 the qkv
// and fc epilogues move 290 and 387 MB (0.087 and 0.116 ms at 3.35 TB/s), out
// and proj 155 MB.

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

// How a layer norm takes its rows' statistics, the mean and 1/sqrt(var + 1e-5):
enum LnStats {
  kStatsExact = 0,    // #22-#25: two passes, 1/sqrt as an IEEE square root and division
  kStatsTwoPass = 1,  // _ln_quant3's two passes, rsqrtf
  kStatsOnePass = 2,  // _ln_quant3's one pass, var = max(E[x^2] - E[x]^2, 0), rsqrtf
};

// ROWS rows of one warp, `d` apart (those at or past `valid` skipped), CH
// words of eight a lane: their values (v), means and 1/sqrt(var + 1e-5), both
// sums in f32 over the warp, each product and sum rounded on its own
template <int ROWS, int CH, int STATS>
__device__ __forceinline__ void row_stats(const __nv_bfloat16* x, int d, int valid, int lane,
                                          float (&v)[ROWS][CH][8], float (&mean)[ROWS],
                                          float (&rstd)[ROWS]) {
  const float n = static_cast<float>(d);
  float sum[ROWS], sq[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    sum[r] = 0.f;
    sq[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * 32 + lane) * 8;
      if (r < valid && col < d) load8(x + static_cast<size_t>(r) * d + col, v[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
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
    rstd[r] = STATS == kStatsExact ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-5f)))
                                   : rsqrtf(__fadd_rn(var, 1e-5f));
  }
}

__global__ void __launch_bounds__(kWarps * 32)
ln_quant_static_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ inv_a,
                       int8_t* __restrict__ q, int rows, int d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the ragged edge
  float v[1][kMaxChunks][8], mean[1], rstd[1];
  row_stats<1, kMaxChunks, kStatsExact>(x + static_cast<size_t>(row) * d, d, 1, lane, v, mean,
                                        rstd);

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
        const float t = __fmul_rn(__fsub_rn(v[0][c][i], mean[0]), rstd[0]);
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
  float v[1][kMaxChunks][8], mean[1], rstd[1];
  row_stats<1, kMaxChunks, kStatsExact>(x + static_cast<size_t>(row) * d, d, 1, lane, v, mean,
                                        rstd);

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
        const float t = __fmul_rn(__fsub_rn(v[0][c][i], mean[0]), rstd[0]);
        v[0][c][i] = __fadd_rn(__fmul_rn(t, g[i]), b[i]);
        amax = fmaxf(amax, fabsf(v[0][c][i]));
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
      for (int i = 0; i < 8; ++i) y[i] = __fdiv_rn(v[0][c][i], scale);
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

// -- the static tower's epilogues and layer norm --------------------------

constexpr int kEpiThreads = 256;
constexpr int kEpiRows = 4;  // rows whose loads a thread has in flight
enum Activation { kActNone = 0, kActGeluTanh = 1, kActSigmoid = 2 };

// PyTorch's tanh GELU (F.gelu(approximate="tanh") on CUDA) in its order and
// its float constants; nvcc contracts it as it does PyTorch's kernel
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

// x * torch.sigmoid(1.702 * x), each product its own rounding
__device__ __forceinline__ float gelu_sigmoid(float x) {
  const float t = __fmul_rn(1.702f, x);
  return __fmul_rn(x, 1.f / (1.f + expf(-t)));
}

// eight int32 from two 16-byte words, read once (streaming)
__device__ __forceinline__ void load8_stream(const int32_t* p, int4 (&w)[2]) {
  w[0] = __ldcs(reinterpret_cast<const int4*>(p));
  w[1] = __ldcs(reinterpret_cast<const int4*>(p) + 1);
}

// f32(acc) * scale + b, two roundings
__device__ __forceinline__ void dequant8(const int4 (&w)[2], const float (&s)[8],
                                         const float (&b)[8], float (&v)[8]) {
  const int a[8] = {w[0].x, w[0].y, w[0].z, w[0].w, w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(__fmul_rn(__int2float_rn(a[i]), s[i]), b[i]);
}

// The epilogues' walk: thread t owns columns [8g, 8g + 8) with g = t % groups
// and the rows t / groups + k * row_step; row_step * groups threads run.
struct EpiWalk {
  int col, row;
  __device__ __forceinline__ EpiWalk(int groups) {
    const int t = blockIdx.x * kEpiThreads + threadIdx.x;
    col = (t % groups) * 8;
    row = t / groups;
  }
};

template <int ACT>
__global__ void __launch_bounds__(kEpiThreads)
requant_static_kernel(const int32_t* __restrict__ acc, const float* __restrict__ scale,
                      const float* __restrict__ bias, const float* __restrict__ inv_a,
                      int8_t* __restrict__ q, int rows, int groups, int row_step) {
  const EpiWalk w(groups);
  if (w.row >= row_step) return;
  const size_t n = static_cast<size_t>(groups) * 8;
  float s[8], b[8], a[8];
  load8(scale + w.col, s);
  load8(bias + w.col, b);
  load8(inv_a + w.col, a);
  for (int row = w.row; row < rows; row += kEpiRows * row_step) {
    int4 raw[kEpiRows][2];
#pragma unroll
    for (int u = 0; u < kEpiRows; ++u) {
      const int r = row + u * row_step;
      if (r < rows) load8_stream(acc + r * n + w.col, raw[u]);
    }
#pragma unroll
    for (int u = 0; u < kEpiRows; ++u) {
      const int r = row + u * row_step;
      if (r < rows) {
        float v[8];
        dequant8(raw[u], s, b, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (ACT == kActGeluTanh) v[i] = gelu_tanh(v[i]);
          if (ACT == kActSigmoid) v[i] = gelu_sigmoid(v[i]);
          v[i] = __fmul_rn(v[i], a[i]);
        }
        store8(q + r * n + w.col, v);
      }
    }
  }
}

template <bool RESIDUAL>
__global__ void __launch_bounds__(kEpiThreads)
residual_static_kernel(const int32_t* __restrict__ acc, const float* __restrict__ scale,
                       const float* __restrict__ bias, const __nv_bfloat16* __restrict__ x,
                       long long ldx, __nv_bfloat16* __restrict__ out, int rows, int groups,
                       int row_step) {
  const EpiWalk w(groups);
  if (w.row >= row_step) return;
  const size_t n = static_cast<size_t>(groups) * 8;
  float s[8], b[8];
  load8(scale + w.col, s);
  load8(bias + w.col, b);
  for (int row = w.row; row < rows; row += kEpiRows * row_step) {
    int4 raw[kEpiRows][2];
    uint4 res[kEpiRows];
#pragma unroll
    for (int u = 0; u < kEpiRows; ++u) {
      const int r = row + u * row_step;
      if (r < rows) {
        load8_stream(acc + r * n + w.col, raw[u]);
        if (RESIDUAL) res[u] = *reinterpret_cast<const uint4*>(x + r * ldx + w.col);
      }
    }
#pragma unroll
    for (int u = 0; u < kEpiRows; ++u) {
      const int r = row + u * row_step;
      if (r < rows) {
        float v[8];
        dequant8(raw[u], s, b, v);
        uint4 o;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
        const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(&res[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float2 t = __bfloat1622float2(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
          if (RESIDUAL) {
            const float2 xf = __bfloat1622float2(xr[i]);
            t.x = __fadd_rn(xf.x, t.x);
            t.y = __fadd_rn(xf.y, t.y);
          }
          h[i] = __floats2bfloat162_rn(t.x, t.y);
        }
        *reinterpret_cast<uint4*>(out + r * n + w.col) = o;
      }
    }
  }
}

// one warp a row, kLnRows rows at a time, rows a grid's warps apart; CH
// words of eight a lane; the block's folded affine in shared memory
constexpr int kLnRows = 2;

template <int CH, int STATS>
__global__ void __launch_bounds__(kWarps * 32)
ln_quant_folded_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ inv_a,
                       int8_t* __restrict__ q, int rows, int d) {
  __shared__ __align__(16) float gi[CH * 256];  // gamma * inv_a, rounded as the composition
  __shared__ __align__(16) float bi[CH * 256];  // beta * inv_a
  for (int col = threadIdx.x; col < d; col += kWarps * 32) {
    const float a = inv_a[col];
    gi[col] = __fmul_rn(gamma[col], a);
    bi[col] = __fmul_rn(beta[col], a);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kLnRows; row0 < rows;
       row0 += warps * kLnRows) {
    float v[kLnRows][CH][8], mean[kLnRows], rstd[kLnRows];
    row_stats<kLnRows, CH, STATS>(x + static_cast<size_t>(row0) * d, d, rows - row0, lane, v,
                                  mean, rstd);
#pragma unroll
    for (int r = 0; r < kLnRows; ++r) {
      if (row0 + r >= rows) break;
      int8_t* qr = q + static_cast<size_t>(row0 + r) * d;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = (c * 32 + lane) * 8;
        if (col < d) {
          float g[8], b[8], y[8];
          load8(gi + col, g);
          load8(bi + col, b);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float t = __fmul_rn(__fsub_rn(v[r][c][i], mean[r]), rstd[r]);
            y[i] = __fadd_rn(__fmul_rn(t, g[i]), b[i]);
          }
          store8(qr + col, y);
        }
      }
    }
  }
}

bool shape_ok(int rows, int d) { return rows >= 0 && d > 0 && d % 8 == 0; }

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

// The epilogues' grid: one full wave of `per_sm` blocks on every SM, each
// thread walking at least one row; returns the row step, sets the blocks.
int epi_grid(int rows, int groups, int per_sm, unsigned& blocks) {
  const long long target = static_cast<long long>(sm_count()) * per_sm * kEpiThreads;
  long long step = target / groups;
  if (step < 1) step = 1;
  if (step > rows) step = rows;
  blocks = static_cast<unsigned>((step * groups + kEpiThreads - 1) / kEpiThreads);
  return static_cast<int>(step);
}

template <int ACT>
void launch_requant(cudaStream_t stream, const int32_t* acc, const float* s, const float* b,
                    const float* a, int8_t* q, int rows, int n) {
  unsigned blocks;
  const int step = epi_grid(rows, n / 8, resident_blocks<requant_static_kernel<ACT>>(kEpiThreads),
                            blocks);
  requant_static_kernel<ACT><<<blocks, kEpiThreads, 0, stream>>>(acc, s, b, a, q, rows, n / 8,
                                                                 step);
}

template <bool RESIDUAL>
void launch_residual(cudaStream_t stream, const int32_t* acc, const float* s, const float* b,
                     const __nv_bfloat16* x, long long ldx, __nv_bfloat16* out, int rows, int n) {
  unsigned blocks;
  const int step = epi_grid(rows, n / 8,
                            resident_blocks<residual_static_kernel<RESIDUAL>>(kEpiThreads), blocks);
  residual_static_kernel<RESIDUAL><<<blocks, kEpiThreads, 0, stream>>>(acc, s, b, x, ldx, out,
                                                                       rows, n / 8, step);
}

template <int CH, int STATS>
void launch_ln_quant_folded(cudaStream_t stream, const __nv_bfloat16* x, const float* g,
                            const float* b, const float* a, int8_t* q, int rows, int d) {
  const long long want = (rows + kWarps * kLnRows - 1) / (kWarps * kLnRows);
  const long long wave = static_cast<long long>(sm_count()) *
                         resident_blocks<ln_quant_folded_kernel<CH, STATS>>(kWarps * 32);
  const unsigned blocks = static_cast<unsigned>(want < wave ? want : wave);
  ln_quant_folded_kernel<CH, STATS><<<blocks, kWarps * 32, 0, stream>>>(x, g, b, a, q, rows, d);
}

template <int CH>
void launch_ln_quant_folded(bool two_pass, cudaStream_t stream, const __nv_bfloat16* x,
                            const float* g, const float* b, const float* a, int8_t* q, int rows,
                            int d) {
  if (two_pass) {
    launch_ln_quant_folded<CH, kStatsTwoPass>(stream, x, g, b, a, q, rows, d);
  } else {
    launch_ln_quant_folded<CH, kStatsOnePass>(stream, x, g, b, a, q, rows, d);
  }
}

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

// acc int32 [rows, n] (16-byte aligned, contiguous); scale, bias, inv_a
// float32 [n] (16-byte aligned); q int8 [rows, n] (8-byte aligned); n a
// multiple of 8; act 0 (none), 1 (tanh GELU), 2 (x * sigmoid(1.702x)).
extern "C" int team_static_requant(const void* acc, const void* scale, const void* bias,
                                   const void* inv_a, void* q, int rows, int n, int act,
                                   void* stream) {
  if (!shape_ok(rows, n) || act < kActNone || act > kActSigmoid) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto* a32 = static_cast<const int32_t*>(acc);
  const auto* s = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  const auto* ia = static_cast<const float*>(inv_a);
  auto* out = static_cast<int8_t*>(q);
  const auto st = static_cast<cudaStream_t>(stream);
  if (act == kActGeluTanh) {
    launch_requant<kActGeluTanh>(st, a32, s, b, ia, out, rows, n);
  } else if (act == kActSigmoid) {
    launch_requant<kActSigmoid>(st, a32, s, b, ia, out, rows, n);
  } else {
    launch_requant<kActNone>(st, a32, s, b, ia, out, rows, n);
  }
  return cudaGetLastError();
}

// acc int32 [rows, n] (16-byte aligned, contiguous); scale, bias float32
// [n] (16-byte aligned); x bf16 [rows, n] with rows ldx elements apart
// (16-byte aligned, ldx a multiple of 8), or null for no residual; out bf16
// [rows, n] (16-byte aligned, contiguous); n a multiple of 8.
extern "C" int team_static_residual(const void* acc, const void* scale, const void* bias,
                                    const void* x, long long ldx, void* out, int rows, int n,
                                    void* stream) {
  if (!shape_ok(rows, n) || (x != nullptr && (ldx < n || ldx % 8))) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto* a32 = static_cast<const int32_t*>(acc);
  const auto* s = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  const auto* xr = static_cast<const __nv_bfloat16*>(x);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (x != nullptr) {
    launch_residual<true>(st, a32, s, b, xr, ldx, o, rows, n);
  } else {
    launch_residual<false>(st, a32, s, b, xr, 0, o, rows, n);
  }
  return cudaGetLastError();
}

// x bf16 [rows, d] (16-byte aligned, contiguous); gamma, beta, inv_a float32
// [d]; q int8 [rows, d] (8-byte aligned); d a multiple of 8, at most
// team_ln_quantize_static_max_width(); two_pass 0: the variance as
// max(E[x^2] - E[x]^2, 0), else the two-pass mean and variance.
extern "C" int team_ln_quant_folded(const void* x, const void* gamma, const void* beta,
                                    const void* inv_a, void* q, int rows, int d, int two_pass,
                                    void* stream) {
  if (!shape_ok(rows, d) || d > kMaxChunks * 32 * 8) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto* xr = static_cast<const __nv_bfloat16*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  const auto* a = static_cast<const float*>(inv_a);
  auto* out = static_cast<int8_t*>(q);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool two = two_pass != 0;
  switch ((d + 255) / 256) {
    case 1: launch_ln_quant_folded<1>(two, st, xr, g, b, a, out, rows, d); break;
    case 2: launch_ln_quant_folded<2>(two, st, xr, g, b, a, out, rows, d); break;
    case 3: launch_ln_quant_folded<3>(two, st, xr, g, b, a, out, rows, d); break;
    default: launch_ln_quant_folded<4>(two, st, xr, g, b, a, out, rows, d); break;
  }
  return cudaGetLastError();
}
