// int8 GEMMs of the dynamic int8 tiers (int8_gemm_impl "hybrid" and "pallas"),
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of team_tpu/ops/int8_matmul.py:
//   _kernel (int8_linear, :233), _kernel_nk (int8_linear_nk, :116),
//   _kernel_kgrid (int8_linear_kgrid, :186), _kernel_wres (int8_linear_wres,
//   :659), _kernel_dma (int8_linear_dma, :797)          -> team_int8_linear
//   _mm_blockscale_kernel (int8_linear_blockscale, :585) -> team_int8_linear_blockscale
//   _mm_gelu_quant_kernel (int8_linear_gelu_quant, :506) -> team_int8_linear_gelu_quant
// The five plain GEMMs differ only in how they tile and stream on the TPU;
// here they are one kernel.
//
// What they compute. acc = int8 A [M, K] x int8 B [N, K]^T, exact in int32.
//   int8_linear:     out = f32(acc) * xs[m] * ws[n] + b[n], then the tanh GELU
//                    when asked, cast to bf16 or written as f32;
//   blockscale:      K is cut into n_kb blocks of bk = K / n_kb columns, and
//                    facc += f32(acc of block kb) * xs[kb, m], in kb order;
//                    out = facc * ws[n] + b[n];
//   gelu_quant:      y = gelu(f32(acc) * xs[m] * ws[n] + b[n]); for each row
//                    and block of bn columns s = amax|y| * f32(1/127) (1 where
//                    amax = 0), q = clip(rint(y / s), +-127); writes q int8
//                    [M, N] and s f32 [N / bn, M].
// Every product and sum of the epilogues is rounded on its own in the TPU
// kernel's order (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc would contract a*b + c
// into one FMA), so a kernel and its plain version agree to an ulp before the
// final cast or rounding.
//
// Mainloop (csrc/int8_mma.cuh, shared with csrc/gemm_probe.cu). A CTA computes
// a tile of BM rows by 128 columns with four warps; K is streamed through
// shared memory 64 bytes at a time, two stages deep, by cp.async, and each
// warp multiplies its share with mma.sync.m16n8k32.row.col.s32.s8.s8.s32. B is
// the "col" operand: the weight stored [N, K] row-major, which is the layout
// the port's quantize_weight gives (a column-major [K, N]).
//
// gelu_quant needs the whole bn-column block of a row before it can scale it
// (bn = 512 at the ViT-B/16 fc shape). Its CTA takes BM = 32 rows and loops
// over the block 128 columns at a time, keeping y in f32 in shared memory
// (32 x 520 floats at bn = 512), then reduces each row's amax in a warp and
// writes the int8 block: the [M, N] f32 activation never reaches device memory.
//
// What bounds them on an H100: at the vision tower's shapes (M = 25,216 rows)
// the qkv GEMM (768 -> 2304) does 89.2 G int8 operations (0.045 ms at 1,979
// TOP/s) against 137 MB of bytes, mostly its bf16 output (0.041 ms at 3.35
// TB/s); fc (768 -> 3072) and proj (3072 -> 768) 119 G each (0.060 ms), out
// (768 -> 768) is bound by its 59 MB (0.0175 ms). This first version runs
// mma.sync, not wgmma, and a two-stage cp.async pipeline, not TMA: a fraction
// of the tensor cores' rate; its times are in PERF.md.

#include "int8_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxBlockN = 1024;  // widest gelu_quant column block
constexpr float kInv127 = 1.0f / 127.0f;

enum Epilogue { kDequant = 0, kDequantGelu = 1, kBlockScale = 2 };

struct Params {
  const int8_t* a;     // [M, K] row-major
  const int8_t* b;     // [N, K] row-major
  const float* xs;     // [M]; blockscale: [K / bk, M]
  const float* ws;     // [N]
  const float* bias;   // [N]
  void* out;           // [M, N] bf16 or f32; gelu_quant: int8
  float* scales;       // gelu_quant: [N / bn, M]
  int m, n, k;
  int bk;              // blockscale: K columns per scale block
  int bn;              // gelu_quant: columns per scale block
};


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

__device__ __forceinline__ void store2(float* out, float y0, float y1) {
  *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y0, y1);
}

// int8_linear (EPI kDequant, kDequantGelu) and int8_linear_blockscale (kBlockScale)
template <int EPI, typename Out>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Params p) {
  using T = Tile<64, 2>;
  __shared__ __align__(16) Stages<64> st;
  const int row0 = blockIdx.x * 64, col0 = blockIdx.y * kBN;
  int acc[T::MI][T::NI][4] = {};
  float facc[T::MI][T::NI][4] = {};
  mainloop<64, 2, EPI == kBlockScale>(st, p, row0, col0, p.n, acc, facc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp / 2) * T::WROWS, wcol = (warp % 2) * T::WCOLS;
  Out* out = static_cast<Out*>(p.out);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wrow + mi * 16 + g + 8 * h;
      if (row >= p.m) continue;
      const float xs = EPI == kBlockScale ? 0.f : p.xs[row];
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = col0 + wcol + ni * 8 + 2 * t;  // N is a multiple of 8: col + 1 < N too
        if (col >= p.n) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (EPI == kBlockScale) {
            y[e] = __fadd_rn(__fmul_rn(facc[mi][ni][2 * h + e], p.ws[col + e]), p.bias[col + e]);
          } else {
            y[e] = dequant(acc[mi][ni][2 * h + e], xs, p.ws[col + e], p.bias[col + e]);
            if (EPI == kDequantGelu) y[e] = gelu_tanh(y[e]);
          }
        }
        store2(out + static_cast<size_t>(row) * p.n + col, y[0], y[1]);
      }
    }
}

__host__ __device__ constexpr int gelu_quant_pitch(int bn) { return (bn + 31) / 32 * 32 + 8; }

__global__ void __launch_bounds__(kThreads) gelu_quant_kernel(const Params p) {
  constexpr int BM = 32;
  using T = Tile<BM, 4>;
  __shared__ __align__(16) Stages<BM> st;
  extern __shared__ float ys[];  // [BM][pitch]: y of the CTA's rows over the block
  const int pitch = gelu_quant_pitch(p.bn);
  const int row0 = blockIdx.x * BM, blk0 = blockIdx.y * p.bn, blk_end = blk0 + p.bn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wcol = warp * T::WCOLS;

  for (int c0 = blk0; c0 < blk_end; c0 += kBN) {
    int acc[T::MI][T::NI][4] = {};
    float unused[T::MI][T::NI][4];
    mainloop<BM, 4, false>(st, p, row0, c0, blk_end, acc, unused);
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + g + 8 * h;
        if (row0 + r >= p.m) continue;
        const float xs = p.xs[row0 + r];
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + wcol + ni * 8 + 2 * t + e;
            if (col < blk_end)
              ys[r * pitch + col - blk0] =
                  gelu_tanh(dequant(acc[mi][ni][2 * h + e], xs, p.ws[col], p.bias[col]));
          }
      }
  }
  __syncthreads();

  int8_t* q = static_cast<int8_t*>(p.out);
  for (int r = warp; r < BM; r += 4) {
    const int row = row0 + r;
    if (row >= p.m) break;
    const float* yr = ys + r * pitch;
    float amax = 0.f;
    for (int c = lane; c < p.bn; c += 32) amax = fmaxf(amax, fabsf(yr[c]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
    if (lane == 0) p.scales[static_cast<size_t>(blockIdx.y) * p.m + row] = s;
    int8_t* qr = q + static_cast<size_t>(row) * p.n + blk0;
    for (int c = lane; c < p.bn; c += 32)
      qr[c] = static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(yr[c], s)), -127.f), 127.f));
  }
}

bool shape_ok(int m, int n, int k) { return m >= 0 && n > 0 && k > 0 && k % 32 == 0 && n % 8 == 0; }

template <int EPI, typename Out>
int launch_gemm(const Params& p, void* stream) {
  const dim3 grid((p.m + 63) / 64, (p.n + kBN - 1) / kBN);
  gemm_kernel<EPI, Out><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* a, const void* b, const void* xs, const void* ws, const void* bias,
                   void* out, int m, int n, int k) {
  Params p{};
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  return p;
}

}  // namespace

// The widest column block int8_linear_gelu_quant takes (its f32 staging).
extern "C" int team_int8_gemm_max_block_n() { return kMaxBlockN; }

// Pointers are device pointers: a int8 [m, k] and b int8 [n, k], row-major and
// 16-byte aligned; xs float32 [m]; ws, bias float32 [n]; out [m, n] bfloat16
// (out_f32 = 0) or float32. k a multiple of 32, n a multiple of 8. gelu = 1
// applies the tanh GELU. Returns the cudaError_t of the launch (0 on success).
extern "C" int team_int8_linear(const void* a, const void* b, const void* xs, const void* ws,
                                const void* bias, void* out, int m, int n, int k, int gelu,
                                int out_f32, void* stream) {
  if (!shape_ok(m, n, k)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const Params p = make_params(a, b, xs, ws, bias, out, m, n, k);
  if (gelu) {
    return out_f32 ? launch_gemm<kDequantGelu, float>(p, stream)
                   : launch_gemm<kDequantGelu, __nv_bfloat16>(p, stream);
  }
  return out_f32 ? launch_gemm<kDequant, float>(p, stream)
                 : launch_gemm<kDequant, __nv_bfloat16>(p, stream);
}

// As team_int8_linear, with xs float32 [k / bk, m]: one scale per row and
// block of bk columns of K (bk a multiple of 32 that divides k); no GELU.
extern "C" int team_int8_linear_blockscale(const void* a, const void* b, const void* xs,
                                           const void* ws, const void* bias, void* out, int m,
                                           int n, int k, int bk, int out_f32, void* stream) {
  if (!shape_ok(m, n, k) || bk <= 0 || bk % 32 != 0 || k % bk != 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  Params p = make_params(a, b, xs, ws, bias, out, m, n, k);
  p.bk = bk;
  return out_f32 ? launch_gemm<kBlockScale, float>(p, stream)
                 : launch_gemm<kBlockScale, __nv_bfloat16>(p, stream);
}

// a, b, xs, ws, bias as team_int8_linear; q int8 [m, n]; scales float32
// [n / bn, m]; bn divides n and is at most team_int8_gemm_max_block_n().
extern "C" int team_int8_linear_gelu_quant(const void* a, const void* b, const void* xs,
                                           const void* ws, const void* bias, void* q,
                                           void* scales, int m, int n, int k, int bn,
                                           void* stream) {
  if (!shape_ok(m, n, k) || bn <= 0 || bn > kMaxBlockN || n % bn != 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  Params p = make_params(a, b, xs, ws, bias, q, m, n, k);
  p.scales = static_cast<float*>(scales);
  p.bn = bn;
  const int smem = 32 * gelu_quant_pitch(bn) * static_cast<int>(sizeof(float));
  const cudaError_t err =
      cudaFuncSetAttribute(gelu_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + 31) / 32, n / bn);
  gelu_quant_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
