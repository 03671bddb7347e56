// The GEMM probes' kernels, for Hopper (sm_90a), on the tensor cores:
// probe_mm through wgmma (csrc/wgmma_gemm.cuh), the others through mma.sync
// (the s8 mainloop of csrc/int8_mma.cuh, the bf16 fragments of
// csrc/bf16_mma.cuh).
//
// Replaces the TPU kernels of the repository's probe scripts:
//   scripts/int8_probe.py: _mm_kernel (pallas_mm, :48)          -> team_probe_mm
//   scripts/int8_mxu_ceiling.py: _kernel_windows (run, :50)     -> team_mxu_ceiling
//   scripts/r5_megakernel_probe.py: _mlp_mega_kernel
//     (mlp_mega_2d :73, mlp_mega_3d :105)                       -> team_mlp_mega
// The TPU tilings (BM/BN/BK, block_m, block_b) are not carried over.
//
// probe_mm: out = x [M, K] @ w, with w given as its transpose [N, K]
// row-major, a CTA of 128 x 256 outputs on the wgmma + TMA mainloop of
// csrc/wgmma_gemm.cuh. int8 -> int32 exact (the raw accumulator is stored,
// staged to whole 32-byte sectors); bf16 -> f32 (each bf16 product is exact
// in f32, the sums are f32 in the tensor cores' order). The int8 form's
// earlier kernel, 64 x 128 tiles on the s8 mma.sync mainloop, stays callable
// (team_probe_mm_mma) as its yardstick: both are exact, so they agree bit for
// bit. Bound on an H100 at M = N = K = 4096: 137.4 G operations, 0.0695 ms in
// int8 at 1,979 TOP/s and 0.139 ms in bf16 at 989 TFLOP/s; the bytes (101 MB
// int8) take 0.030 ms.
//
// mxu_ceiling: out [M, N] f32 = sum over i < reps of x[8 (i mod 64) :
// 8 (i mod 64) + M, :] @ w, with w [K, N] given as [N, K]. Every one of the
// reps products is issued on the tensor cores: nothing is multiplied by a
// count. The products are regrouped: a CTA owns a 64-row tile, a column slice
// of w kept in shared memory for its whole life (int8 128 columns, bf16 64:
// 96 KB at K = 768), and a group of the 64 distinct windows. For each window
// it stages the window's 64 x K tile of x into shared memory once, then for
// each 32-byte k-step loads its fragments once and issues the window's 31 or
// 32 repetitions back to back (asm volatile: none is folded away). A window's
// repetitions sum into a fresh accumulator, added to the CTA's total when the
// window ends. The groups' totals go to a workspace [groups, M, N] and a
// second kernel sums them in group order, so the result is deterministic:
// exact in int32 for int8 (then f32(acc), as the TPU kernel's output), in f32
// for bf16. Bound at the probe's shape (M = 512, K = N = 768, reps = 2000):
// 1.208 T operations, 0.610 ms in int8, 1.221 ms in bf16. What it measures is
// the mma.sync ceiling of this card; wgmma's is higher.
//
// mlp_mega: y = bf16(f32(hq @ w2) * s2[k]) with hq = clip(rint(gelu_tanh(
// f32(x @ w1) * s1[n]) * qi[n]), +-127) int8, the whole MLP in one kernel:
// x [M, K] int8, w1 given as [N, K], w2 as [K, N]; s1, qi [N], s2 [K] f32.
// A CTA takes 64 rows. For each 128-column chunk of N it runs the fc product
// on the s8 mainloop and writes hq into an int8 block [64, N] in shared
// memory (64 x 3,088 bytes at N = 3,072: 197.6 KB, with the 30 KB of stages
// 228 KB of the 227 KB a CTA may have); then the proj product reads A from
// that block and streams w2 through the stages. The [M, N] intermediate
// never reaches device memory. 64 rows rather than 32 halve what each CTA
// re-reads of the two weights from L2 (4.7 MB a CTA). The GELU is the
// script's _gelu_tanh in its own order, every product and sum rounded on its
// own (__fmul_rn, __fadd_rn: nvcc would contract a*b + c into one FMA).
// Bound at the probe's shape (M = 256 x 197, K = 768, N = 3,072): 475.9 G
// operations, 0.2405 ms; its bytes (121 MB) 0.036 ms.
//
// The ceiling and the megakernel run mma.sync from a two-stage cp.async
// pipeline, not wgmma and TMA (the ceiling is the mma.sync ceiling by
// design); their times are in PERF.md.

#include "bf16_mma.cuh"
#include "int8_mma.cuh"
#include "wgmma_gemm.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may have on an H100
constexpr int kWindows = 64;      // the ceiling's distinct windows: x rows 8 j, j < 64
constexpr int kWindowStride = 8;
constexpr int kTileM = 64;        // rows of every CTA tile here

// the operand struct of the shared mainloops (xs and bk are read only by the
// block-scale mainloop, which no kernel here runs)
struct Operands {
  const int8_t* a;
  const int8_t* b;
  const float* xs;
  int m, k, bk;
};

using wg::store2;

// a warp's MI x NI accumulators of a 64-row tile, at rows wrow and columns
// wcol of the tile, to out [m, n] (n a multiple of 8: col + 1 < n too)
template <typename Acc, int MI, int NI>
__device__ __forceinline__ void store_tile(const Acc (&acc)[MI][NI][4], Acc* out, int row0,
                                           int col0, int m, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + mi * 16 + g + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = col0 + ni * 8 + 2 * t;
        if (col < n)
          store2(out + static_cast<size_t>(row) * n + col, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// probe_mm
// ---------------------------------------------------------------------------

// int8 on the s8 mma.sync mainloop, 64 x 128 tiles (team_probe_mm_mma)
__global__ void __launch_bounds__(kThreads) probe_mm_kernel(const Operands p, int* out, int n) {
  using T = Tile<kTileM, 2>;
  __shared__ __align__(16) Stages<kTileM> st;
  const int row0 = blockIdx.x * kTileM, col0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int wrow = row0 + (warp / 2) * T::WROWS, wcol = col0 + (warp % 2) * T::WCOLS;
  int acc[T::MI][T::NI][4] = {};
  float unused[T::MI][T::NI][4];
  mainloop<kTileM, 2, false>(st, p, row0, col0, n, acc, unused);
  store_tile(acc, out, wrow, wcol, p.m, n);
}

// bf16: the wgmma + TMA mainloop of csrc/wgmma_gemm.cuh, 128 x 256 tiles (each
// consumer warpgroup 64 rows, B shared), four stages of 16 KB of A and 32 KB
// of B, persistent CTAs in clusters of two that multicast B (faster than
// single CTAs at 4096^3: PERF.md); f32 stored from the registers, M and N
// edges masked
using ProbeBf16 = wg::Config<128, 256, 4, 2>;

__global__ void __launch_bounds__(wg::kThreads, 1)
    probe_mm_kernel_wg(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb, float* out, int m, int n, int k) {
  extern __shared__ uint8_t wg_smem[];
  wg::run<ProbeBf16, float>(wg_smem, &ma, &mb, m, n, k, [&](float (&acc)[128], int row0, int col0,
                                                           int cw) {
    const int lane = threadIdx.x & 31;
    const int r0 = row0 + cw * 64 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const int c0 = col0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = c0 + 8 * i;  // n is a multiple of 8: col + 1 < n too
        if (col < n)
          store2(out + static_cast<size_t>(row) * n + col, acc[4 * i + 2 * h],
                 acc[4 * i + 2 * h + 1]);
      }
    }
  });
}

// int8 on the same mainloop: 128 x 256 tiles of m64n256 s8, four stages of
// 48 KB, persistent CTAs; each consumer warp's exact int32 sums leave
// through its 2 KB buffer in whole 32-byte sectors (wg::store_warp_rows)
using ProbeS8 = wg::Config<128, 256, 4, 1>;

__global__ void __launch_bounds__(wg::kThreads, 1)
    probe_mm_kernel_wg_s8(const __grid_constant__ CUtensorMap ma,
                          const __grid_constant__ CUtensorMap mb, int* out, int m, int n, int k) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(16) int out_stage[wg::kConsumerWarps][16 * 32];
  wg::run<ProbeS8, int>(wg_smem, &ma, &mb, m, n, k, [&](int (&acc)[128], int row0, int col0,
                                                       int cw) {
    const int warp = (threadIdx.x >> 5) - 4;  // among the consumer warps
    wg::store_warp_rows<32, int>(out, out_stage[warp], row0 + cw * 64 + 16 * (warp & 3), col0, m,
                                 n, [&](int i, int (&v)[4]) {
#pragma unroll
                                   for (int e = 0; e < 4; ++e) v[e] = acc[4 * i + e];
                                 });
  });
}

// ---------------------------------------------------------------------------
// mxu_ceiling
// ---------------------------------------------------------------------------

template <bool BF16>
struct Ceiling {
  static constexpr int BN = BF16 ? 64 : 128;  // columns of w resident in a CTA
  static constexpr int WROWS = kTileM / 2;    // 2 x 2 warps
  static constexpr int WCOLS = BN / 2;
  static constexpr int MI = WROWS / 16;
  static constexpr int NI = WCOLS / 8;
  using Acc = typename std::conditional<BF16, float, int>::type;
};

__host__ __device__ constexpr int ceiling_pitch(int kb) { return kb + 16; }

int ceiling_smem(bool bf16, int kb) {
  return (kTileM + (bf16 ? Ceiling<true>::BN : Ceiling<false>::BN)) * ceiling_pitch(kb);
}

struct CeilingParams {
  const int8_t* x;   // [m + 504 or more, K] row-major (bytes)
  const int8_t* wt;  // [n, K] row-major (bytes)
  void* part;        // [groups, m, n] int32 or f32
  int m, n, kb;      // kb: bytes of a row of K
  int reps, groups;
};

__device__ __forceinline__ void mma_any(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  mma_s8(c, a, b);
}

__device__ __forceinline__ void mma_any(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  mma_bf16(c, a, b);
}

__device__ __forceinline__ int add_rn(int a, int b) { return a + b; }

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <bool BF16>
__global__ void __launch_bounds__(kThreads) ceiling_kernel(const CeilingParams p) {
  using C = Ceiling<BF16>;
  using Acc = typename C::Acc;
  extern __shared__ __align__(16) int8_t smem[];
  const int pitch = ceiling_pitch(p.kb);
  int8_t* ws = smem;                   // [BN][pitch]: the CTA's slice of w, resident
  int8_t* xs = smem + C::BN * pitch;   // [64][pitch]: the current window's x tile
  const int row0 = blockIdx.x * kTileM, col0 = blockIdx.y * C::BN, grp = blockIdx.z;
  const int chunks = p.kb / 16;        // 16-byte pieces of a row (kb is a multiple of 32)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp / 2) * C::WROWS, wcol = (warp % 2) * C::WCOLS;

  for (int c = threadIdx.x; c < C::BN * chunks; c += kThreads) {
    const int r = c / chunks, kc = (c % chunks) * 16;
    const bool ok = col0 + r < p.n;
    cp_async16(ws + r * pitch + kc, ok ? p.wt + static_cast<size_t>(col0 + r) * p.kb + kc : p.wt, ok);
  }

  Acc total[C::MI][C::NI][4] = {};
  const int per = kWindows / p.groups;
  for (int j = grp * per; j < (grp + 1) * per; ++j) {
    const int count = p.reps / kWindows + (j < p.reps % kWindows ? 1 : 0);
    if (count == 0) continue;
    for (int c = threadIdx.x; c < kTileM * chunks; c += kThreads) {
      const int r = c / chunks, kc = (c % chunks) * 16;
      const bool ok = row0 + r < p.m;
      const int8_t* src = p.x + static_cast<size_t>(kWindowStride * j + row0 + r) * p.kb + kc;
      cp_async16(xs + r * pitch + kc, ok ? src : p.x, ok);
    }
    cp_async_commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    Acc acc[C::MI][C::NI][4] = {};
    for (int kk = 0; kk < p.kb; kk += 32) {
      uint32_t af[C::MI][4], bf[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) {
        const int8_t* base = xs + (wrow + mi * 16 + g) * pitch + kk + 4 * t;
        af[mi][0] = ld32(base);
        af[mi][1] = ld32(base + 8 * pitch);
        af[mi][2] = ld32(base + 16);
        af[mi][3] = ld32(base + 8 * pitch + 16);
      }
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const int8_t* base = ws + (wcol + ni * 8 + g) * pitch + kk + 4 * t;
        bf[ni][0] = ld32(base);
        bf[ni][1] = ld32(base + 16);
      }
      for (int rep = 0; rep < count; ++rep)
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < C::NI; ++ni) mma_any(acc[mi][ni], af[mi], bf[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mi][ni][e] = add_rn(total[mi][ni][e], acc[mi][ni][e]);
    __syncthreads();  // every warp is done with xs before the next window lands
  }
  asm volatile("cp.async.wait_all;\n" ::);  // w's copies, where no window ran

  Acc* part = static_cast<Acc*>(p.part) + static_cast<size_t>(grp) * p.m * p.n;
  store_tile(total, part, row0 + wrow, col0 + wcol, p.m, p.n);
}

// out = the groups' partial sums added in group order; int32 -> f32 at the end
template <bool BF16>
__global__ void ceiling_reduce_kernel(const void* part, float* out, int groups, size_t mn) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  if constexpr (BF16) {
    const float* pf = static_cast<const float*>(part);
    float s = pf[i];
    for (int gi = 1; gi < groups; ++gi) s = __fadd_rn(s, pf[gi * mn + i]);
    out[i] = s;
  } else {
    const int* pi = static_cast<const int*>(part);
    int s = pi[i];
    for (int gi = 1; gi < groups; ++gi) s += pi[gi * mn + i];
    out[i] = __int2float_rn(s);
  }
}

// ---------------------------------------------------------------------------
// mlp_mega
// ---------------------------------------------------------------------------

struct MegaParams {
  const int8_t* x;    // [m, k]
  const int8_t* w1t;  // [n, k]: w1's transpose
  const float* s1;    // [n]
  const float* qi;    // [n]
  const int8_t* w2t;  // [k, n]: w2's transpose
  const float* s2;    // [k]
  __nv_bfloat16* out; // [m, k]
  int m, k, n;
};

__host__ __device__ constexpr int mega_pitch(int n) { return n + 16; }

int mega_smem(int n) { return static_cast<int>(sizeof(Stages<kTileM>)) + kTileM * mega_pitch(n); }

// the script's _gelu_tanh, in its order: 0.5 x (1 + tanh(c (x + ((0.044715 x) x) x)))
__device__ __forceinline__ float gelu_tanh_script(float x) {
  const float c = 0.7978845608028654f, kappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(kappa, x), x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, cube));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

__device__ __forceinline__ int8_t requant(float h, float qi) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(h, qi)), -127.f), 127.f));
}

__global__ void __launch_bounds__(kThreads) mlp_mega_kernel(const MegaParams q) {
  using T = Tile<kTileM, 2>;
  extern __shared__ __align__(16) int8_t mega_smem_buf[];
  Stages<kTileM>& st = *reinterpret_cast<Stages<kTileM>*>(mega_smem_buf);
  int8_t* hs = mega_smem_buf + sizeof(Stages<kTileM>);  // [64][pitch]: hq of the CTA's rows
  const int hp = mega_pitch(q.n);
  const int row0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp / 2) * T::WROWS, wcol = (warp % 2) * T::WCOLS;

  // fc: hq = requant(gelu(f32(x @ w1) * s1)) into shared memory, 128 columns at a time
  const Operands fc{q.x, q.w1t, nullptr, q.m, q.k, 0};
  for (int c0 = 0; c0 < q.n; c0 += kBN) {
    int acc[T::MI][T::NI][4] = {};
    float unused[T::MI][T::NI][4];
    mainloop<kTileM, 2, false>(st, fc, row0, c0, q.n, acc, unused);
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wrow + mi * 16 + g + 8 * h;
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + wcol + ni * 8 + 2 * t + e;
            if (col < q.n) {
              const float hv = gelu_tanh_script(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), q.s1[col]));
              hs[r * hp + col] = requant(hv, q.qi[col]);
            }
          }
      }
  }
  __syncthreads();

  // proj: y = bf16(f32(hq @ w2) * s2), A from shared memory, w2 streamed
  const int stages = (q.n + kBK - 1) / kBK;
  for (int c0 = 0; c0 < q.k; c0 += kBN) {
    int acc[T::MI][T::NI][4] = {};
    load_rows<kBN>(st.b[0], q.w2t, c0, q.k, q.n, 0);
    cp_async_commit();
    for (int kt = 0; kt < stages; ++kt) {
      const int s = kt & 1;
      if (kt + 1 < stages) load_rows<kBN>(st.b[s ^ 1], q.w2t, c0, q.k, q.n, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 32) {
        const int kg = kt * kBK + kk;
        if (kg >= q.n) break;  // n is a multiple of 32
        uint32_t af[T::MI][4], bf[T::NI][2];
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) {
          const int8_t* base = hs + (wrow + mi * 16 + g) * hp + kg + 4 * t;
          af[mi][0] = ld32(base);
          af[mi][1] = ld32(base + 8 * hp);
          af[mi][2] = ld32(base + 16);
          af[mi][3] = ld32(base + 8 * hp + 16);
        }
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int8_t* base = st.b[s] + (wcol + ni * 8 + g) * kPitch + kk + 4 * t;
          bf[ni][0] = ld32(base);
          bf[ni][1] = ld32(base + 16);
        }
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < T::NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wrow + mi * 16 + g + 8 * h;
        if (row >= q.m) continue;
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int col = c0 + wcol + ni * 8 + 2 * t;  // k is a multiple of 32: col + 1 < k too
          if (col >= q.k) continue;
          const float y0 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), q.s2[col]);
          const float y1 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), q.s2[col + 1]);
          *reinterpret_cast<__nv_bfloat162*>(q.out + static_cast<size_t>(row) * q.k + col) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
  }
}

int max_k_ceiling(bool bf16) {
  const int bn = bf16 ? Ceiling<true>::BN : Ceiling<false>::BN;
  const int kb = (kSmemMax / (kTileM + bn) - 16) / 32 * 32;
  return bf16 ? kb / 2 : kb;
}

}  // namespace

// x [m, k] and w_t [n, k] row-major, 16-byte aligned; int8 (bf16 = 0, k a
// multiple of 32, out int32 [m, n]) or bfloat16 (bf16 = 1, k a multiple of
// 16, out float32 [m, n]); n a multiple of 8. Returns the launch's cudaError_t.
extern "C" int team_probe_mm(const void* x, const void* w_t, void* out, int m, int n, int k,
                             int bf16, void* stream) {
  if (m < 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % (bf16 ? 16 : 32) != 0)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ma, mb;
  dim3 grid;
  if (bf16) {
    const cudaError_t err = wg::prepare<ProbeBf16>(probe_mm_kernel_wg, &ma, &mb, &grid, x, w_t, m,
                                                   n, k, 2, true);
    if (err != cudaSuccess) return err;
    return wg::launch<ProbeBf16>(probe_mm_kernel_wg, grid, s, ma, mb, static_cast<float*>(out), m,
                                 n, k);
  }
  const cudaError_t err = wg::prepare<ProbeS8>(probe_mm_kernel_wg_s8, &ma, &mb, &grid, x, w_t, m,
                                               n, k, 1, false);
  if (err != cudaSuccess) return err;
  return wg::launch<ProbeS8>(probe_mm_kernel_wg_s8, grid, s, ma, mb, static_cast<int*>(out), m, n,
                             k);
}

// team_probe_mm's int8 form on the mma.sync kernel (probe_mm_kernel): the
// kernel that probe_mm_kernel_wg_s8 replaced, kept callable so that the two
// can be held against each other bit for bit.
extern "C" int team_probe_mm_mma(const void* x, const void* w_t, void* out, int m, int n, int k,
                                 void* stream) {
  if (m < 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % 32 != 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const Operands p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_t), nullptr, m, k, 0};
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kBN - 1) / kBN);
  probe_mm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, static_cast<int*>(out),
                                                                             n);
  return cudaGetLastError();
}

// The widest K the ceiling kernel keeps in shared memory (elements).
extern "C" int team_mxu_ceiling_max_k(int bf16) { return max_k_ceiling(bf16 != 0); }

// The columns of w a ceiling CTA keeps (the wrapper sizes its grid with it).
extern "C" int team_mxu_ceiling_block_n(int bf16) {
  return bf16 ? Ceiling<true>::BN : Ceiling<false>::BN;
}

// x [m + 504 or more, k] and w_t [n, k] row-major, 16-byte aligned, int8 (bf16
// = 0, k a multiple of 32) or bfloat16 (k a multiple of 16), k at most
// team_mxu_ceiling_max_k; part a workspace of groups * m * n 4-byte values;
// out float32 [m, n]; groups a power of two that divides 64; n a multiple of 8.
extern "C" int team_mxu_ceiling(const void* x, const void* w_t, void* part, void* out, int m, int n,
                                int k, int reps, int groups, int bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % (bf16 ? 16 : 32) != 0 || reps < 0 ||
      k > max_k_ceiling(bf16 != 0) || groups <= 0 || groups > kWindows || kWindows % groups != 0)
    return cudaErrorInvalidValue;
  const CeilingParams p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_t), part, m, n,
                        bf16 ? 2 * k : k, reps, groups};
  const int smem = ceiling_smem(bf16 != 0, p.kb);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = team_mxu_ceiling_block_n(bf16);
  const dim3 grid((m + kTileM - 1) / kTileM, (n + bn - 1) / bn, groups);
  const size_t mn = static_cast<size_t>(m) * n;
  const unsigned rblocks = static_cast<unsigned>((mn + 255) / 256);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(ceiling_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ceiling_kernel<true><<<grid, kThreads, smem, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ceiling_reduce_kernel<true><<<rblocks, 256, 0, s>>>(part, static_cast<float*>(out), groups, mn);
  } else {
    err = cudaFuncSetAttribute(ceiling_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ceiling_kernel<false><<<grid, kThreads, smem, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ceiling_reduce_kernel<false><<<rblocks, 256, 0, s>>>(part, static_cast<float*>(out), groups, mn);
  }
  return cudaGetLastError();
}

// The widest N (hidden width) the megakernel keeps in shared memory.
extern "C" int team_mlp_mega_max_n() {
  return ((kSmemMax - static_cast<int>(sizeof(Stages<kTileM>))) / kTileM - 16) / 32 * 32;
}

// x int8 [m, k]; w1_t int8 [n, k]; s1, qi float32 [n]; w2_t int8 [k, n]; s2
// float32 [k]; out bfloat16 [m, k]; all row-major, 16-byte aligned; k and n
// multiples of 32, n at most team_mlp_mega_max_n().
extern "C" int team_mlp_mega(const void* x, const void* w1_t, const void* s1, const void* qi,
                             const void* w2_t, const void* s2, void* out, int m, int k, int n,
                             void* stream) {
  if (m < 0 || k <= 0 || n <= 0 || k % 32 != 0 || n % 32 != 0 || n > team_mlp_mega_max_n())
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const MegaParams q{static_cast<const int8_t*>(x),  static_cast<const int8_t*>(w1_t),
                     static_cast<const float*>(s1), static_cast<const float*>(qi),
                     static_cast<const int8_t*>(w2_t), static_cast<const float*>(s2),
                     static_cast<__nv_bfloat16*>(out), m, k, n};
  const int smem = mega_smem(n);
  const cudaError_t err =
      cudaFuncSetAttribute(mlp_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mlp_mega_kernel<<<(m + kTileM - 1) / kTileM, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(q);
  return cudaGetLastError();
}
