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
// Two mainloops. The wgmma + TMA one of csrc/wgmma_gemm.cuh (persistent
// CTAs, a ring of TMA stages, two consumer warpgroups on wgmma) runs what
// the entries send it:
// - int8_linear: gemm_kernel_wg at every shape the entry takes (128 x 256
//   tiles, four stages of 48 KB, the outputs staged through shared memory
//   and stored in whole 32-byte sectors);
// - blockscale: blockscale_kernel_wg where bk is a multiple of 128 (a K
//   block is whole stages; 64 x 256 tiles on m64n128, five stages, each
//   block's int32 sum folded into an f32 sum at the block's end);
// - gelu_quant: gelu_quant_kernel_wg at bn 512 and 256 (below).
// The first two take the column tiles fastest, so the CTAs in flight share
// A's rows.
// The mma.sync one (csrc/int8_mma.cuh, shared with csrc/gemm_probe.cu): a
// CTA computes a tile of BM rows by 128 columns with four warps; K is
// streamed through shared memory 64 bytes at a time, two stages deep, by
// cp.async, and each warp multiplies its share with
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32. It runs gemm_kernel (blockscale
// at other bk; the _mma entries, the yardsticks of the card tests) and
// gelu_quant_kernel (other bn). B is the "col" operand: the weight stored
// [N, K] row-major, which is the layout the port's quantize_weight gives (a
// column-major [K, N]). Each wgmma kernel takes its arithmetic from
// csrc/int8_epilogue.cuh and folds in its mma.sync kernel's order, on exact
// int32 sums: the two agree bit for bit.
//
// gelu_quant needs the whole bn-column block of a row before it can scale it
// (bn = 512 at the ViT-B/16 fc shape); the [M, N] f32 activation never
// reaches device memory. Two kernels, chosen by shape in
// team_int8_linear_gelu_quant:
// - bn 512 and 256 (every K the entry takes): gelu_quant_kernel_wg on the
//   persistent wgmma + TMA mainloop of csrc/wgmma_gemm.cuh (3 stages of 72 KB
//   at 512, 4 of 48 KB at 256). A CTA tile is 64 rows x 512 or 128 rows x
//   256, so A is read once per column block and B once per 64 or 128 rows;
//   y lives in the accumulator registers (128 a thread) and each row's amax
//   is met across lanes and, at 512, across the two consumer warpgroups
//   through shared memory. q leaves through a 512-byte buffer a warp, in
//   whole 16-byte pieces: straight from the registers a warp store would
//   write a quarter of eight 32-byte sectors, and at K 768 those stores cost
//   as much as the tanh.
// - any other bn (32 ... 1024, through the wrapper's _pick_block_n):
//   gelu_quant_kernel on mma.sync. Its CTA takes BM = 32 rows and loops over
//   the block 128 columns at a time, keeping y in f32 in shared memory (32 x
//   520 floats at bn = 512), then reduces each row's amax in a warp.
//
// What bounds them on an H100: at the vision tower's shapes (M = 25,216 rows)
// the qkv GEMM (768 -> 2304) does 89.2 G int8 operations (0.045 ms at 1,979
// TOP/s) against 137 MB of bytes, mostly its bf16 output (0.041 ms at 3.35
// TB/s); fc (768 -> 3072) and proj (3072 -> 768) 119 G each (0.060 ms), out
// (768 -> 768) is bound by its 59 MB (0.0175 ms). At K 768 a tile is six
// stages, so the per-tile costs (the epilogue, the stores) weigh as much as
// the products; at proj's K 3,072 the stages dominate. The times are in
// PERF.md.

#include "int8_epilogue.cuh"
#include "int8_mma.cuh"
#include "wgmma_gemm.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxBlockN = 1024;  // widest gelu_quant column block

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

using wg::store2;

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
    const float s = quant_scale(amax);
    if (lane == 0) p.scales[static_cast<size_t>(blockIdx.y) * p.m + row] = s;
    int8_t* qr = q + static_cast<size_t>(row) * p.n + blk0;
    for (int c = lane; c < p.bn; c += 32) qr[c] = quant_step(yr[c], s);
  }
}

// gelu_quant on the wgmma mainloop (csrc/wgmma_gemm.cuh) at bn 512 and 256.
// A CTA tile is BM rows x one whole bn block: 64 x 512 (the two consumer
// warpgroups share A's rows and each holds 256 columns; a row's amax is met
// through shared memory) or 128 x 256 (each warpgroup holds 64 whole rows).
// y is computed in the accumulator registers, so the block never leaves the
// SM as f32; amax of a row: the thread's 64 columns, then the four lanes that
// share the row, then the other warpgroup. The CTAs are persistent: while
// the consumers run one tile's epilogue the producer loads the next tile.
template <typename C>
__global__ void __launch_bounds__(wg::kThreads, 1)
    gelu_quant_kernel_wg(const __grid_constant__ CUtensorMap ma,
                         const __grid_constant__ CUtensorMap mb, const Params p) {
  extern __shared__ uint8_t wg_smem[];
  // each warpgroup's row amax, by the parity of the CTA's tile: a warpgroup
  // one tile ahead writes the other half
  __shared__ float amax_other[2][2][64];
  // a consumer warp's q, 16 rows x 32 columns at a time: each lane holds two
  // columns of 8 bytes' span, so q leaves in whole 16-byte pieces through here
  __shared__ __align__(16) int8_t q_stage[wg::kConsumerWarps][16][32];
  int round = 0;
  wg::run<C, int>(wg_smem, &ma, &mb, p.m, p.n, p.k, [&](int (&acc)[128], int row0, int col0, int cw) {
    const int lane = threadIdx.x & 31;
    const int r0 = (C::WM == 2 ? cw * 64 : 0) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const int c0 = col0 + (C::WN == 2 ? cw * C::INSTR_N : 0) + 2 * (lane & 3);
    float xs[2], amax[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) xs[h] = row0 + r0 + 8 * h < p.m ? p.xs[row0 + r0 + 8 * h] : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * i + e;
        const float w = p.ws[col], b = p.bias[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int& a = acc[4 * i + 2 * h + e];
          const float y = gelu_tanh(dequant(a, xs[h], w, b));
          a = __float_as_int(y);
          amax[h] = fmaxf(amax[h], fabsf(y));
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], o));
    if (C::WN == 2) {
      float(&other)[2][64] = amax_other[round & 1];
      if ((lane & 3) == 0) {
        other[cw][r0] = amax[0];
        other[cw][r0 + 8] = amax[1];
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumer warpgroups only
#pragma unroll
      for (int h = 0; h < 2; ++h) amax[h] = fmaxf(amax[h], other[cw ^ 1][r0 + 8 * h]);
    }
    ++round;

    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] = quant_scale(amax[h]);
      const int row = row0 + r0 + 8 * h;
      if ((lane & 3) == 0 && (C::WN == 1 || cw == 0) && row < p.m)
        p.scales[static_cast<size_t>(col0 / C::BN) * p.m + row] = s[h];
    }
    int8_t(&stage)[16][32] = q_stage[(threadIdx.x >> 5) - 4];  // consumer warps are 4 ... 11
    const int g = lane >> 2, t = lane & 3;
    const int out_row = row0 + r0 - g + (lane >> 1);  // the row a lane writes: 16 B of it
    int8_t* q = static_cast<int8_t*>(p.out) + static_cast<size_t>(out_row) * p.n + c0 - 2 * t +
                16 * (lane & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // columns 32 j ... 32 j + 31 of the warpgroup's 256
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + ii;
          *reinterpret_cast<char2*>(&stage[g + 8 * h][8 * ii + 2 * t]) =
              make_char2(quant_step(__int_as_float(acc[4 * i + 2 * h]), s[h]),
                         quant_step(__int_as_float(acc[4 * i + 2 * h + 1]), s[h]));
        }
      __syncwarp();
      if (out_row < p.m)
        *reinterpret_cast<int4*>(q + 32 * j) =
            *reinterpret_cast<const int4*>(&stage[lane >> 1][16 * (lane & 1)]);
      __syncwarp();
    }
  });
}

using GeluQuant512 = wg::Config<64, 512, 3, 1>;
using GeluQuant256 = wg::Config<128, 256, 4, 1>;

// The first row of a consumer warp's 16 and the first column of its
// warpgroup's INSTR_N in the CTA tile at (row0, col0).
template <typename C>
__device__ __forceinline__ int warp_row0(int row0, int cw) {
  return row0 + (C::WM == 2 ? cw * 64 : 0) + 16 * ((threadIdx.x >> 5) & 3);
}

template <typename C>
__device__ __forceinline__ int warpgroup_col0(int col0, int cw) {
  return col0 + (C::WN == 2 ? cw * C::INSTR_N : 0);
}

// ws and bias of columns col and col + 1 (col even), zeros past n
__device__ __forceinline__ void column_pair(const Params& p, int col, float2& w, float2& b) {
  const bool in = col < p.n;
  w = in ? *reinterpret_cast<const float2*>(p.ws + col) : make_float2(0.f, 0.f);
  b = in ? *reinterpret_cast<const float2*>(p.bias + col) : make_float2(0.f, 0.f);
}

// int8_linear on the wgmma mainloop (csrc/wgmma_gemm.cuh): 128 x 256 tiles,
// each consumer warpgroup 64 whole rows (m64n256, 128 accumulators a
// thread), four stages of 48 KB, persistent CTAs, column tiles fastest. The dequant (and GELU) is
// dequant() and gelu_tanh() of csrc/int8_epilogue.cuh, as in gemm_kernel,
// on exact int32 sums: the two kernels agree bit for bit.
template <typename C, int EPI, typename Out>
__global__ void __launch_bounds__(wg::kThreads, 1)
    gemm_kernel_wg(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                   const Params p) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(16) Out out_stage[wg::kConsumerWarps][16 * 32];
  wg::run<C, int>(wg_smem, &ma, &mb, p.m, p.n, p.k, [&](int (&acc)[C::ACC], int row0, int col0,
                                                       int cw) {
    const int lane = threadIdx.x & 31;
    const int wr0 = warp_row0<C>(row0, cw), wc0 = warpgroup_col0<C>(col0, cw);
    const int r = wr0 + (lane >> 2), c = wc0 + 2 * (lane & 3);
    float xs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) xs[h] = r + 8 * h < p.m ? p.xs[r + 8 * h] : 0.f;
    wg::store_warp_rows<C::ACC / 4>(
        static_cast<Out*>(p.out), out_stage[(threadIdx.x >> 5) - 4], wr0, wc0, p.m, p.n,
        [&](int i, float(&v)[4]) {
          float2 w, b;
          column_pair(p, c + 8 * i, w, b);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[2 * h] = dequant(acc[4 * i + 2 * h], xs[h], w.x, b.x);
            v[2 * h + 1] = dequant(acc[4 * i + 2 * h + 1], xs[h], w.y, b.y);
            if (EPI == kDequantGelu) {
              v[2 * h] = gelu_tanh(v[2 * h]);
              v[2 * h + 1] = gelu_tanh(v[2 * h + 1]);
            }
          }
        });
  });
}

// facc += f32(acc) * x[row], each product and sum rounded on its own (the
// fold of csrc/int8_mma.cuh's mainloop)
template <int N>
__device__ __forceinline__ void fold(float (&facc)[N], const int (&acc)[N], const float (&x)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    facc[i] = __fadd_rn(facc[i], __fmul_rn(__int2float_rn(acc[i]), x[(i >> 1) & 1]));
}

// int8_linear_blockscale on the wgmma mainloop, for bk a multiple of 128
// (a K block is whole stages): 64 x 256 tiles, each consumer warpgroup the
// tile's 64 rows by 128 columns on m64n128 (64 accumulators a thread, beside
// the 64 of the f32 sum facc), five stages of 40 KB, persistent CTAs,
// column tiles fastest. At a
// block's end the warpgroup waits for its last group and folds the int32
// sum into facc with its row scales (facc += f32(acc) * xs[kb, row], in kb
// order); the block's first k-step then writes acc instead of adding to it.
// A second accumulator set, to fold block kb - 1 while block kb's products
// run, made ptxas serialize every wgmma (C7514: accumulators read inside the
// pipeline) and was slower. The int32 sums are exact and the fold's order
// is gemm_kernel's: the two agree bit for bit.
template <typename C, typename Out>
__global__ void __launch_bounds__(wg::kThreads, 1)
    blockscale_kernel_wg(const __grid_constant__ CUtensorMap ma,
                         const __grid_constant__ CUtensorMap mb, const Params p) {
  using Consumer = wg::Consumer<C, int>;
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(16) Out out_stage[wg::kConsumerWarps][16 * 32];
  wg::roles<C, int>(wg_smem, &ma, &mb, p.m, p.n, p.k, [&](const Consumer& c,
                                                         const wg::Tiles<C>& tiles, int, int cw) {
    const int spb = p.bk / wg::kRowBytes, n_kb = p.k / p.bk;  // stages a K block, K blocks
    const int lane = threadIdx.x & 31;
    int it = 0;  // stages consumed so far, over all tiles
    for (int t = tiles.first; t < tiles.count; t += tiles.step) {
      const int wr0 = warp_row0<C>(tiles.row0(t), cw), wc0 = warpgroup_col0<C>(tiles.col0(t), cw);
      const int r = wr0 + (lane >> 2);
      float facc[C::ACC];
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) facc[i] = 0.f;
      int acc[C::ACC];  // written by each block's first k-step
      for (int kb = 0; kb < n_kb; ++kb) {
        float x[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          x[h] = r + 8 * h < p.m ? p.xs[static_cast<size_t>(kb) * p.m + r + 8 * h] : 0.f;
        for (int st = 0; st < spb; ++st, ++it) {
          c.issue(acc, it, st > 0);
          wg::wgmma_wait<1>();  // the previous stage's group is done: free that stage
          if (st > 0) c.release(it - 1);
        }
        wg::wgmma_wait<0>();  // the block's sum is whole
        c.release(it - 1);
        wg::fence_operands(acc);
        fold(facc, acc, x);
      }
      const int col = wc0 + 2 * (lane & 3);
      wg::store_warp_rows<C::ACC / 4>(
          static_cast<Out*>(p.out), out_stage[(threadIdx.x >> 5) - 4], wr0, wc0, p.m, p.n,
          [&](int i, float(&v)[4]) {
            float2 w, b;
            column_pair(p, col + 8 * i, w, b);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              v[2 * h] = __fadd_rn(__fmul_rn(facc[4 * i + 2 * h], w.x), b.x);
              v[2 * h + 1] = __fadd_rn(__fmul_rn(facc[4 * i + 2 * h + 1], w.y), b.y);
            }
          });
    }
  });
}

// Both take the column tiles fastest, so the CTAs in flight share A's row
// blocks (at proj A is 77 MB, more than the L2 cache holds; with row tiles
// fastest it is read once per column block, and #20 ran far slower). The
// stage counts and tile shapes are the fastest of those tried on an H100:
// for #15 four stages (three and two no faster), 128 x 256 beat 64 x 256, and
// a 2-CTA cluster multicasting B was slower; for #20 64 x 256 with five
// stages beat 128 x 128 with three to six.
using Linear = wg::Config<128, 256, 4, 1, 256, true>;
using BlockScale = wg::Config<64, 256, 5, 1, 128, true>;

bool shape_ok(int m, int n, int k) { return m >= 0 && n > 0 && k > 0 && k % 32 == 0 && n % 8 == 0; }

bool blockscale_ok(int m, int n, int k, int bk) {
  return shape_ok(m, n, k) && bk > 0 && bk % 32 == 0 && k % bk == 0;
}

template <int EPI, typename Out>
int launch_gemm(const Params& p, void* stream) {
  const dim3 grid((p.m + 63) / 64, (p.n + kBN - 1) / kBN);
  gemm_kernel<EPI, Out><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

int launch_gelu_quant_mma(const Params& p, void* stream) {
  const int smem = 32 * gelu_quant_pitch(p.bn) * static_cast<int>(sizeof(float));
  const cudaError_t err =
      cudaFuncSetAttribute(gelu_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.m + 31) / 32, p.n / p.bn);
  gelu_quant_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// a kernel on the wgmma mainloop of Config C: both tensor maps, the
// persistent grid, the launch
template <typename C, typename Kernel>
int launch_wg(Kernel kernel, const Params& p, void* stream) {
  CUtensorMap ma, mb;
  dim3 grid;
  const cudaError_t err = wg::prepare<C>(kernel, &ma, &mb, &grid, p.a, p.b, p.m, p.n, p.k, 1, false);
  if (err != cudaSuccess) return err;
  return wg::launch<C>(kernel, grid, static_cast<cudaStream_t>(stream), ma, mb, p);
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
// Every shape it takes runs gemm_kernel_wg (wgmma + TMA; K a multiple of 32
// bytes is TMA's 16-byte row stride, the box's K edge zero-filled).
extern "C" int team_int8_linear(const void* a, const void* b, const void* xs, const void* ws,
                                const void* bias, void* out, int m, int n, int k, int gelu,
                                int out_f32, void* stream) {
  if (!shape_ok(m, n, k)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const Params p = make_params(a, b, xs, ws, bias, out, m, n, k);
  if (gelu) {
    return out_f32 ? launch_wg<Linear>(gemm_kernel_wg<Linear, kDequantGelu, float>, p, stream)
                   : launch_wg<Linear>(gemm_kernel_wg<Linear, kDequantGelu, __nv_bfloat16>, p,
                                       stream);
  }
  return out_f32 ? launch_wg<Linear>(gemm_kernel_wg<Linear, kDequant, float>, p, stream)
                 : launch_wg<Linear>(gemm_kernel_wg<Linear, kDequant, __nv_bfloat16>, p, stream);
}

// team_int8_linear on the mma.sync kernel (gemm_kernel): the kernel that
// gemm_kernel_wg replaced, kept callable so that the two can be held against
// each other bit for bit.
extern "C" int team_int8_linear_mma(const void* a, const void* b, const void* xs, const void* ws,
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
// bk a multiple of 128 (a K block is whole 128-byte stages: the vision
// tower's proj, K 3,072 at bk 512, and the text tower's, K 2,048 at bk 512)
// runs blockscale_kernel_wg (wgmma + TMA); any other bk (32, 64, 96, 160,
// ...: a block edge inside a stage) gemm_kernel on mma.sync.
extern "C" int team_int8_linear_blockscale(const void* a, const void* b, const void* xs,
                                           const void* ws, const void* bias, void* out, int m,
                                           int n, int k, int bk, int out_f32, void* stream) {
  if (!blockscale_ok(m, n, k, bk)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  Params p = make_params(a, b, xs, ws, bias, out, m, n, k);
  p.bk = bk;
  if (bk % wg::kRowBytes == 0) {
    return out_f32 ? launch_wg<BlockScale>(blockscale_kernel_wg<BlockScale, float>, p, stream)
                   : launch_wg<BlockScale>(blockscale_kernel_wg<BlockScale, __nv_bfloat16>, p,
                                           stream);
  }
  return out_f32 ? launch_gemm<kBlockScale, float>(p, stream)
                 : launch_gemm<kBlockScale, __nv_bfloat16>(p, stream);
}

// team_int8_linear_blockscale on the mma.sync kernel at every bk: the
// kernel that blockscale_kernel_wg replaced, kept callable so that the two
// can be held against each other bit for bit.
extern "C" int team_int8_linear_blockscale_mma(const void* a, const void* b, const void* xs,
                                               const void* ws, const void* bias, void* out, int m,
                                               int n, int k, int bk, int out_f32, void* stream) {
  if (!blockscale_ok(m, n, k, bk)) return cudaErrorInvalidValue;
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
  // the wgmma kernel takes bn 256 and 512 at every K here (a multiple of 32
  // bytes: TMA's 16-byte row stride, the box's K edge zero-filled); other
  // blocks keep the mma.sync kernel
  if (bn == 512) return launch_wg<GeluQuant512>(gelu_quant_kernel_wg<GeluQuant512>, p, stream);
  if (bn == 256) return launch_wg<GeluQuant256>(gelu_quant_kernel_wg<GeluQuant256>, p, stream);
  return launch_gelu_quant_mma(p, stream);
}

// team_int8_linear_gelu_quant on the mma.sync kernel at every bn: the kernel
// the wgmma one replaced at bn 256 and 512, kept callable so that the two can
// be held against each other bit for bit.
extern "C" int team_int8_linear_gelu_quant_mma(const void* a, const void* b, const void* xs,
                                               const void* ws, const void* bias, void* q,
                                               void* scales, int m, int n, int k, int bn,
                                               void* stream) {
  if (!shape_ok(m, n, k) || bn <= 0 || bn > kMaxBlockN || n % bn != 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  Params p = make_params(a, b, xs, ws, bias, q, m, n, k);
  p.scales = static_cast<float*>(scales);
  p.bn = bn;
  return launch_gelu_quant_mma(p, stream);
}
