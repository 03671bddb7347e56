// The GEMM probes' kernels, for Hopper (sm_90a), all on wgmma fed by TMA
// (the maps, barriers, ring and descriptors of csrc/wgmma_gemm.cuh).
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
// in f32, the sums are f32 in the tensor cores' order). Bound on an H100 at
// M = N = K = 4096: 137.4 G operations, 0.0695 ms in int8 at 1,979 TOP/s and
// 0.139 ms in bf16 at 989 TFLOP/s; the bytes (101 MB int8) take 0.030 ms.
//
// mxu_ceiling: out [M, N] f32 = sum over i < reps of x[8 (i mod 64) :
// 8 (i mod 64) + M, :] @ w, with w [K, N] given as [N, K]. Every one of the
// reps products is issued on the tensor cores: nothing is multiplied by a
// count and nothing is folded. What it measures is the wgmma ceiling of this
// card at the power limit it runs at: operands already in shared memory, no
// device-memory traffic and no epilogue in the loop. Bound at the probe's
// shape (M = 512, K = N = 768, reps = 2000): 1.208 T operations, 0.610 ms in
// int8 at 1,979 TOP/s, 1.221 ms in bf16 at 989 TFLOP/s; its bytes (x and w,
// 1.6 and 1.2 MB in bf16) stay in L2.
// Design (ceiling_kernel_wg): the reps products are laid out window-major
// (window j's 31 or 32 together) and cut into groups = max(1, SMs / tiles)
// contiguous ranges whose sizes differ by at most one; a CTA takes one 128 x
// 256 output tile and one range, so at the probe's shape 12 tiles x 11
// groups = 132 CTAs fill the card in one wave, each with 181-182 products. A
// CTA holds its SM alone (a 197 KB ring), in the shape of wgmma_gemm.cuh: a
// producer warp stages, for each window of its range and each 128 bytes of
// K, x's box [128 rows from 8 j + row0] and w's [256 rows]; each consumer
// warpgroup issues the stage's four m64n256 wgmma (k16 bf16 into f32, k32 s8
// into s32) once for each of the window's products in the range, back to
// back into the one accumulator it keeps over its whole range, so a 48 KB
// stage feeds about 31 x 4 products (some 17 us of tensor work) and the
// copies hide behind them. (A fresh accumulator a window beside a running
// total would need 256 registers a thread.) Each CTA writes its partial to a
// workspace [groups, M, N]; a second kernel adds them in group order, so the
// result is deterministic: exact in int32 for int8 (then f32, as the TPU
// kernel's output), f32 in a fixed order for bf16.
//
// mlp_mega: y = bf16(f32(hq @ w2) * s2[k]) with hq = clip(rint(gelu_tanh(
// f32(x @ w1) * s1[n]) * qi[n]), +-127) int8, the whole MLP in one kernel:
// x [M, K] int8, w1 given as [N, K], w2 as [K, N]; s1, qi [N], s2 [K] f32.
// Bound at the probe's shape (M = 256 x 197, K = 768, N = 3,072): 475.9 G
// operations, 0.2405 ms at 1,979 TOP/s; its bytes (121 MB) 0.036 ms. What
// limits a fused MLP here is shared memory: hq for 64 rows (wgmma's least M)
// at N = 3,072 is 192 KB of the 227 KB a CTA may have, and each 64-row tile
// takes both weights (4.7 MB) from L2 again.
// Design (mlp_mega_kernel_wg): persistent CTAs of the wgmma_gemm.cuh shape
// (one producer warp, two consumer warpgroups, setmaxnreg 40/232), each
// taking 64-row tiles. hq is resident a slab of 1,536 columns at a time (96
// KB, in 128-byte swizzled blocks of 128 columns: the layout wgmma reads as
// A), which leaves a ring of three 40 KB stages of 128 bytes of K: fc's
// stage is x's box [64, 128 B] and w1's [256, 128 B], proj's w2's [256, 128
// B]. For each chunk of 256 hq columns of the slab the two warpgroups run
// m64n128k32 over K (128 columns each, sharing x's box), then the epilogue
// (the script's _gelu_tanh in its own order, every product and sum rounded
// on its own: __fmul_rn, __fadd_rn; then the requantize) writes hq; then
// proj runs the slab's share in passes of 256 output columns, A = hq from
// shared memory. The first slab's int32 sums are parked in device memory,
// each thread its own (coalesced, read back by the same thread); the second
// slab adds them and stores bf16(f32(sum) * s2). A stage is freed as soon as
// its products are done. CTAs of two neighbouring row tiles form a cluster:
// each loads half of every weight box and multicasts it. Both products are
// exact int32 sums, so the output is the mma.sync kernel's that this
// replaced bit for bit (4 warps, the whole hq at pitch N + 16, 150 TOP/s).
// PERF.md has its time and what was tried: the GELU epilogue overlaps no
// product.

#include "wgmma_gemm.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWindows = 64;      // the ceiling's distinct windows: x rows 8 j, j < 64
constexpr int kWindowStride = 8;

using wg::store2;

// ---------------------------------------------------------------------------
// probe_mm
// ---------------------------------------------------------------------------

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

// The ceiling's tiles: 128 x 256 outputs, each consumer warpgroup 64 rows on
// m64n256 (one config a type, so that either form can be built at another
// width), four 48 KB stages, single CTAs
using CeilingBf16 = wg::Config<128, 256, 4, 1>;
using CeilingS8 = wg::Config<128, 256, 4, 1>;

// where window j's products begin among the reps laid out window-major
// (window j's count_j = reps / 64 + (j < reps % 64) products together)
__device__ __forceinline__ int window_start(int j, int reps) {
  return j * (reps / kWindows) + min(j, reps % kWindows);
}

// One CTA: the output tile blockIdx.x (row tiles fastest) over the products
// [g reps / groups, (g + 1) reps / groups) of group g = blockIdx.y. For each
// window with products in that range and each 128 bytes of K, the producer
// stages x's box (the window's rows 8 j + row0 ...) and w's; the consumers
// issue the stage's four wgmma once for each of the window's products there,
// into the one accumulator the CTA keeps over its whole range, and free the
// stage once the next one's group is issued. The partial goes to part [groups,
// m, n] (zeros where the range is empty).
template <typename C, typename Acc>
__global__ void __launch_bounds__(wg::kThreads, 1)
    ceiling_kernel_wg(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                      Acc* __restrict__ part, int m, int n, int k, int reps, int groups) {
  extern __shared__ uint8_t wg_smem[];
  const wg::Ring<C> ring(wg_smem);
  constexpr int kStep = wg::Consumer<C, Acc>::kStep;  // elements of K a stage holds
  const int ktiles = (k + kStep - 1) / kStep;
  const int row_tiles = (m + C::BM - 1) / C::BM;
  const int row0 = (blockIdx.x % row_tiles) * C::BM, col0 = (blockIdx.x / row_tiles) * C::BN;
  const int grp = blockIdx.y;
  const int lo = static_cast<int>(static_cast<long long>(grp) * reps / groups);
  const int hi = static_cast<int>(static_cast<long long>(grp + 1) * reps / groups);
  auto share = [&](int j) {  // window j's products in [lo, hi)
    return max(0, min(window_start(j + 1, reps), hi) - max(window_start(j, reps), lo));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      wg::bar_init(ring.full(s), 1);
      wg::bar_init(ring.empty(s), C::EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;  // stages issued so far
      for (int j = 0; j < kWindows; ++j) {
        if (share(j) == 0) continue;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % C::STAGES;
          if (it >= C::STAGES) wg::bar_wait(ring.empty(s), (it / C::STAGES - 1) & 1);
          wg::bar_expect_bytes(ring.full(s), C::STAGE_BYTES);
          wg::tma_load(ring.a(s), &mx, ring.full(s), kt * kStep, kWindowStride * j + row0);
#pragma unroll
          for (int r = 0; r < C::BN; r += C::B_BOX)
            wg::tma_load(ring.b(s) + r * wg::kRowBytes, &mw, ring.full(s), kt * kStep, col0 + r);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = warpgroup - 1;
  const wg::Consumer<C, Acc> con(ring, cw);
  Acc d[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) d[i] = 0;
  int it = 0;  // stages consumed so far
  for (int j = 0; j < kWindows; ++j) {
    const int count = share(j);
    if (count == 0) continue;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % C::STAGES;
      wg::bar_wait(ring.full(s), (it / C::STAGES) & 1);
      const uint64_t da = wg::desc_sw128(ring.a(s) + con.a_off);
      const uint64_t db = wg::desc_sw128(ring.b(s) + con.b_off);
      wg::wgmma_fence();
      for (int rep = 0; rep < count; ++rep)
#pragma unroll
        for (int q = 0; q < wg::kRowBytes / 32; ++q) wg::mma(d, da + 2 * q, db + 2 * q);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();  // the previous stage's products are done: free it
      if (it > 0) con.release(it - 1);
    }
  }
  wg::wgmma_wait<0>();
  if (it > 0) con.release(it - 1);
  wg::fence_operands(d);

  const int lane = threadIdx.x & 31;
  const int r0 = row0 + (C::WM == 2 ? cw * 64 : 0) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c0 = col0 + (C::WN == 2 ? cw * C::INSTR_N : 0) + 2 * (lane & 3);
  Acc* out = part + static_cast<size_t>(grp) * m * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= m) continue;
#pragma unroll
    for (int i = 0; i < C::INSTR_N / 8; ++i) {
      const int col = c0 + 8 * i;  // n is a multiple of 8: col + 1 < n too
      if (col < n)
        store2(out + static_cast<size_t>(row) * n + col, d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
    }
  }
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ int add_rn(int a, int b) { return a + b; }

// out = the groups' partial sums added in group order; int32 -> f32 at the end
template <typename Acc>
__global__ void ceiling_reduce_kernel(const Acc* part, float* out, int groups, size_t mn) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  Acc s = part[i];
  for (int gi = 1; gi < groups; ++gi) s = add_rn(s, part[gi * mn + i]);
  if constexpr (std::is_same<Acc, int>::value)
    out[i] = __int2float_rn(s);
  else
    out[i] = s;
}

// Both launches of the ceiling on x's and w's maps: the products into the
// groups' partials, then their sum in group order.
template <typename C, typename Acc>
cudaError_t launch_ceiling(const void* x, const void* w_t, void* part, float* out, int m, int n,
                           int k, int reps, int groups, bool bf16, cudaStream_t s) {
  CUtensorMap mx, mw;
  const int esize = bf16 ? 2 : 1;
  // rows past the last window's are zero-filled; they reach no stored output
  cudaError_t err = wg::make_map(&mx, x, m + kWindowStride * (kWindows - 1), k, esize, C::BM, bf16);
  if (err == cudaSuccess) err = wg::make_map(&mw, w_t, n, k, esize, C::B_BOX, bf16);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ceiling_kernel_wg<C, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(((m + C::BM - 1) / C::BM) * ((n + C::BN - 1) / C::BN), groups);
  err = wg::launch<C>(ceiling_kernel_wg<C, Acc>, grid, s, mx, mw, static_cast<Acc*>(part), m, n, k,
                      reps, groups);
  if (err != cudaSuccess) return err;
  const size_t mn = static_cast<size_t>(m) * n;
  ceiling_reduce_kernel<Acc><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const Acc*>(part), out, groups, mn);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mlp_mega
// ---------------------------------------------------------------------------

// The ring and shared memory of mlp_mega_kernel_wg. Its tiles are row tiles
// only (BN 1: wg::Tiles and wg::grid see one column tile), CLUSTER of them
// neighbouring, whose CTAs multicast the weights' boxes to each other.
struct Mega {
  static constexpr int BM = 64, BN = 1, CLUSTER = 2;
  static constexpr bool COLS_FIRST = false;
  static constexpr int STAGES = 3;
  static constexpr int KB = wg::kRowBytes;        // bytes of K a stage holds: four k32 steps
  static constexpr int BOX = 256;                 // rows of a weight box: two warpgroups of n128
  static constexpr int HALF = BOX / 2;            // a consumer warpgroup's rows of it
  static constexpr int B_SLICE = BOX / CLUSTER;   // rows of it a CTA loads and multicasts
  static constexpr int A_BYTES = BM * KB;         // x's box (fc stages only)
  static constexpr int B_BYTES = BOX * KB;        // w1's (fc) or w2's (proj) box
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SLAB = 1536;               // hq columns resident at a time
  static constexpr int SLABS = 2;                 // at most: N <= SLABS * SLAB
  static constexpr int HQ_BLOCK = BM * 128;       // 128 columns of hq, 128-byte swizzled
  static constexpr int HQ_BYTES = BM * SLAB;
  static constexpr int SMEM = 1024 + HQ_BYTES + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  // a CTA's parked proj sums of a pass: int32 [2 warpgroups][16][128 threads][4]
  static constexpr int PARK_INTS_PER_PASS = 2 * 64 * 128;
};

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

// A consumer warpgroup's view of the megakernel's ring (cw, 0 or 1, its
// index; it, the stages consumed so far over all of the CTA's tiles).
struct MegaConsumer {
  const uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  int cw;
  bool lane0;
  int it;

  // every consumer warp of the cluster frees stage i
  __device__ __forceinline__ void release(int i) const {
    if (!lane0) return;
#pragma unroll
    for (int cta = 0; cta < Mega::CLUSTER; ++cta) wg::bar_arrive_at(empty + i % Mega::STAGES, cta);
  }

  // the four k32 products of stage it into acc (A: the stage's x box, or
  // hq's columns [128 ks, 128 ks + 128) where a_hq is given), issued as one
  // group; the stage is freed as soon as they are done (a stage is 40 KB and
  // the ring three deep: freeing it a group later would leave one load in
  // flight)
  __device__ __forceinline__ void step(int (&acc)[64], int ks, const uint8_t* a_hq) {
    const int s = it % Mega::STAGES;
    const uint8_t* st = ring + s * Mega::STAGE_BYTES;
    wg::bar_wait(full + s, (it / Mega::STAGES) & 1);
    const uint64_t da = wg::desc_sw128(a_hq != nullptr ? a_hq + ks * Mega::HQ_BLOCK : st);
    const uint64_t db = wg::desc_sw128(st + Mega::A_BYTES + cw * Mega::HALF * Mega::KB);
    wg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < Mega::KB / 32; ++j) wg::mma(acc, da + 2 * j, db + 2 * j, ks > 0 || j > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    release(it);
    ++it;
  }
};

// A consumer thread's proj sums of one pass, parked in device memory between
// the slabs of hq (each thread its own 64 values, in 16-byte pieces that
// neighbouring threads' pieces follow: coalesced, and read back by the
// thread that wrote them, so no other thread's order matters)
__device__ __forceinline__ int4* parked(int* park, int passes, int pass, int cw) {
  return reinterpret_cast<int4*>(park + (static_cast<size_t>(blockIdx.x) * passes + pass) *
                                            Mega::PARK_INTS_PER_PASS +
                                 cw * 64 * 128) +
         (threadIdx.x & 127);
}

// the two consumer warpgroups (256 threads) meet; barrier 0 is __syncthreads
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

__global__ void __launch_bounds__(wg::kThreads, 1)
    mlp_mega_kernel_wg(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw1,
                       const __grid_constant__ CUtensorMap mw2, const float* __restrict__ s1,
                       const float* __restrict__ qi, const float* __restrict__ s2,
                       __nv_bfloat16* __restrict__ out, int* __restrict__ park, int m, int k, int n) {
  using M = Mega;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* hq = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(wg_smem) + 1023) &
                                           ~uintptr_t{1023});
  uint8_t* ring = hq + M::HQ_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + M::STAGES * M::STAGE_BYTES);
  uint64_t* empty = full + M::STAGES;
  const int slabs = (n + M::SLAB - 1) / M::SLAB, fc_steps = (k + M::KB - 1) / M::KB;
  const int passes = (k + M::BOX - 1) / M::BOX;
  auto slab_n = [&](int sl) { return min(M::SLAB, n - sl * M::SLAB); };  // a multiple of 32
  if (threadIdx.x == 0) {
    for (int s = 0; s < M::STAGES; ++s) {
      wg::bar_init(full + s, 1);
      wg::bar_init(empty + s, wg::kConsumerWarps * M::CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  wg::cluster_sync();
  const wg::Tiles<M> tiles(m, 1);
  const int warpgroup = threadIdx.x / 128;

  if (warpgroup == 0) {  // the producer: per tile and slab, fc's x and w1 boxes, then proj's w2 boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const uint16_t mask = (1u << M::CLUSTER) - 1;
      const int b0 = tiles.rank * M::B_SLICE;
      int it = 0;
      auto acquire = [&](int bytes) {
        const int s = it % M::STAGES;
        if (it >= M::STAGES) wg::bar_wait(empty + s, (it / M::STAGES - 1) & 1);
        wg::bar_expect_bytes(full + s, bytes);
        return ring + s * M::STAGE_BYTES;
      };
      for (int t = tiles.first; t < tiles.count; t += tiles.step) {
        const int row0 = tiles.row0(t);
        for (int sl = 0; sl < slabs; ++sl) {
          const int n0 = sl * M::SLAB, nc = slab_n(sl);
          for (int c = 0; c < nc; c += M::BOX)
            for (int ks = 0; ks < fc_steps; ++ks, ++it) {
              uint8_t* st = acquire(M::STAGE_BYTES);
              uint64_t* bar = full + (it % M::STAGES);
              wg::tma_load(st, &mx, bar, ks * M::KB, row0);
              wg::tma_load_multicast(st + M::A_BYTES + b0 * M::KB, &mw1, bar, ks * M::KB,
                                     n0 + c + b0, mask);
            }
          for (int p = 0; p < passes; ++p)
            for (int ks = 0; ks < (nc + M::KB - 1) / M::KB; ++ks, ++it) {
              uint8_t* st = acquire(M::B_BYTES);
              wg::tma_load_multicast(st + M::A_BYTES + b0 * M::KB, &mw2, full + (it % M::STAGES),
                                     n0 + ks * M::KB, p * M::BOX + b0, mask);
            }
        }
      }
    }
    wg::cluster_sync();  // a peer's consumers still arrive on this CTA's barriers
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = warpgroup - 1;
  const int wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  MegaConsumer con{ring, full, empty, cw, lane == 0, 0};
  for (int t = tiles.first; t < tiles.count; t += tiles.step) {
    const int row0 = tiles.row0(t);
    for (int sl = 0; sl < slabs; ++sl) {
      const int n0 = sl * M::SLAB, nc = slab_n(sl);
      // fc: the slab's hq = requant(gelu(f32(x @ w1) * s1)) into shared
      // memory, 256 columns a chunk (128 a warpgroup), in the layout proj's
      // wgmma reads
      for (int c = 0; c < nc; c += M::BOX) {
        int acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0;
        for (int ks = 0; ks < fc_steps; ++ks) con.step(acc, ks, nullptr);
        wg::fence_operands(acc);
        const int blk = c / 128 + cw;  // the slab's 128-column block
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + g + 8 * h;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int b = 8 * i + 2 * t4, col = n0 + 128 * blk + b;  // col + 1 < n too
            if (128 * blk + b >= nc) continue;
            const int8_t q0 = requant(
                gelu_tanh_script(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h]), s1[col])), qi[col]);
            const int8_t q1 = requant(
                gelu_tanh_script(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h + 1]), s1[col + 1])),
                qi[col + 1]);
            *reinterpret_cast<uint16_t*>(hq + blk * M::HQ_BLOCK + r * 128 +
                                         ((((b >> 4) ^ (r & 7)) << 4) | (b & 15))) =
                static_cast<uint16_t>(static_cast<uint8_t>(q0) | (static_cast<uint8_t>(q1) << 8));
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // hq, for wgmma's reads
      consumers_sync();
      // proj: the slab's share of hq @ w2, A = hq, 256 output columns a
      // pass; the sums of every slab but the last are parked, the last adds
      // them and stores y = bf16(f32(sum) * s2)
      for (int p = 0; p < passes; ++p) {
        int acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0;
        for (int ks = 0; ks < (nc + M::KB - 1) / M::KB; ++ks) con.step(acc, ks, hq);
        wg::fence_operands(acc);
        int4* mine = parked(park, passes, p, cw);
        if (sl > 0) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int4 v = mine[128 * j];
            acc[4 * j] += v.x;
            acc[4 * j + 1] += v.y;
            acc[4 * j + 2] += v.z;
            acc[4 * j + 3] += v.w;
          }
        }
        if (sl + 1 < slabs) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            mine[128 * j] = make_int4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 16 * wq + g + 8 * h;
          if (row >= m) continue;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int col = p * M::BOX + cw * M::HALF + 8 * i + 2 * t4;  // k is a multiple of 32
            if (col >= k) continue;
            const float y0 = __fmul_rn(__int2float_rn(acc[4 * i + 2 * h]), s2[col]);
            const float y1 = __fmul_rn(__int2float_rn(acc[4 * i + 2 * h + 1]), s2[col + 1]);
            *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * k + col) =
                __floats2bfloat162_rn(y0, y1);
          }
        }
      }
      consumers_sync();  // both warpgroups are done with hq before the next slab writes it
    }
  }
  wg::cluster_sync();
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

// x [m + 504 or more, k] and w_t [n, k] row-major, 16-byte aligned, int8 (bf16
// = 0, k a multiple of 32) or bfloat16 (k a multiple of 16); part a workspace
// of groups * m * n 4-byte values; out float32 [m, n]; n a multiple of 8.
extern "C" int team_mxu_ceiling(const void* x, const void* w_t, void* part, void* out, int m, int n,
                                int k, int reps, int groups, int bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % (bf16 ? 16 : 32) != 0 || reps < 0 ||
      groups <= 0 || groups > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bf16) return launch_ceiling<CeilingBf16, float>(x, w_t, part, o, m, n, k, reps, groups, true, s);
  return launch_ceiling<CeilingS8, int>(x, w_t, part, o, m, n, k, reps, groups, false, s);
}

// The widest N (hidden width) the megakernel takes: SLABS slabs of hq.
extern "C" int team_mlp_mega_max_n() { return Mega::SLABS * Mega::SLAB; }

namespace {

// the megakernel's persistent grid for m rows
cudaError_t mega_grid(int m, dim3* grid) {
  cudaError_t err = cudaFuncSetAttribute(mlp_mega_kernel_wg,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Mega::SMEM);
  if (err == cudaSuccess) err = wg::grid<Mega>(mlp_mega_kernel_wg, m, 1, grid);
  return err;
}

}  // namespace

// The bytes of device memory a call parks its proj sums in (0 where N fits
// one slab): the caller allocates them and passes them to team_mlp_mega.
extern "C" long long team_mlp_mega_park_bytes(int m, int k, int n) {
  if (m <= 0 || k <= 0 || n <= Mega::SLAB) return 0;
  dim3 grid;
  if (mega_grid(m, &grid) != cudaSuccess) return -1;
  const int passes = (k + Mega::BOX - 1) / Mega::BOX;
  return static_cast<long long>(grid.x) * passes * Mega::PARK_INTS_PER_PASS * sizeof(int);
}

// x int8 [m, k]; w1_t int8 [n, k]; s1, qi float32 [n]; w2_t int8 [k, n]; s2
// float32 [k]; out bfloat16 [m, k]; all row-major, 16-byte aligned; k and n
// multiples of 32, n at most team_mlp_mega_max_n(); park: the
// team_mlp_mega_park_bytes(m, k, n) bytes (NULL where that is 0), 16-byte
// aligned.
extern "C" int team_mlp_mega(const void* x, const void* w1_t, const void* s1, const void* qi,
                             const void* w2_t, const void* s2, void* out, void* park, int m, int k,
                             int n, void* stream) {
  if (m < 0 || k <= 0 || n <= 0 || k % 32 != 0 || n % 32 != 0 || n > team_mlp_mega_max_n())
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  if (n > Mega::SLAB && park == nullptr) return cudaErrorInvalidValue;
  CUtensorMap mx, mw1, mw2;
  cudaError_t err = wg::make_map(&mx, x, m, k, 1, Mega::BM, false);
  if (err == cudaSuccess) err = wg::make_map(&mw1, w1_t, n, k, 1, Mega::B_SLICE, false);
  if (err == cudaSuccess) err = wg::make_map(&mw2, w2_t, k, n, 1, Mega::B_SLICE, false);
  dim3 grid;
  if (err == cudaSuccess) err = mega_grid(m, &grid);
  if (err != cudaSuccess) return err;
  return wg::launch<Mega>(mlp_mega_kernel_wg, grid, static_cast<cudaStream_t>(stream), mx, mw1, mw2,
                          static_cast<const float*>(s1), static_cast<const float*>(qi),
                          static_cast<const float*>(s2), static_cast<__nv_bfloat16*>(out),
                          static_cast<int*>(park), m, k, n);
}
