// The GEMM probes' kernels, for Hopper (sm_90a), on the tensor cores:
// probe_mm and mlp_mega through wgmma (csrc/wgmma_gemm.cuh), mxu_ceiling
// through mma.sync (the s8 helpers of csrc/int8_mma.cuh, the bf16 fragments
// of csrc/bf16_mma.cuh).
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
//
// The ceiling runs mma.sync from shared memory by design; its times are in
// PERF.md.

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
