// The Hopper GEMM mainloop: TMA loads into a ring of shared-memory stages,
// one producer warp, two consumer warpgroups on wgmma (sm_90a). Shared by
// csrc/int8_gemm.cu (s8: #15 int8_linear and its tilings, gemm_kernel_wg;
// #20 int8_linear_blockscale, blockscale_kernel_wg; #21
// int8_linear_gelu_quant at bn 256 and 512, gelu_quant_kernel_wg; the TPU
// kernels of team_tpu/ops/int8_matmul.py:54, :565 and :506) and
// csrc/gemm_probe.cu (#27 probe_mm, s8 and bf16; scripts/int8_probe.py:48
// pallas_mm; #30 mlp_mega takes its maps, barriers, TMA, descriptors, wgmma
// and tile walk, with a producer and ring of its own; #28 mxu_ceiling its
// config, ring, barriers and consumer descriptors, with a loop of its own
// that issues each staged pair of boxes once for every product). Beside it,
// store_warp_rows: the epilogues' stores, staged to whole 32-byte sectors.
//
// What it replaces. For these kernels, the mma.sync mainloops of
// csrc/int8_mma.cuh (s8) and a bf16 one: four warps, 64 x 128 or 32 x 128
// tiles, two cp.async stages. mma.sync from shared memory reached about
// half the dense tensor-core peaks on an H100; wgmma fed by TMA reaches
// them (#28, the ceiling probe, measures how near: PERF.md).
//
// What bounds it. The operations at the shapes that use it: #21 at the
// ViT-B/16 fc shape (M 25,216, K 768, N 3,072) and #20 at proj (K 3,072, N
// 768) do 119 G int8 operations each, 0.060 ms at the dense 1,979 TOP/s;
// #15 at qkv (K 768, N 2,304) 89 G; #27 at 4096^3 137.4 G, 0.069 ms in s8
// at 1,979 TOP/s and 0.139 ms in bf16 at 989 TFLOP/s. A CTA tile of BM x BN takes (BM + BN) x 128 bytes into shared
// memory for each 128 bytes of K: 72 KB at 64 x 512 (s8), 48 KB at 128 x 256,
// 40 KB at 64 x 256, for 0.28-0.56 us of tensor work. At K 768 a tile is
// only six stages, so what a tile costs besides its stages (filling the
// ring, the epilogue, the stores) weighs as much as the stages themselves.
//
// Design.
// - Operands A [M, K] and B [N, K], both K-major, as the port lays them out.
//   Host code builds a TMA tensor map for each (cuTensorMapEncodeTiled, found
//   through cudaGetDriverEntryPointByVersion, so nothing links libcuda): a box
//   of 128 bytes of K by BM rows (A) or up to 256 rows (B), with the 128-byte
//   swizzle. TMA zero-fills the box past M, N and K, so no operand is padded
//   or copied and K needs only the 16-byte row stride TMA asks.
// - The maps are __grid_constant__ kernel parameters. A stage holds A's box
//   and B's boxes; each stage has a "full" mbarrier (the producer's expected
//   bytes, completed by TMA) and an "empty" one (one arrival from each
//   consumer warp of the cluster once its products on the stage are done).
// - 384 threads: warpgroup 0 is the producer (one thread issues every load;
//   setmaxnreg gives its registers away, 40 a thread), warpgroups 1 and 2
//   consume (232 a thread). A consumer warpgroup owns 64 rows x INSTR_N
//   columns (Config: m64n256, 128 accumulators a thread, or m64n128, 64 a
//   thread, where the kernel keeps an f32 sum beside them):
//   WM x WN = 2 warpgroups over the CTA tile, so BM x BN is 128 x INSTR_N
//   (A rows split, B shared) or 64 x 2 INSTR_N (A shared, B split).
// - Per stage each consumer issues four wgmma.mma_async from shared memory
//   (k32 s8 into s32, k16 bf16 into f32: 32 bytes of K each), commits them
//   as one group, waits until only that group is in flight and then frees
//   the previous stage, so the tensor cores always hold one group while the
//   next stage's barrier is polled.
// - Persistent CTAs, one an SM (a CTA's ring fills the SM's shared memory;
//   with clusters, as many as the card holds at once): the ring runs on
//   across a CTA's tiles, so the producer loads the next tile while the
//   consumers run the kernel's epilogue on theirs.
// - The tile order: row tiles fastest (#21, #27: the CTAs in flight share B's
//   column block), or column tiles fastest (Config's COLS_FIRST; #15, #20:
//   they share A's row blocks, and #20's 77 MB A, more than the L2 cache
//   holds, is read about once).
// - CLUSTER > 1: CTAs of neighbouring row tiles form a cluster; each loads
//   1/CLUSTER of B's rows and multicasts them to all, and a stage is freed
//   only when the consumers of every CTA of the cluster are done with it.
// - run() is the plain mainloop (one accumulator set, the epilogue after the
//   tile's last stage); roles() gives a kernel the producer and the ring and
//   leaves its consumer loop to it (#20 folds each K block's int32 sum into
//   an f32 sum at the block's end, Consumer::issue and release).
// The accumulator of a consumer thread: d[4 i + 2 h + e] is row
// 16 (warp % 4) + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + e of its
// warpgroup's 64 x INSTR_N tile (i < INSTR_N / 8).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace wg {

constexpr int kRowBytes = 128;  // bytes of K a stage holds: the span of the 128-byte swizzle
constexpr int kThreads = 384;   // the producer warpgroup and two consumer warpgroups
constexpr int kBoxRows = 256;   // the most rows a TMA box may have
constexpr int kConsumerWarps = 8;

// A CTA tile of BM x BN, a ring of STAGES stages, CLUSTER CTAs of
// neighbouring row tiles that share B (each loads BN / CLUSTER of its rows
// and multicasts them to all), consumer warpgroups of 64 x INSTR_N, the
// width of their wgmma (m64n256 or m64n128), and the order of the tiles:
// row tiles fastest, or with COLS_FIRST column tiles fastest (Tiles)
template <int BM_, int BN_, int STAGES_, int CLUSTER_, int INSTR_N_ = 256, bool COLS_FIRST_ = false>
struct Config {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, CLUSTER = CLUSTER_;
  static constexpr int INSTR_N = INSTR_N_;
  static constexpr bool COLS_FIRST = COLS_FIRST_;
  static constexpr int ACC = INSTR_N / 2;  // accumulators of a consumer thread
  static constexpr int WM = BM / 64, WN = BN / INSTR_N;  // consumer warpgroups along M and N
  static_assert(INSTR_N == 128 || INSTR_N == 256, "m64n128 or m64n256");
  static_assert(WM * WN == 2, "two consumer warpgroups of 64 x INSTR_N");
  static constexpr int A_BYTES = BM * kRowBytes;
  static constexpr int B_BYTES = BN * kRowBytes;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int B_SLICE = BN / CLUSTER;  // rows of B a CTA loads
  static constexpr int B_BOX = B_SLICE < kBoxRows ? B_SLICE : kBoxRows;
  // a stage is free once every consumer warp of the cluster is done with it
  static constexpr int EMPTY_ARRIVALS = kConsumerWarps * CLUSTER;
  // the stages, 1,024-byte aligned (the swizzle's period) by hand, then the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

// ---------------------------------------------------------------------------
// host: the tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The map of a row-major [rows, k] operand (k in elements of esize bytes, a
// 16-byte aligned base): boxes of 128 bytes of K by box_rows rows, 128-byte
// swizzle, zeros past the edges.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int k, int esize,
                            int box_rows, bool bf16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            2, const_cast<void*>(base), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch of a grid in clusters of C::CLUSTER along M.
template <typename C>
struct LaunchConfig {
  cudaLaunchAttribute cluster[1];
  cudaLaunchConfig_t cfg = {};
  LaunchConfig(dim3 grid, cudaStream_t stream) {
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = C::CLUSTER;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
};

// The persistent grid of an m x n problem: as many clusters as the card
// holds at once (one CTA an SM; a cluster's CTAs must share a GPC), or
// fewer where there are fewer tiles.
template <typename C, typename Kernel>
cudaError_t grid(Kernel kernel, int m, int n, dim3* g) {
  int device = 0, sms = 0, clusters = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  clusters = sms / C::CLUSTER;
  if (err == cudaSuccess && C::CLUSTER > 1) {
    const LaunchConfig<C> lc(dim3(clusters * C::CLUSTER), nullptr);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &lc.cfg);
  }
  const int row_tiles = ((m + C::BM - 1) / C::BM + C::CLUSTER - 1) / C::CLUSTER;
  const int tiles = row_tiles * ((n + C::BN - 1) / C::BN);  // in clusters
  *g = dim3((clusters < tiles ? clusters : tiles) * C::CLUSTER);
  return err == cudaSuccess && clusters < 1 ? cudaErrorInvalidConfiguration : err;
}

// Launch kernel(args...) on the grid in clusters of C::CLUSTER along M.
template <typename C, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, cudaStream_t stream, const Args&... args) {
  const LaunchConfig<C> lc(grid, stream);
  return cudaLaunchKernelEx(&lc.cfg, kernel, args...);
}

// Both maps of a launch, its persistent grid and the kernel's shared-memory
// allowance.
template <typename C, typename Kernel>
cudaError_t prepare(Kernel kernel, CUtensorMap* ma, CUtensorMap* mb, dim3* g, const void* a,
                    const void* b, int m, int n, int k, int esize, bool bf16) {
  cudaError_t err = make_map(ma, a, m, k, esize, C::BM, bf16);
  if (err == cudaSuccess) err = make_map(mb, b, n, k, esize, C::B_BOX, bf16);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err == cudaSuccess) err = grid<C>(kernel, m, n, g);
  return err;
}

// ---------------------------------------------------------------------------
// device: barriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// an arrival on the barrier at bar's offset in CTA cta of the cluster
__device__ __forceinline__ void bar_arrive_at(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_addr(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: no CTA leaves while a peer may
// still arrive on its barriers, and none starts before the peers' barriers
// are initialised
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// a box at (k, row) of the map into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k), "r"(row)
      : "memory");
}

// as tma_load, into dst and onto bar's offset in every CTA of mask
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                   int k, int row, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(mask), "r"(k), "r"(row)
      : "memory");
}

// the descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle, at a 1,024-byte aligned address: 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WG_D64                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                  \
  "%8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "           \
  "%24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, "           \
  "%40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, "           \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_D128                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                  \
  "%8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "           \
  "%24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, "           \
  "%40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, "           \
  "%56, %57, %58, %59, %60, %61, %62, %63, "           \
  "%64, %65, %66, %67, %68, %69, %70, %71, "           \
  "%72, %73, %74, %75, %76, %77, %78, %79, "           \
  "%80, %81, %82, %83, %84, %85, %86, %87, "           \
  "%88, %89, %90, %91, %92, %93, %94, %95, "           \
  "%96, %97, %98, %99, %100, %101, %102, %103, "       \
  "%104, %105, %106, %107, %108, %109, %110, %111, "   \
  "%112, %113, %114, %115, %116, %117, %118, %119, "   \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define WG_OP8(C, d, i)                                                                      \
  C(d[(i)]), C(d[(i) + 1]), C(d[(i) + 2]), C(d[(i) + 3]), C(d[(i) + 4]), C(d[(i) + 5]), \
      C(d[(i) + 6]), C(d[(i) + 7])
#define WG_OP64(C, d)                                                                      \
  WG_OP8(C, d, 0), WG_OP8(C, d, 8), WG_OP8(C, d, 16), WG_OP8(C, d, 24), WG_OP8(C, d, 32), \
      WG_OP8(C, d, 40), WG_OP8(C, d, 48), WG_OP8(C, d, 56)
#define WG_OP128(C, d)                                                                        \
  WG_OP8(C, d, 0), WG_OP8(C, d, 8), WG_OP8(C, d, 16), WG_OP8(C, d, 24), WG_OP8(C, d, 32),    \
      WG_OP8(C, d, 40), WG_OP8(C, d, 48), WG_OP8(C, d, 56), WG_OP8(C, d, 64),               \
      WG_OP8(C, d, 72), WG_OP8(C, d, 80), WG_OP8(C, d, 88), WG_OP8(C, d, 96),               \
      WG_OP8(C, d, 104), WG_OP8(C, d, 112), WG_OP8(C, d, 120)

// d += A (64 x 32 s8) B^T (256 x 32 s8), exact in int32; d = A B^T where
// accumulate is 0
__device__ __forceinline__ void mma(int (&d)[128], uint64_t a, uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WG_D128 ", %128, %129, p;\n}\n"
      : WG_OP128("+r", d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A (64 x 32 s8) B^T (128 x 32 s8), as the m64n256 form
__device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_D64 ", %64, %65, p;\n}\n"
      : WG_OP64("+r", d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A (64 x 16 bf16) B^T (256 x 16 bf16) in f32
__device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_OP128("+f", d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the accumulators are final here: no read of them moves above this point
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#undef WG_OP128
#undef WG_OP64
#undef WG_OP8
#undef WG_D128
#undef WG_D64

// The shared ring of a CTA: STAGES stages of A's and B's boxes, then the
// full and empty barriers.
template <typename C>
struct Ring {
  uint8_t* base;
  __device__ __forceinline__ explicit Ring(uint8_t* raw)
      : base(reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023})) {}
  __device__ __forceinline__ uint8_t* a(int s) const { return base + s * C::STAGE_BYTES; }
  __device__ __forceinline__ uint8_t* b(int s) const { return a(s) + C::A_BYTES; }
  __device__ __forceinline__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + C::STAGES * C::STAGE_BYTES) + s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const { return full(C::STAGES) + s; }
};

// A CTA's share of the tiles: the grid holds at most one cluster of CTAs a
// cluster's worth of SMs, and cluster c takes cluster tiles c, c + clusters,
// ... A cluster tile is CLUSTER neighbouring row tiles of one column block.
// Row tiles run fastest, so the clusters in flight share B's column block
// and each row block of A is read once per column block; with COLS_FIRST
// column tiles run fastest, so the clusters in flight share A's row blocks
// and A is read about once (where A outgrows the L2 cache and B does not:
// #20 at proj reads its 77 MB once instead of once per column block).
template <typename C>
struct Tiles {
  int row_tiles, col_tiles, count, step, first, rank;
  __device__ __forceinline__ Tiles(int m, int n) {
    row_tiles = ((m + C::BM - 1) / C::BM + C::CLUSTER - 1) / C::CLUSTER;  // in clusters
    col_tiles = (n + C::BN - 1) / C::BN;
    count = row_tiles * col_tiles;
    step = gridDim.x / C::CLUSTER;
    first = blockIdx.x / C::CLUSTER;
    rank = C::CLUSTER > 1 ? static_cast<int>(cluster_rank()) : 0;
  }
  __device__ __forceinline__ int row0(int t) const {
    return ((C::COLS_FIRST ? t / col_tiles : t % row_tiles) * C::CLUSTER + rank) * C::BM;
  }
  __device__ __forceinline__ int col0(int t) const {
    return (C::COLS_FIRST ? t % col_tiles : t / row_tiles) * C::BN;
  }
};

// A consumer warpgroup's view of the ring (cw, 0 or 1, its index): stage it
// counts the stages consumed so far, over all of the CTA's tiles.
template <typename C, typename Acc>
struct Consumer {
  static constexpr int kStep = kRowBytes / (std::is_same<Acc, float>::value ? 2 : 1);  // K a stage
  const Ring<C> ring;
  int a_off, b_off;
  bool lane0;
  __device__ __forceinline__ Consumer(const Ring<C>& r, int cw)
      : ring(r),
        a_off((C::WM == 2 ? cw : 0) * 64 * kRowBytes),
        b_off((C::WN == 2 ? cw : 0) * C::INSTR_N * kRowBytes),
        lane0((threadIdx.x & 31) == 0) {}

  // wait for stage it, then issue its products into d as one group (d +=
  // A B^T; the first k-step writes d = A B^T where accumulate is 0)
  __device__ __forceinline__ void issue(Acc (&d)[C::ACC], int it, int accumulate = 1) const {
    const int s = it % C::STAGES;
    bar_wait(ring.full(s), (it / C::STAGES) & 1);
    const uint64_t da = desc_sw128(ring.a(s) + a_off), db = desc_sw128(ring.b(s) + b_off);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kRowBytes / 32; ++j)  // 32 bytes = 2 x 16
      mma(d, da + 2 * j, db + 2 * j, j > 0 ? 1 : accumulate);
    wgmma_commit();
  }

  // every consumer warp of the cluster frees stage it
  __device__ __forceinline__ void release(int it) const {
    if (!lane0) return;
    const int s = it % C::STAGES;
    if (C::CLUSTER > 1) {
#pragma unroll
      for (int cta = 0; cta < C::CLUSTER; ++cta) bar_arrive_at(ring.empty(s), cta);
    } else {
      bar_arrive(ring.empty(s));
    }
  }
};

// The CTA's roles over out = A [m, k] B [n, k]^T (k in elements of the
// operands: s8 with int accumulators, bf16 with float ones). The producer
// warpgroup's first thread streams every stage of every tile through the
// ring; each consumer warpgroup calls consume(consumer, tiles, ktiles, cw)
// (ktiles: the stages of a tile), which walks the CTA's tiles and consumes
// every stage of each in order. Every thread of the CTA calls it.
template <typename C, typename Acc, typename Consume>
__device__ __forceinline__ void roles(uint8_t* smem, const CUtensorMap* ma, const CUtensorMap* mb,
                                      int m, int n, int k, Consume&& consume) {
  constexpr int kStep = Consumer<C, Acc>::kStep;
  const Ring<C> ring(smem);
  const int ktiles = (k + kStep - 1) / kStep;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      bar_init(ring.full(s), 1);
      bar_init(ring.empty(s), C::EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (C::CLUSTER > 1)
    cluster_sync();
  else
    __syncthreads();
  const Tiles<C> tiles(m, n);

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int b0 = tiles.rank * C::B_SLICE;
      int it = 0;  // stages issued so far, over all tiles
      for (int t = tiles.first; t < tiles.count; t += tiles.step) {
        const int row0 = tiles.row0(t), col0 = tiles.col0(t);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % C::STAGES;
          if (it >= C::STAGES) bar_wait(ring.empty(s), (it / C::STAGES - 1) & 1);
          bar_expect_bytes(ring.full(s), C::STAGE_BYTES);  // A's box and all of B's
          tma_load(ring.a(s), ma, ring.full(s), kt * kStep, row0);
#pragma unroll
          for (int r = b0; r < b0 + C::B_SLICE; r += C::B_BOX) {
            if (C::CLUSTER > 1)
              tma_load_multicast(ring.b(s) + r * kRowBytes, mb, ring.full(s), kt * kStep,
                                 col0 + r, (1u << C::CLUSTER) - 1);
            else
              tma_load(ring.b(s) + r * kRowBytes, mb, ring.full(s), kt * kStep, col0 + r);
          }
        }
      }
    }
    if (C::CLUSTER > 1) cluster_sync();  // a peer's consumers still arrive on this CTA's barriers
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = warpgroup - 1;
  const Consumer<C, Acc> consumer(ring, cw);
  consume(consumer, tiles, ktiles, cw);
  if (C::CLUSTER > 1) cluster_sync();
}

// The CTA's tiles of out = A B^T on roles: each consumer warpgroup runs the
// tile's products into d (64 x INSTR_N, zeroed here) and then epi(d, row0,
// col0, cw): the CTA tile's first row and column and its own index. Each
// stage's group is left in flight while the next stage's barrier is polled:
// the previous stage is freed once only the newest group is outstanding.
// The producer runs ahead into the next tile while the consumers are in
// their epilogue.
template <typename C, typename Acc, typename Epi>
__device__ __forceinline__ void run(uint8_t* smem, const CUtensorMap* ma, const CUtensorMap* mb,
                                    int m, int n, int k, Epi&& epi) {
  roles<C, Acc>(smem, ma, mb, m, n, k, [&](const Consumer<C, Acc>& c, const Tiles<C>& tiles,
                                           int ktiles, int cw) {
    int it = 0;
    for (int t = tiles.first; t < tiles.count; t += tiles.step) {
      Acc d[C::ACC];
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) d[i] = 0;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        c.issue(d, it);
        wgmma_wait<1>();  // the previous stage's group is done: free that stage
        if (kt > 0) c.release(it - 1);
      }
      wgmma_wait<0>();
      c.release(it - 1);
      fence_operands(d);
      epi(d, tiles.row0(t), tiles.col0(t), cw);
    }
  });
}

// ---------------------------------------------------------------------------
// device: the epilogue's stores
// ---------------------------------------------------------------------------

// two adjacent outputs (rounded to the output type)
__device__ __forceinline__ void store2(float* out, float y0, float y1) {
  *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y0, y1);
}

__device__ __forceinline__ void store2(int* out, int y0, int y1) {
  *reinterpret_cast<int2*>(out) = make_int2(y0, y1);
}

// A consumer warp's 16 rows of a tile's output (row0 + lane / 4 + 8 h, h <
// 2) over NI x 8 columns (col0 + 8 i + 2 (lane % 4) + e, e < 2) to out [m,
// n]: y(i, v) gives column group i's four values, v[2 h + e] (of type V:
// f32 for a bf16 or f32 output, int for int32). They leave 32 columns at a
// time through the warp's buffer of 16 rows x 32 columns, so each lane
// stores whole 16-byte pieces and each row's 32 columns fill whole 32-byte
// sectors (straight from the registers a warp store writes 4 or 8 bytes a
// lane, in pieces of a quarter or half a sector). The buffer's 16-byte
// chunks are swizzled by row, so neither the fragment writes nor the piece
// reads meet a bank conflict. Rows past m and columns past n are not stored
// (n is a multiple of 8: a piece is all in or all out).
template <int NI, typename V = float, typename Out, typename Y>
__device__ __forceinline__ void store_warp_rows(Out* out, Out* buf, int row0, int col0, int m,
                                                int n, Y&& y) {
  constexpr int kE = sizeof(Out);         // 2 or 4 bytes
  constexpr int kChunks = 32 * kE / 16;   // 16-byte chunks of a buffer row: 4 or 8
  constexpr int kPieces = 16 * kChunks / 32;  // pieces a lane stores per 32 columns
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(buf);
  // 2-byte outputs: rows r and r + 2 share banks (64-byte rows); 4-byte: the
  // four rows a half warp writes do (128-byte rows)
  auto at = [&](int r, int chunk) {
    const int swz = kE == 2 ? (r >> 1) & 3 : (r & 3) << 1;
    return bytes + r * 32 * kE + (chunk ^ swz) * 16;
  };
#pragma unroll
  for (int j = 0; j < NI / 4; ++j) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      V v[4];
      y(4 * j + ii, v);
      const int byte = (8 * ii + 2 * t) * kE;  // in the buffer's row
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(reinterpret_cast<Out*>(at(g + 8 * h, byte / 16) + byte % 16), v[2 * h],
               v[2 * h + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const int piece = lane + 32 * q;
      const int r = piece / kChunks, chunk = piece % kChunks;
      const int row = row0 + r, col = col0 + 32 * j + chunk * (16 / kE);
      if (row < m && col < n)
        *reinterpret_cast<int4*>(out + static_cast<size_t>(row) * n + col) =
            *reinterpret_cast<const int4*>(at(r, chunk));
    }
    __syncwarp();
  }
}

}  // namespace wg
