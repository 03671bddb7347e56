// The s8 tensor-core mainloop shared by csrc/int8_gemm.cu (the dynamic int8
// tiers' GEMMs) and csrc/gemm_probe.cu (the GEMM probes), for Hopper (sm_90a).
//
// A CTA computes a tile of BM rows by kBN = 128 columns with four warps. K is
// streamed through shared memory kBK = 64 bytes at a time, two stages deep, by
// cp.async (16 bytes a thread, zero-filled past the ragged edge of M, N or K,
// so no operand is padded or copied). Each warp multiplies its share with
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 from fragments read as 32-bit
// words; the rows of a stage are 80 bytes apart, which puts the eight rows a
// fragment load touches on distinct banks. A is [M, K] row-major; B, the
// "col" operand, is [N, K] row-major (a column-major [K, N]).
//
// The operands come in a struct P with the fields a, b (device pointers), m,
// k (rows of A, bytes of K), and, read only when BLOCKSCALE, xs and bk.
// csrc/bf16_mma.cuh runs the same staging with bf16 operands.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBN = 128;       // columns of a CTA tile
constexpr int kBK = 64;        // bytes of K per pipeline stage (two mma k-steps)
constexpr int kPitch = kBK + 16;  // shared row pitch: conflict-free fragment loads
constexpr int kThreads = 128;  // four warps

// BM rows by kBN columns on four warps, WN of them across the columns
template <int BM, int WN>
struct Tile {
  static constexpr int WM = 4 / WN;
  static constexpr int WROWS = BM / WM;
  static constexpr int WCOLS = kBN / WN;
  static constexpr int MI = WROWS / 16;  // m16 fragments a warp holds
  static constexpr int NI = WCOLS / 8;   // n8 fragments a warp holds
};

template <int BM>
struct Stages {
  int8_t a[2][BM * kPitch];
  int8_t b[2][kBN * kPitch];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ROWS rows of a row-major operand [*, kdim] from row r0, bytes [k0, k0 + kBK),
// into a stage; rows at or past r_end and bytes past kdim are zero-filled
template <int ROWS>
__device__ __forceinline__ void load_rows(int8_t* dst, const int8_t* src, int r0, int r_end,
                                          int kdim, int k0) {
#pragma unroll
  for (int i = 0; i < ROWS * 4 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, kc = (c & 3) * 16;
    const bool ok = r0 + r < r_end && k0 + kc < kdim;
    cp_async16(dst + r * kPitch + kc, ok ? src + static_cast<size_t>(r0 + r) * kdim + k0 + kc : src,
               ok);
  }
}

// one stage: A rows [row0, row0 + BM), B rows [col0, col0 + kBN), K bytes
// [k0, k0 + kBK); whatever lies past M, n_end or K is zero-filled
template <int BM, typename P>
__device__ __forceinline__ void load_stage(int8_t* as, int8_t* bs, const P& p, int row0,
                                           int col0, int n_end, int k0) {
  load_rows<BM>(as, p.a, row0, p.m, p.k, k0);
  load_rows<kBN>(bs, p.b, col0, n_end, p.k, k0);
}

// the tile's product; with BLOCKSCALE each K block's int32 sum is folded into
// facc with its row scale as the block ends, and acc restarts from 0
template <int BM, int WN, bool BLOCKSCALE, typename P>
__device__ __forceinline__ void mainloop(Stages<BM>& st, const P& p, int row0, int col0,
                                         int n_end, int (&acc)[Tile<BM, WN>::MI][Tile<BM, WN>::NI][4],
                                         float (&facc)[Tile<BM, WN>::MI][Tile<BM, WN>::NI][4]) {
  using T = Tile<BM, WN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp / WN) * T::WROWS, wcol = (warp % WN) * T::WCOLS;
  const int stages = (p.k + kBK - 1) / kBK;

  load_stage<BM>(st.a[0], st.b[0], p, row0, col0, n_end, 0);
  cp_async_commit();
  for (int kt = 0; kt < stages; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < stages) load_stage<BM>(st.a[s ^ 1], st.b[s ^ 1], p, row0, col0, n_end, (kt + 1) * kBK);
    cp_async_commit();  // an empty group on the last stage keeps the count
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      const int kg = kt * kBK + kk;
      if (kg >= p.k) break;  // K is a multiple of 32: a k-step is whole or absent
      uint32_t af[T::MI][4], bf[T::NI][2];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        const int8_t* base = st.a[s] + (wrow + mi * 16 + g) * kPitch + kk + 4 * t;
        af[mi][0] = ld32(base);
        af[mi][1] = ld32(base + 8 * kPitch);
        af[mi][2] = ld32(base + 16);
        af[mi][3] = ld32(base + 8 * kPitch + 16);
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
      if (BLOCKSCALE && (kg + 32) % p.bk == 0) {
        const float* xs = p.xs + static_cast<size_t>(kg / p.bk) * p.m;
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + wrow + mi * 16 + g + 8 * h;
            const float x = row < p.m ? xs[row] : 0.f;
#pragma unroll
            for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                int& a = acc[mi][ni][2 * h + e];
                facc[mi][ni][2 * h + e] =
                    __fadd_rn(facc[mi][ni][2 * h + e], __fmul_rn(__int2float_rn(a), x));
                a = 0;
              }
          }
      }
    }
    __syncthreads();
  }
}

}  // namespace
