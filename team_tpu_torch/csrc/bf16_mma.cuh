// The bf16 tensor-core mainloop beside csrc/int8_mma.cuh's s8 one, for Hopper
// (sm_90a): mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//
// An m16n8k16 bf16 fragment holds, in bytes, what an m16n8k32 s8 fragment
// holds: A's four 32-bit registers are rows g and g + 8 at bytes 4t and
// 16 + 4t of a 32-byte k-step, B's two are row g of the [N, K] operand at the
// same bytes, and the accumulator's four are rows g and g + 8, columns 2t and
// 2t + 1. So this mainloop stages and reads exactly as the s8 one does, with
// K counted in bytes (two per element): a 64-byte stage is 32 bf16 columns,
// two mma k-steps. Only the instruction and the f32 accumulator differ.

#pragma once

#include "int8_mma.cuh"
#include "mma_frag.cuh"

namespace {

using mma_frag::mma_bf16;

// the tile's product in f32: p.a, p.b are the bf16 operands as bytes and p.k
// is K in bytes (a multiple of 32, one k-step)
template <int BM, int WN, typename P>
__device__ __forceinline__ void mainloop_bf16(Stages<BM>& st, const P& p, int row0, int col0,
                                              int n_end,
                                              float (&acc)[Tile<BM, WN>::MI][Tile<BM, WN>::NI][4]) {
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
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      if (kt * kBK + kk >= p.k) break;
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
        for (int ni = 0; ni < T::NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
}

}  // namespace
