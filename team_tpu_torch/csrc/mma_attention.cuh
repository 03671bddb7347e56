// The bf16 attention tile on Hopper's tensor cores (sm_90a), shared by the
// attention sources of this directory: attn_block.cu (#12, #13), mha_packed.cu
// (#1, #2, #3), flash_attention.cu (#14), mha_packed_q.cu (#5, #6) and, for
// its PV, mha_packed_q3i.cu (#7, #10, #11, #29).
//   - swz: the XOR swizzle of 16-byte chunks that keeps ldmatrix free of bank
//     conflicts without padding (rows of an odd number of chunks, as at head
//     width 72, need none);
//   - stage_rows_tc: one head's K or V rows into shared memory by cp.async;
//   - qk_block / pv_block: the QK^T and PV products of one 16-key block of
//     K/V in shared memory, through ldmatrix and mma.sync m16n8k16 bf16; a
//     head width of 16 k + 8 (72) ends in a k-step whose upper half is zero
//     and a single n8 tile;
//   - WarpAttention: one warp's attention over 16 query rows against a
//     head's whole K and V, with the TPU packed kernels' roundings
//     (q = round(q * dh^-0.5), f32 logits, f32 row max and sum, p = round(e / l)
//     before PV, f32 accumulation).
// Nothing here allocates or launches. attention_common.cuh and attn_block.cu
// both define kThreads, so these pieces live in a namespace of their own.

#pragma once

#include <math_constants.h>

#include "mma_frag.cuh"

namespace mma_attention {

using bf16 = __nv_bfloat16;
using namespace mma_frag;

constexpr int kGroupWarps = 4;   // warps of one attention group (one named barrier)
constexpr int kWinBlocks = 16;   // 16-key blocks of logits a thread keeps in registers

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// element offset of 8-element chunk c of row r in a [rows, 8 * cpr] bf16 tile
// with no padding: the chunks are XOR-swizzled so that the 8 rows one
// ldmatrix phase reads fall on distinct banks (cpr a multiple of 8, or 4);
// an odd cpr puts 8 consecutive rows on distinct banks as they stand
__device__ __forceinline__ int swz(int r, int c, int cpr) {
  if (cpr & 1) return (r * cpr + c) * 8;
  return (r * cpr + ((cpr & 7) == 0 ? c ^ (r & 7) : c ^ ((r >> 1) & 3))) * 8;
}

// barrier of one group of 4 warps (ids 1 and 2; __syncthreads is 0)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kGroupWarps * 32) : "memory");
}

// rows [0, nk) of one head's K or V (row stride ld) into dst, [pad16(nk), DH]
// swizzled, zero past nk (0 * NaN is NaN); one group of warps takes part,
// tid the thread's index in it
template <int DH>
__device__ __forceinline__ void stage_rows_tc(const bf16* src, long long ld, int nk, bf16* dst,
                                              int tid) {
  constexpr int kCpr = DH / 8;
  const int n = pad16(nk) * kCpr;
  for (int c = tid; c < n; c += kGroupWarps * 32) {
    const int r = c / kCpr, ch = c - r * kCpr;
    const bool ok = r < nk;
    cp_async16(dst + swz(r, ch, kCpr), src + (ok ? r * ld + ch * 8 : 0), ok);
  }
}

// c[n] += q . k over key block kb (keys 16 kb + 8 n + 0..7) of K staged by
// stage_rows_tc; qf: the 16 query rows as A fragments, one a 16-wide k-step,
// the last one's columns past DH zero (DH = 16 k + 8: a k-step of 8)
template <int DH>
__device__ __forceinline__ void qk_block(float (&c)[2][4],
                                         const uint32_t (&qf)[(DH + 15) / 16][4],
                                         const bf16* k_s, int kb, int lane) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t r[4];
    ldsm_x4(r, k_s + swz(kb * 16 + (lane >> 4) * 8 + (lane & 7), 2 * ks + ((lane >> 3) & 1),
                         DH / 8));
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    mma_bf16(c[0], qf[ks], b0);
    mma_bf16(c[1], qf[ks], b1);
  }
  if constexpr (DH % 16 == 8) {
    // the last 8 columns of keys 0..7 and 8..15: the B fragments' upper k
    // half is zero, as is the A fragments'
    uint32_t r[2];
    ldsm_x2(r, k_s + swz(kb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), DH / 8 - 1, DH / 8));
    const uint32_t b0[2] = {r[0], 0u}, b1[2] = {r[1], 0u};
    mma_bf16(c[0], qf[DH / 16], b0);
    mma_bf16(c[1], qf[DH / 16], b1);
  }
}

// acc[nd] += a[i] . V over key block kb of V staged by stage_rows_tc, for each
// of the NA A fragments a[i] (the block's p, 16 rows by 16 keys); V's B
// fragments come from ldmatrix.trans once for all NA
template <int DH, int NA = 1>
__device__ __forceinline__ void pv_block(float (&acc)[DH / 8][4], const uint32_t (&a)[NA][4],
                                         const bf16* v_s, int kb, int lane) {
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t r[4];
    ldsm_x4_trans(r, v_s + swz(kb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), 2 * np + (lane >> 4),
                               DH / 8));
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      mma_bf16(acc[2 * np], a[i], b0);
      mma_bf16(acc[2 * np + 1], a[i], b1);
    }
  }
  if constexpr (DH % 16 == 8) {
    // the last n8 tile: the 16 keys of its 8 columns
    uint32_t r[2];
    ldsm_x2_trans(r, v_s + swz(kb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), DH / 8 - 1, DH / 8));
#pragma unroll
    for (int i = 0; i < NA; ++i) mma_bf16(acc[DH / 8 - 1], a[i], r);
  }
}

// One warp's attention over query rows [row_w, row_w + 16) of one head:
// softmax() (QK^T, the row max and sum), then pv() or pv_store(). Rows at or
// past seq compute on zero queries and are never stored by pv_store. q row i
// at q + i * ld (4-byte aligned); K and V staged by stage_rows_tc (nk keys).
// A thread keeps the logits of WIN 16-key blocks in registers, so the max,
// the sum and p come from one QK^T; past 16 * WIN keys the logits are
// recomputed per window in three passes (max, sum, p and PV), and the fixed
// mma order gives the same logits each time. EDGE_MASK (off by default)
// masks only the key blocks that need it: those past the warp's keys or
// across its causal diagonal (a warp-uniform test per block).
template <int DH, int WIN = kWinBlocks, bool EDGE_MASK = false>
struct WarpAttention {
  static constexpr int KS = DH / 16;  // mma k-steps of q.k; n-tile pairs of PV
  static constexpr int kCpr = DH / 8;

  const bf16* k_s;
  const bf16* v_s;
  int row_w, causal, g, t, lane, nkw, nb, nwin;
  uint32_t qf[KS][4];  // q = round(q * scale), as A fragments
  // logits of a window, then exp(logit - max): s[j][e] for key block WIN w + j;
  // e = 4 * n-tile + the accumulator index (rows g, g, g + 8, g + 8; keys 2t,
  // 2t + 1); masked keys -inf, then 0
  float s[WIN][8];
  float m[2], l[2];  // row max and sum of rows g and g + 8

  __device__ __forceinline__ WarpAttention(const bf16* q, long long ld, const bf16* k_s_,
                                           const bf16* v_s_, int seq, int nk, int row_w_,
                                           int causal_, float scale)
      : k_s(k_s_), v_s(v_s_), row_w(row_w_), causal(causal_) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row_w + g + 8 * hr;
      const bf16* qr = q + static_cast<long long>(row < seq ? row : 0) * ld;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const uint32_t raw =
              row < seq ? *reinterpret_cast<const uint32_t*>(qr + ks * 16 + hc * 8 + 2 * t) : 0u;
          const float2 f = unpack_bf16(raw);
          qf[ks][hr + 2 * hc] = pack_bf16(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
        }
    }
    nkw = causal ? min(nk, row_w + 16) : nk;  // keys any row of the warp sees
    nb = (nkw + 15) >> 4;
    nwin = (nb + WIN - 1) / WIN;
  }

  // the same with q's A fragments built by the caller (the int8-I/O kernels
  // of mha_packed_q.cu dequantize q with their own roundings)
  __device__ __forceinline__ WarpAttention(const uint32_t (&qf_)[KS][4], const bf16* k_s_,
                                           const bf16* v_s_, int nk, int row_w_, int causal_)
      : k_s(k_s_), v_s(v_s_), row_w(row_w_), causal(causal_) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[ks][i] = qf_[ks][i];
    nkw = causal ? min(nk, row_w + 16) : nk;
    nb = (nkw + 15) >> 4;
    nwin = (nb + WIN - 1) / WIN;
  }

  __device__ __forceinline__ void logits(int w) {
#pragma unroll
    for (int j = 0; j < WIN; ++j) {
      const int kb = w * WIN + j;
      if (kb >= nb) continue;
      float c[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t r[4];
        ldsm_x4(r, k_s + swz(kb * 16 + (lane >> 4) * 8 + (lane & 7), 2 * ks + ((lane >> 3) & 1),
                             kCpr));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(c[0], qf[ks], b0);
        mma_bf16(c[1], qf[ks], b1);
      }
      if (EDGE_MASK && (kb + 1) * 16 <= nkw && !(causal && (kb + 1) * 16 > row_w + 1)) {
#pragma unroll
        for (int e = 0; e < 8; ++e) s[j][e] = c[e >> 2][e & 3];
        continue;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = kb * 16 + (e >> 2) * 8 + 2 * t + (e & 1);
        const int row = row_w + g + ((e >> 1) & 1) * 8;
        const bool keep = key < nkw && (!causal || key <= row);
        s[j][e] = keep ? c[e >> 2][e & 3] : -CUDART_INF_F;
      }
    }
  }

  // exp(logit - max) in place of window w's logits, added to sum
  __device__ __forceinline__ void exps(int w, float (&sum)[2]) {
#pragma unroll
    for (int j = 0; j < WIN; ++j) {
      if (w * WIN + j >= nb) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[j][e] = expf(s[j][e] - m[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += s[j][e];
      }
    }
  }

  // f32 row max and row sum over the quad that shares a row; with one
  // window, its exponentials stay in s for pv()
  __device__ __forceinline__ void softmax() {
    m[0] = m[1] = -CUDART_INF_F;
    for (int w = 0; w < nwin; ++w) {
      logits(w);
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (w * WIN + j >= nb) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], s[j][e]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
      m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
    }
    l[0] = l[1] = 0.f;
    for (int w = 0; w < nwin; ++w) {
      if (nwin > 1) logits(w);  // one window: its logits are still in registers
      exps(w, l);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
  }

  // PV: p = round(e / l) packed from the accumulator layout into A
  // fragments; round(out) of row row_w + r goes to o + r * lda (shared
  // memory: every row of the warp is written)
  __device__ __forceinline__ void pv(bf16* o, int lda) {
    float acc[DH / 8][4] = {};
    for (int w = 0; w < nwin; ++w) {
      if (nwin > 1) {
        float unused[2] = {0.f, 0.f};
        logits(w);
        exps(w, unused);
      }
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        const int kb = w * WIN + j;
        if (kb >= nb) continue;
        const uint32_t a[4] = {
            pack_bf16(__fdiv_rn(s[j][0], l[0]), __fdiv_rn(s[j][1], l[0])),
            pack_bf16(__fdiv_rn(s[j][2], l[1]), __fdiv_rn(s[j][3], l[1])),
            pack_bf16(__fdiv_rn(s[j][4], l[0]), __fdiv_rn(s[j][5], l[0])),
            pack_bf16(__fdiv_rn(s[j][6], l[1]), __fdiv_rn(s[j][7], l[1]))};
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, v_s + swz(kb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                     2 * np + (lane >> 4), kCpr));
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(acc[2 * np], a, b0);
          mma_bf16(acc[2 * np + 1], a, b1);
        }
      }
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(o + g * lda + nd * 8 + 2 * t) = pack_bf16(acc[nd][0], acc[nd][1]);
      *reinterpret_cast<uint32_t*>(o + (g + 8) * lda + nd * 8 + 2 * t) =
          pack_bf16(acc[nd][2], acc[nd][3]);
    }
  }

  // pv(), with round(out) of each row i < seq of the warp stored to o + i * ld
  // (device memory). p = round(e / l) is rounded as the IEEE quotient from
  // q = e * (1 / l), which lies within 2 f32 ulps of it: both round to one
  // bf16 unless q lies within a few ulps of a bf16 halfway point (or is tiny),
  // and a key block that holds such a q takes the division itself
  __device__ __forceinline__ void pv_store(bf16* o, long long ld, int seq) {
    pv_sum([&](const float (&acc)[DH / 8][4]) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row_w + g + 8 * hr;
        if (row >= seq) continue;
        bf16* dst = o + static_cast<long long>(row) * ld + 2 * t;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd)
          *reinterpret_cast<uint32_t*>(dst + nd * 8) =
              pack_bf16(acc[nd][2 * hr], acc[nd][2 * hr + 1]);
      }
    });
  }

  // pv()'s PV sums, with p rounded as pv_store() states, handed to epi(acc)
  // (the accumulator layout: rows g and g + 8, columns 8 nd + 2t and 8 nd +
  // 2t + 1): pv_store's store, or a caller's own epilogue. The sums stay a
  // local array of this function (passing one in moved the registers of
  // #1-#3's SASS)
  template <class Epilogue>
  __device__ __forceinline__ void pv_sum(Epilogue&& epi) {
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    float acc[DH / 8][4] = {};
    for (int w = 0; w < nwin; ++w) {
      if (nwin > 1) {
        float unused[2] = {0.f, 0.f};
        logits(w);
        exps(w, unused);
      }
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        const int kb = w * WIN + j;
        if (kb >= nb) continue;
        float p[8];
        bool exact = false;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = s[j][e] * rl[(e >> 1) & 1];
          const uint32_t low = __float_as_uint(p[e]) & 0xffffu;
          exact |= (p[e] < 1e-30f && s[j][e] != 0.f) || low - 0x7ff9u < 15u;
        }
        if (exact) {
#pragma unroll
          for (int e = 0; e < 8; ++e) p[e] = __fdiv_rn(s[j][e], l[(e >> 1) & 1]);
        }
        const uint32_t a[1][4] = {{pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                                   pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])}};
        pv_block<DH>(acc, a, v_s, kb, lane);
      }
    }
    epi(acc);
  }
};

}  // namespace mma_attention
