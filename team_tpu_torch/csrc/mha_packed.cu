// Multi-head attention for Hopper (sm_90a), forward only, over two layouts.
//
// Replaces three TPU kernels of team_tpu/ops/mha_short.py:
//   - _mha_packed_kernel (entries fused_mha_packed and, heads split over a
//     tensor-parallel group, fused_mha_packed_tp): the packed qkv projection
//     [B, S, 3*D] as the qkv GEMM wrote it, to [B, S, D] (the head split: to
//     the rank's [B, S, D/nm]); optional causal mask and key mask;
//   - _mha_kernel (entry fused_mha_short): pre-split q, k, v [B, H, S, Dh]
//     to [B, H, S, Dh], non-causal, keys >= kv_len masked (every query row
//     is returned);
//   - _mha_kernel_v2 (entry fused_mha_short_v2): _mha_kernel with the
//     softmax normalisation deferred to the output and an optional bfloat16
//     exponential (the DEFER and BF16_EXP switches, off for the other
//     entries).
// Every entry runs over a strided [B, H, S, Dh] view: the packed layout is
// (batch, head, row) strides (S*3D, Dh, 3D) with k and v at +D and +2D, the
// head split the same with q, k and v offset by the rank's r*D/nm columns
// (its heads are read in place, no copy), the pre-split one the tensor's own
// strides. The numerics are the TPU kernels':
//   q = round_to_input_dtype(q * dh^-0.5); logits = q.k in f32;
//   f32 row-max softmax, normalised before PV;
//   p = round_to_input_dtype(p); out = p.v accumulated in f32, stored in the
//   input dtype (attend_rows in attention_common.cuh).
//
// Three kernels, by an explicit dispatch in the entries (launch and
// launch_v2_entry below):
// float32 runs on the CUDA cores (attend_rows of attention_common.cuh): one
// block per (query tile of kRows rows, head, sample) stages that head's K and
// V rows into shared memory (row stride padded so that lanes reading
// different keys hit different banks), then each warp takes every kWarps-th
// query row of the tile. team_tpu runs f32 at precision "highest", which the
// tensor cores' TF32 would not meet.
//
// bfloat16 (the towers' dtype) of #1, #2 and #3 runs both products on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32), mha_packed_kernel_tc, with the
// tile of csrc/mma_attention.cuh that the fused kernels of attn_block.cu use:
// one block of kTcWarps warps per (query tile of 16 * kTcWarps rows, head,
// sample) stages the head's K and V whole by cp.async (zero-padded to 16
// keys, 16-byte chunks XOR-swizzled, no padding) while the warps load their q
// fragments, and each warp runs WarpAttention on its 16 rows: QK^T from
// ldmatrix fragments, the logits of up to 16 * WIN keys in registers, masks
// only on the key blocks at the edges, p = round(e / l) straight from the
// accumulators into PV's A fragments (the division as e * (1 / l), but the
// IEEE quotient wherever the two could round to bf16 apart), and the rows
// stored through the output strides. No per-warp row buffer is needed, so
// shared memory is 4 * pad16(S) * dh bytes (S=197, dh=64: 53 KB) and S
// reaches 1,808 / 896 / 448 at dh 32 / 64 / 128 (the CUDA-core kernel 1,377 /
// 778 / 413). The logits window WIN is a template parameter picked from the
// keys: 8, 13 or 16 blocks; head width 128 takes 8 at every S (its 64
// accumulators and 32 q registers leave no room for more), with three passes
// past 128 keys. Only the order of the f32 sums differs from the CUDA-core
// kernel; every rounding is the same.
//
// #4's bfloat16 (the v2 switches) runs mha_v2_kernel_tc: its plain version
// rounds p = round(e) straight from exp(logit - max), so p pins each logit
// to its f32 sum in order over the head dimension (the plain version's
// matmul), which the tensor cores' sums miss (156 of 2,420,736 outputs at
// the vision shape moved by a p step: PERF.md §6). So the logits stay on the
// CUDA cores and only PV goes to the tensor cores. A block of kV2Warps warps
// per (query tile of 64 rows, head, sample) stages K and V whole as the
// tensor-core kernel does (cp.async, swizzled rows) and q as round(q *
// scale). Two warps share each 16 query rows, one on each half of the key
// blocks. Each lane computes the 8 logits of each of its 16-key blocks that
// the m16n8 accumulator layout gives it (rows g and g + 8; keys 2t, 2t + 1,
// 2t + 8, 2t + 9), each one fmaf chain over d = 0 ... dh - 1, exactly
// attend_rows' dot_row: the chains run d-chunk outer, key block inner, with 4
// dims of q for both rows in registers, and each 8-byte K load (4 dims of a
// key) feeds 8 FMAs. The two warps meet their row max through shared memory;
// p = round(e) and the row sum then go from the logits' registers into PV's A
// fragments (mma.sync, the pv_block of mma_attention.cuh), the second warp
// hands its PV and row sums to the first, and out = round(acc / l) (the IEEE
// quotient). p and l's terms are the CUDA-core kernel's bit for bit; only the
// order of the f32 sums of l and PV differs. The window WIN of key blocks a
// warp keeps in registers (4, 7 or 8; dh 128 at 4) is sized to a key half;
// past 16 * WIN keys a half its logits are computed twice (the row max, then
// exp, sum and PV in one pass: the divide comes last). Two key halves keep a
// warp's logits (56 registers at the vision shape) and PV sums within the 128
// registers that let an SM hold two blocks. Shared memory is about 4 *
// pad16(S) * dh + 128 * (dh + 8) bytes (S=197, dh=64: 62 KB), so S reaches
// 1,760 / 864 / 416 at dh 32 / 64 / 128, past the CUDA-core kernel's reach.
// That kernel (mha_packed_kernel with DEFER and BF16_EXP) keeps float32.
//
// What bounds it on an H100: about 4*S^2*dh flops per (sample, head) -- 15
// GFLOP per vision layer at B=128, S=197, H=12, dh=64 -- against 155 MB of
// q, k, v and out in bf16: the memory (0.046 ms at 3.35 TB/s) at the tensor
// cores' rate (0.015 ms at 989 TFLOP/s); the CUDA-core kernels the FMA rate;
// #4's tensor-core kernel its logits' FMAs, 4.25 G at the vision shape padded
// to 16 rows and keys (0.13 ms at 33.5 T FMA/s), with a bf16 -> f32 unpack
// beside every two.

#include "attention_common.cuh"
#include "mma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_attention;

constexpr int kRows = 64;    // query rows per block, CUDA cores
constexpr int kTcWarps = kGroupWarps;  // warps per block, tensor cores: 16 query rows each
constexpr int kTcRows = 16 * kTcWarps;

// element strides of a [B, H, S, Dh] view
struct Strides {
  long long batch, head, row;
};

template <typename T>
size_t smem_bytes(int seq, int dh) {
  return kv_bytes<T>(seq, dh) + row_buffer_bytes(seq, dh);
}

// K and V of one head, padded to 16 keys
size_t smem_bytes_tc(int seq, int dh) {
  return 2 * static_cast<size_t>(pad16(seq)) * dh * sizeof(bf16);
}

template <typename T, int DH, bool DEFER, bool BF16_EXP>
__global__ void __launch_bounds__(kThreads)
mha_packed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, Strides in, Strides os, int seq, int kv_len, int causal,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = kv_stride<T>(DH);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int row_end = min(row0 + kRows, seq);
  const long long off = b * in.batch + h * in.head;

  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + static_cast<size_t>(seq) * ks;
  float* p_all = reinterpret_cast<float*>(smem + kv_bytes<T>(seq, DH));
  float* q_all = p_all + kWarps * seq;

  // keys any row of this tile may attend
  int n_keys = min(kv_len, seq);
  if (causal) n_keys = min(n_keys, row_end);
  stage_kv(k + off, v + off, in.row, n_keys, DH, k_s, v_s, ks);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  attend_rows<T, DH, DEFER, BF16_EXP>(q + off, in.row, k_s, v_s, ks, row0 + warp, row_end, kWarps,
                                      n_keys, causal, scale, p_all + warp * seq, q_all + warp * DH,
                                      out + b * os.batch + h * os.head, os.row, 0);
}

// q rows 4-byte aligned, k and v rows 16-byte aligned (the wrappers see to it)
template <int DH, int WIN>
__global__ void __launch_bounds__(kTcWarps * 32)
mha_packed_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, Strides in, Strides os,
                     int seq, int kv_len, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const long long off = b * in.batch + h * in.head;

  // keys any row of this tile may attend
  int nk = min(kv_len, seq);
  if (causal) nk = min(nk, min(row0 + kTcRows, seq));
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + pad16(nk) * DH;
  stage_rows_tc<DH>(k + off, in.row, nk, k_s, threadIdx.x);
  stage_rows_tc<DH>(v + off, in.row, nk, v_s, threadIdx.x);
  cp_async_commit();
  // the warp's q rows are loaded while K and V land
  const int row_w = row0 + (threadIdx.x >> 5) * 16;
  WarpAttention<DH, WIN, true> att(q + off, in.row, k_s, v_s, seq, nk, row_w, causal, scale);
  cp_async_wait(0);
  __syncthreads();
  if (row_w >= seq) return;
  att.softmax();
  att.pv_store(out + b * os.batch + h * os.head, os.row, seq);
}

// ---------------------------------------------------------------------------
// #4's bfloat16: CUDA-core logits in head-dimension order, PV on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kV2Chunk = 4;        // d-values of q a lane holds for each of its two rows
constexpr int kV2Warps = 8;        // warps of a block: two on each 16-row block, one a key half
constexpr int kV2Threads = kV2Warps * 32;
constexpr int kV2Rows = 16 * kV2Warps / 2;

// row stride of the staged q, in elements: 16-byte rows, and the 8 rows that
// one load of a warp reads fall on distinct banks
__host__ __device__ constexpr int v2_q_stride(int dh) { return dh + 8; }

// row stride, in floats, of the buffer through which a key half's PV sums
// meet the other's (8-byte aligned rows; a warp's stores fill whole banks)
__host__ __device__ constexpr int v2_o_stride(int dh) { return dh + 8; }

// the bytes of K (pad16(seq) x dh bf16), or of the PV and row-sum buffer
// that later overlays it, whichever is larger
__host__ __device__ constexpr size_t v2_k_bytes(int seq, int dh) {
  return 2 * static_cast<size_t>(pad16(seq)) * dh >
                 static_cast<size_t>(kV2Rows) * (v2_o_stride(dh) + 1) * sizeof(float)
             ? 2 * static_cast<size_t>(pad16(seq)) * dh
             : static_cast<size_t>(kV2Rows) * (v2_o_stride(dh) + 1) * sizeof(float);
}

// K (or the PV buffer) and V as the tensor-core kernel stages them, the
// tile's q (kV2Rows x v2_q_stride(dh) bf16) and each warp's row max
size_t smem_bytes_v2(int seq, int dh) {
  return v2_k_bytes(seq, dh) + static_cast<size_t>(pad16(seq)) * dh * sizeof(bf16) +
         static_cast<size_t>(kV2Rows) * v2_q_stride(dh) * sizeof(bf16) + kV2Warps * 16 * sizeof(float);
}

// One warp's #4 over query rows [row_w, row_w + 16) and key blocks [kb0,
// kb0 + nbw), one half of the keys (rows past seq compute on zero queries
// and are not stored): s[j][e] holds the logit, then e = exp(logit - max),
// of key block kb0 + WIN w + j in the m16n8 accumulator layout (e = 4 *
// n-tile + the accumulator index: rows g, g, g + 8, g + 8; keys 2t, 2t + 1),
// masked keys -inf, then 0.
template <int DH, int WIN, bool BF16_EXP>
struct V2Warp {
  const bf16* k_s;  // K and V as stage_rows_tc lays them out
  const bf16* qg;   // row g of the warp's staged q; row g + 8 at qg + 8 * v2_q_stride(DH)
  const bf16* v_s;
  int nk, kb0, nbw, nwin, lane, g, t;
  float s[WIN][8];
  float m[2], l[2];        // row max and sum of rows g and g + 8
  float acc[DH / 8][4];    // round(e) . V over the warp's keys

  __device__ __forceinline__ V2Warp(const bf16* k_s_, const bf16* q_s, const bf16* v_s_,
                                    int nk_, int kb0_, int nbw_, int rb)
      : k_s(k_s_), v_s(v_s_), nk(nk_), kb0(kb0_), nbw(nbw_) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    qg = q_s + (16 * rb + g) * v2_q_stride(DH);
    nwin = (nbw + WIN - 1) / WIN;
  }

  // the logits of window w: each the fmaf chain of dot_row over d in order
  __device__ __forceinline__ void logits(int w) {
#pragma unroll
    for (int j = 0; j < WIN; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[j][e] = 0.f;
    const int jn = min(WIN, nbw - w * WIN);  // blocks of this window
#pragma unroll 1
    for (int d0 = 0; d0 < DH; d0 += kV2Chunk) {
      float qa[kV2Chunk], qb[kV2Chunk];  // rows g and g + 8
      const uint2 ra = *reinterpret_cast<const uint2*>(qg + d0);
      const uint2 rb = *reinterpret_cast<const uint2*>(qg + 8 * v2_q_stride(DH) + d0);
      const uint32_t wa[2] = {ra.x, ra.y}, wb[2] = {rb.x, rb.y};
#pragma unroll
      for (int i = 0; i < kV2Chunk / 2; ++i) {
        const float2 fa = unpack_bf16(wa[i]), fb = unpack_bf16(wb[i]);
        qa[2 * i] = fa.x;
        qa[2 * i + 1] = fa.y;
        qb[2 * i] = fb.x;
        qb[2 * i + 1] = fb.y;
      }
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (j >= jn) break;
        const int key0 = 16 * (kb0 + w * WIN + j) + 2 * t;
        uint32_t kw[4][2];  // e / 2's key (2t, 2t + 1, 2t + 8, 2t + 9): dims d0 ... d0 + 3
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint2 r = *reinterpret_cast<const uint2*>(
              k_s + swz(key0 + (n & 1) + 8 * (n >> 1), d0 / 8, DH / 8) + d0 % 8);
          kw[n][0] = r.x;
          kw[n][1] = r.y;
        }
#pragma unroll
        for (int d = 0; d < kV2Chunk; ++d) {  // in order
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const uint32_t word = kw[n][d >> 1];
            const float kv = __uint_as_float(d & 1 ? word & 0xffff0000u : word << 16);
            const int e = 4 * (n >> 1) + (n & 1);
            s[j][e] = fmaf(qa[d], kv, s[j][e]);
            s[j][e + 2] = fmaf(qb[d], kv, s[j][e + 2]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < WIN; ++j) {
      const int kb = kb0 + w * WIN + j;
      if (j >= jn || (kb + 1) * 16 <= nk) continue;  // only the block across nk is masked
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (kb * 16 + (e >> 2) * 8 + 2 * t + (e & 1) >= nk) s[j][e] = -CUDART_INF_F;
    }
  }

  // the f32 max of rows g and g + 8 over the warp's keys, met across the
  // quad that shares the rows
  __device__ __forceinline__ void row_max() {
    m[0] = m[1] = -CUDART_INF_F;
    for (int w = 0; w < nwin; ++w) {
      logits(w);
      const int jn = min(WIN, nbw - w * WIN);
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (j >= jn) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], s[j][e]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
      m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
    }
  }

  // with m the row max over every key: e = exp(logit - max) (its argument
  // rounded to bf16 with BF16_EXP), l = the f32 sum of e over the warp's keys
  // (met across the quad), acc = round(e) . V on the tensor cores
  __device__ __forceinline__ void exp_pv() {
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
    l[0] = l[1] = 0.f;
    for (int w = 0; w < nwin; ++w) {
      if (nwin > 1) logits(w);  // one window: its logits are still in registers
      const int jn = min(WIN, nbw - w * WIN);
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (j >= jn) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = s[j][e] - m[(e >> 1) & 1];
          s[j][e] = expf(BF16_EXP ? round_to<bf16>(x) : x);
          l[(e >> 1) & 1] += s[j][e];
        }
        const uint32_t a[1][4] = {{pack_bf16(s[j][0], s[j][1]), pack_bf16(s[j][2], s[j][3]),
                                   pack_bf16(s[j][4], s[j][5]), pack_bf16(s[j][6], s[j][7])}};
        pv_block<DH>(acc, a, v_s, kb0 + w * WIN + j, lane);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
  }
};

// q, k and v rows 16-byte aligned (the wrappers see to it). Warps 2 rb and 2
// rb + 1 take rows [row0 + 16 rb, + 16) over the first and the second half
// of the key blocks; they meet the row max, then the second hands its PV sum
// and row sum to the first, which adds them to its own, divides and stores.
// blocks of mha_v2_kernel_tc an SM holds: two (128 registers a thread) where
// ptxas fits the kernel in them with no spill (head width 64 at up to 7 key
// blocks a half: the vision shape), else one
__host__ __device__ constexpr int v2_min_blocks(int dh, int win) {
  return dh == 64 && win <= 7 ? 2 : 1;
}

template <int DH, int WIN, bool BF16_EXP>
__global__ void __launch_bounds__(kV2Threads, v2_min_blocks(DH, WIN))
mha_v2_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, Strides in, Strides os,
                 int seq, int kv_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQs = v2_q_stride(DH);
  constexpr int kOs = v2_o_stride(DH);
  constexpr int kQPieces = kV2Rows * DH / 8 / kV2Threads;  // 16-byte pieces of q a thread
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kV2Rows;
  const long long off = b * in.batch + h * in.head;

  const int nk = min(kv_len, seq);
  const int kp = pad16(nk);
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = reinterpret_cast<bf16*>(smem + v2_k_bytes(nk, DH));
  bf16* q_s = v_s + static_cast<size_t>(kp) * DH;
  float* m_s = reinterpret_cast<float*>(q_s + kV2Rows * kQs);  // [warp][16 rows]
  float* o_s = reinterpret_cast<float*>(smem);  // [kV2Rows][kOs]: PV sums, overlaying K
  float* l_s = o_s + kV2Rows * kOs;              // [kV2Rows]: row sums
  // K and V as stage_rows_tc lays them out, by every thread of the block
  for (int c = threadIdx.x; c < kp * (DH / 8); c += kV2Threads) {
    const int r = c / (DH / 8), ch = c - r * (DH / 8);
    const bool ok = r < nk;
    const long long src = off + (ok ? r * in.row + ch * 8 : 0);
    cp_async16(k_s + swz(r, ch, DH / 8), k + src, ok);
    cp_async16(v_s + swz(r, ch, DH / 8), v + src, ok);
  }
  cp_async_commit();
  // q while K and V land: q = round(q * scale), zeros past seq, every load first
  uint4 raw[kQPieces];
#pragma unroll
  for (int i = 0; i < kQPieces; ++i) {
    const int c = threadIdx.x + i * kV2Threads;
    const int row = row0 + c / (DH / 8);
    raw[i] = row < seq
        ? *reinterpret_cast<const uint4*>(q + off + row * in.row + (c % (DH / 8)) * 8)
        : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < kQPieces; ++i) {
    const int c = threadIdx.x + i * kV2Threads;
    uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 f = unpack_bf16(w[p]);
      w[p] = pack_bf16(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(q_s + (c / (DH / 8)) * kQs + (c % (DH / 8)) * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  cp_async_wait(0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, rb = warp >> 1, half = warp & 1;
  const int row_w = row0 + 16 * rb;
  const bool active = row_w < seq;  // every warp meets the barriers below
  const int nb = kp >> 4, nb0 = (nb + 1) >> 1;
  V2Warp<DH, WIN, BF16_EXP> att(k_s, q_s, v_s, nk, half ? nb0 : 0, half ? nb - nb0 : nb0, rb);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (active) {
    att.row_max();
    if (t == 0) {
      m_s[warp * 16 + g] = att.m[0];
      m_s[warp * 16 + g + 8] = att.m[1];
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) att.m[hr] = fmaxf(att.m[hr], m_s[(warp ^ 1) * 16 + g + 8 * hr]);
    att.exp_pv();
  }
  __syncthreads();  // K is read no more: o_s overlays it
  const int r_g = 16 * rb + g;  // row g of the warp in the block; g + 8 at r_g + 8
  if (active && half) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* o = o_s + (r_g + 8 * hr) * kOs;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
        *reinterpret_cast<float2*>(o + nd * 8 + 2 * t) =
            make_float2(att.acc[nd][2 * hr], att.acc[nd][2 * hr + 1]);
      if (t == 0) l_s[r_g + 8 * hr] = att.l[hr];
    }
  }
  __syncthreads();
  if (!active || half) return;
  bf16* dst_base = out + b * os.batch + h * os.head;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_w + g + 8 * hr;
    if (row >= seq) continue;
    const float* o = o_s + (r_g + 8 * hr) * kOs;
    const float l = att.l[hr] + l_s[r_g + 8 * hr];
    bf16* dst = dst_base + static_cast<long long>(row) * os.row + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const float2 other = *reinterpret_cast<const float2*>(o + nd * 8 + 2 * t);
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          pack_bf16(__fdiv_rn(att.acc[nd][2 * hr] + other.x, l),
                    __fdiv_rn(att.acc[nd][2 * hr + 1] + other.y, l));
    }
  }
}

template <typename T, int DH, bool DEFER, bool BF16_EXP>
cudaError_t launch_cuda_core(const void* q, const void* k, const void* v, void* out, Strides in,
                             Strides os, int batch, int seq, int heads, int kv_len, int causal,
                             float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(seq, DH);
  cudaError_t err = cudaFuncSetAttribute(mha_packed_kernel<T, DH, DEFER, BF16_EXP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  mha_packed_kernel<T, DH, DEFER, BF16_EXP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), in, os, seq, kv_len, causal, scale);
  return cudaGetLastError();
}

template <int DH, int WIN>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, Strides in,
                      Strides os, int batch, int seq, int heads, int kv_len, int causal,
                      float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_tc(seq, DH);
  cudaError_t err = cudaFuncSetAttribute(mha_packed_kernel_tc<DH, WIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTcRows - 1) / kTcRows, heads, batch);
  mha_packed_kernel_tc<DH, WIN><<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), in, os, seq, kv_len, causal, scale);
  return cudaGetLastError();
}

template <int DH, int WIN, bool BF16_EXP>
cudaError_t launch_v2(const void* q, const void* k, const void* v, void* out, Strides in,
                      Strides os, int batch, int seq, int heads, int kv_len, float scale,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes_v2(seq, DH);
  cudaError_t err = cudaFuncSetAttribute(mha_v2_kernel_tc<DH, WIN, BF16_EXP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kV2Rows - 1) / kV2Rows, heads, batch);
  mha_v2_kernel_tc<DH, WIN, BF16_EXP><<<grid, kV2Threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), in, os, seq, kv_len, scale);
  return cudaGetLastError();
}

// #4's tensor-core kernel with the logits window sized to a key half: 4, 7
// or 8 blocks of 16 keys (the vision shape's 13 blocks are halves of 7 and
// 6); head width 128 takes 4 at every S (its 64 PV accumulators leave no
// room for more), with two passes past 128 keys
template <bool BF16_EXP>
cudaError_t launch_v2_dh(int dh, const void* q, const void* k, const void* v, void* out,
                         Strides in, Strides os, int batch, int seq, int heads, int kv_len,
                         float scale, cudaStream_t s) {
  const int half = (((kv_len < seq ? kv_len : seq) + 15) / 16 + 1) / 2;  // blocks of a key half
#define TEAM_V2(DH, WIN) \
  launch_v2<DH, WIN, BF16_EXP>(q, k, v, out, in, os, batch, seq, heads, kv_len, scale, s)
  switch (dh) {
    case 32: return half <= 4 ? TEAM_V2(32, 4) : half <= 7 ? TEAM_V2(32, 7) : TEAM_V2(32, 8);
    case 64: return half <= 4 ? TEAM_V2(64, 4) : half <= 7 ? TEAM_V2(64, 7) : TEAM_V2(64, 8);
    case 128: return TEAM_V2(128, 4);
    default: return cudaErrorInvalidValue;
  }
#undef TEAM_V2
}

// the tensor-core kernel with the logits window sized to the keys (8, 13 or
// 16 blocks of 16; head width 128 at 8)
template <typename... A>
cudaError_t launch_tc_dh(int dh, int seq, int kv_len, A... args) {
  const int nb = ((kv_len < seq ? kv_len : seq) + 15) / 16;
  switch (dh) {
    case 32:
      return nb <= 8 ? launch_tc<32, 8>(args...)
             : nb <= 13 ? launch_tc<32, 13>(args...) : launch_tc<32, 16>(args...);
    case 64:
      return nb <= 8 ? launch_tc<64, 8>(args...)
             : nb <= 13 ? launch_tc<64, 13>(args...) : launch_tc<64, 16>(args...);
    case 128: return launch_tc<128, 8>(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool DEFER, bool BF16_EXP, typename... A>
cudaError_t launch_cuda_core_dh(int dh, A... args) {
  switch (dh) {
    case 32: return launch_cuda_core<T, 32, DEFER, BF16_EXP>(args...);
    case 64: return launch_cuda_core<T, 64, DEFER, BF16_EXP>(args...);
    case 128: return launch_cuda_core<T, 128, DEFER, BF16_EXP>(args...);
    default: return cudaErrorInvalidValue;
  }
}

// the launch of #1, #2 and #3, over strided q, k, v and out of a [B, H, S,
// Dh] view: dtype 0 (float32) takes the CUDA-core kernel, 1 (bfloat16) the
// tensor-core one
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out, Strides in,
                   Strides os, int batch, int seq, int heads, int dh, int kv_len, int causal,
                   float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cuda_core_dh<float, false, false>(dh, q, k, v, out, in, os, batch, seq, heads,
                                                    kv_len, causal, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  return launch_tc_dh(dh, seq, kv_len, q, k, v, out, in, os, batch, seq, heads, kv_len, causal,
                      scale, s);
}

// #4's launch (non-causal, the v2 switches): bfloat16 takes
// mha_v2_kernel_tc; float32 (team_tpu runs it at precision "highest", which
// the tensor cores' TF32 would not meet) the CUDA-core kernel
template <bool BF16_EXP>
cudaError_t launch_v2_entry(int dtype, const void* q, const void* k, const void* v, void* out,
                            Strides in, Strides os, int batch, int seq, int heads, int dh,
                            int kv_len, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cuda_core_dh<float, true, BF16_EXP>(dh, q, k, v, out, in, os, batch, seq, heads,
                                                      kv_len, 0, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  return launch_v2_dh<BF16_EXP>(dh, q, k, v, out, in, os, batch, seq, heads, kv_len, scale, s);
}

size_t element_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the codes of team_tpu_torch/ops/mha_short.py);
// v2: 0 for the entries of #1, #2 and #3, 1 for team_mha_short_v2_fwd. The
// bytes of the kernel the entry takes.
extern "C" size_t team_mha_packed_smem_bytes(int dtype, int seq, int dh, int v2) {
  if (dtype == 0) return smem_bytes<float>(seq, dh);
  return v2 ? smem_bytes_v2(seq, dh) : smem_bytes_tc(seq, dh);
}

// Packed [B, S, 3*D] -> [B, S, D]. Returns the cudaError_t of the launch (0 on success).
extern "C" int team_mha_packed_fwd(const void* qkv, void* out, int dtype, int batch, int seq,
                                   int heads, int dh, int kv_len, int causal, float scale,
                                   void* stream) {
  const long long d_model = static_cast<long long>(heads) * dh;
  const char* base = static_cast<const char*>(qkv);
  const size_t e = element_bytes(dtype);
  return launch(dtype, base, base + d_model * e, base + 2 * d_model * e, out,
                {seq * 3 * d_model, dh, 3 * d_model}, {seq * d_model, dh, d_model}, batch, seq,
                heads, dh, kv_len, causal, scale, stream);
}

// Pre-split q, k, v [B, H, S, Dh], each with the element strides (sb, sh, sr)
// and a unit stride along Dh, -> out [B, H, S, Dh] contiguous; non-causal.
extern "C" int team_mha_short_fwd(const void* q, const void* k, const void* v, void* out,
                                  int dtype, int batch, int heads, int seq, int dh, long long sb,
                                  long long sh, long long sr, int kv_len, float scale,
                                  void* stream) {
  return launch(dtype, q, k, v, out, {sb, sh, sr},
                {static_cast<long long>(heads) * seq * dh, static_cast<long long>(seq) * dh, dh},
                batch, seq, heads, dh, kv_len, 0, scale, stream);
}

// _mha_kernel_v2 (entry fused_mha_short_v2): team_mha_short_fwd's inputs and
// output, with the softmax normalisation deferred to the [S, Dh] output and,
// with bf16_exp = 1, the exponential taken in bfloat16. The TPU kernel's
// q_pad only aligns its query rows: padded rows are sliced off and padded
// keys masked, so it changes nothing here and is not passed.
extern "C" int team_mha_short_v2_fwd(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int batch, int heads, int seq, int dh,
                                     long long sb, long long sh, long long sr, int kv_len,
                                     float scale, int bf16_exp, void* stream) {
  const Strides os = {static_cast<long long>(heads) * seq * dh, static_cast<long long>(seq) * dh, dh};
  if (bf16_exp)
    return launch_v2_entry<true>(dtype, q, k, v, out, {sb, sh, sr}, os, batch, seq, heads, dh,
                                 kv_len, scale, stream);
  return launch_v2_entry<false>(dtype, q, k, v, out, {sb, sh, sr}, os, batch, seq, heads, dh,
                                kv_len, scale, stream);
}

// The packed layout's heads split over nm tensor-parallel ranks: rank r of nm
// reads heads [r*H/nm, (r+1)*H/nm) of the full packed qkv [B, S, 3*D] in place
// (q, k and v offset by r*D/nm columns, row stride 3D) and writes its slice
// out [B, S, D/nm]. heads_local = H/nm. Each head's arithmetic is the packed
// entry's, so the ranks' outputs side by side are that entry's bit for bit.
extern "C" int team_mha_packed_tp_fwd(const void* qkv, void* out, int dtype, int batch, int seq,
                                      int heads_local, int dh, int rank, int nm, int kv_len,
                                      int causal, float scale, void* stream) {
  if (nm < 1 || rank < 0 || rank >= nm) return cudaErrorInvalidValue;
  const long long d_local = static_cast<long long>(heads_local) * dh;
  const long long d_model = d_local * nm;
  const size_t e = element_bytes(dtype);
  const char* base = static_cast<const char*>(qkv) + rank * d_local * e;
  return launch(dtype, base, base + d_model * e, base + 2 * d_model * e, out,
                {seq * 3 * d_model, dh, 3 * d_model}, {seq * d_local, dh, d_local}, batch, seq,
                heads_local, dh, kv_len, causal, scale, stream);
}
