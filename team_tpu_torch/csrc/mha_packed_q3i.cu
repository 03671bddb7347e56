// Integer-QK^T attention of the int8 static-W8A8 tier, for Hopper (sm_90a),
// forward only.
//
// Replaces four TPU kernels of team_tpu/ops/mha_short.py:
//   _mha_packed_q3i_kernel           (entry fused_mha_packed_q3i)           -> team_mha_packed_q3i_fwd
//                                    (entry fused_mha_packed_q3i_tp)        -> team_mha_packed_q3i_tp_fwd
//   _mha_packed_q3i_cls_kernel       (entry fused_mha_packed_q3i_cls)       -> team_mha_packed_q3i_cls_fwd
//   _mha_packed_q3i_cls_split_kernel (entry fused_mha_packed_q3i_cls_split) -> team_mha_packed_q3i_cls_split_fwd
//   _mha_packed_q3i_sb_kernel        (entry fused_mha_packed_q3i_sb)        -> team_mha_packed_q3i_sb_fwd
// and the decomposition probe's variants of the first (scripts/r4_attn_decomp.py:
// _variant_kernel, entry fused_mha_q3i_variant -> team_mha_q3i_variant_fwd):
// the template switch VAR cuts the static kMxu path short (no exp2; q.k
// alone; the softmax without PV), and a copy kernel gives the floor of
// reading q and writing the output. VAR's default is every other entry's
// kernel, unchanged.
// All four read int8 q, k and v as the qkv GEMM's requantize wrote them (q and
// k with one scale per head, v per channel) and write int8. Both kernels below
// read q, k and v and write out through explicit row and sample strides, so
// the packed [B, S, 3*D] layout, the sequence-major [S, B, 3*D] layout and
// the split q [B, 1, D] + kv [B, S, 2*D] inputs differ only in the pointers
// and strides each entry passes. So does the tensor-parallel head
// split: rank r of nm reads heads [r*H/nm, (r+1)*H/nm) of the full packed
// tensor in place, and its per-head and per-channel scales through pointers
// offset to its heads (the kernel reads only v's segment of deq: q's and k's
// scales are folded into qk_scale).
//
// The math is the TPU kernel's (mha_short.py:493-592):
//   acc = q8 . k8 as an exact int32 sum;
//   softmax, chosen by the wrapper:
//     static (qk_m2 given; only when nothing is masked):
//       p = exp2(float(acc) * (qks[h] * log2e) - m2[h]);
//     exp2i (template switch EXP2I; only when nothing is masked):
//       p = exp2(float(acc - max acc) * (qks[h] * log2e));
//     row-max: logits = float(acc) * qks[h], causal and kv_len masks,
//       p = exp(logits - rowmax);
//   then one of five normalisations (template switch NORM):
//     kMxu (the default; the TPU's rowsum "mxu"): p is rounded to bf16;
//       num = sum_j p_j * v8[j] and den = sum_j p_j in f32 (the ones-column of
//       the TPU kernel's PV dot); out = num * (deq_v * o_inv) / den;
//     kReduce (rowsum "reduce", and the sequence-major kernel): den = sum of
//       the unrounded f32 p; p /= den; num = sum_j bf16(p_j) * v8[j] in f32;
//       out = num * (deq_v * o_inv);
//     kReduceDefer (defer_norm): as kReduce without p /= den, then out /= den;
//     kPv8 (pv_int8): den and p /= den as kReduce, then p8 = clip(rint(p *
//       127), 0, 127) and num = sum_j p8_j * v8[j] as an exact int32 sum;
//       out = float(num) * ((deq_v * o_inv) * f32(1/127));
//     kPv8Defer: as kPv8 without p /= den, then out /= den;
//   out is rounded with rint and clipped to +-127.
// Every product and difference the TPU kernel rounds separately is rounded
// separately here too (__fmul_rn, __fsub_rn, __fdiv_rn): nvcc would contract
// a*b - c into one FMA, which rounds once. Rounding is rint (half to even, as
// jnp.round), never roundf. Masked keys are skipped rather than set to -1e30
// (left out of the max, p = 0): exp(-1e30 - max) is 0 in f32, so the sums are
// the same while every row keeps a key (the wrapper checks kv_len >= 1).
// |acc| <= dh * 127^2 and the int8 PV sum <= S * 127^2 stay below 2^24, so
// both are exact as floats.
//
// Two kernels: the tensor cores take every entry with more than one query row.
//
// q3i_kernel_tc, the packed, head-split, sequence-major and variant entries:
// one block per (head, sample) of W warps (W = ceil(T / ceil(T / 5)) over the
// T = ceil(S / 16) tiles of 16 query rows: 5 at S=197 and at S=77), so the
// head's K and V are staged once: K as int8 by 16-byte cp.async (S=197,
// dh=64: 13 KB), V as bf16 by register loads (int8 -> bf16 is exact; 26 KB),
// both zero past the keys and swizzled in 16-byte chunks so that ldmatrix is
// free of bank conflicts. Each warp takes every W-th row tile: its q rows are
// the s8 A fragments of mma.sync.m16n8k32 (read straight from device memory),
// and one ldmatrix.x4 of K gives the B fragments of a 16-key block for one
// 32-byte k-step, so q.k is an exact int32 sum on the tensor cores, equal to
// the dp4a sum bit for bit, and so are the logits, the row max and every p.
// QK^T is recomputed rather than stored: each pass over the key blocks gives
// the same logits. The static kMxu route (the default) is one pass: per
// 16-key block QK^T, p = bf16(exp2(acc * qks2 - m2)) in the accumulator
// layout, which is the A fragment of a k16 PV step as it stands, and PV on
// mma.sync m16n8k16 bf16 with f32 sums (V's B fragments by ldmatrix.trans,
// mma_attention::pv_block); p never touches shared memory. The row-max
// softmaxes take one pass more for the max, and kReduce and kPv8, which need
// l before PV, one more for l. kPv8 and kPv8Defer stay exact: p8 in [0, 127]
// and v8 are exact in bf16, each product is exact in f32, and |sum| <= S *
// 127^2 < 2^24, so the f32 sum is the int32 sum in any order. Only kMxu,
// kReduce and kReduceDefer sum PV (and l) in another order than the plain
// version. A thread's share of l (its keys of rows g and g + 8) is summed
// in block order and the quad's four by two shuffles. The decomposition
// probe's VAR switch lives here: full is the packed entry's kernel itself,
// noexp that kernel without exp2, and qkonly and nopv the same kernel's q.k
// (and exp2) with no V staged and no PV.
// Its 3 * pad16(S) * dh bytes of shared memory take S up to 2416, 1200 and
// 592 at dh 32, 64 and 128; an entry given a longer S launches nothing and
// returns kErrTooLong.
// The kernel is latency-bound (each warp's key blocks are a chain of
// ldmatrix, mma, the per-logit ops and mma), so the geometry is set by
// occupancy: at most 5 warps a block and registers capped for 4 blocks an SM
// at dh 32 and 64 (96 at dh 64, no spill), 20 warps an SM, against 14 for 7
// warps a block at 2 blocks an SM (PERF.md §6 has both times).
//
// q3i_cls_kernel, the CLS entries (one query row fills no m16 tile): bound by
// the bytes of K and V it reads once, 38.9 MB at B=128, S=197, H=12, dh=64
// (0.0116 ms at 3.35 TB/s), against 39 M multiply-adds. One block of 8
// warps per (head, sample), 4 to 6 blocks an SM: each stages its head's K and
// V by 16-byte cp.async, all at once in two groups (K, then V), so the
// block's q.k overlaps its own V loads and the other blocks' loads overlap
// its compute; every warp computes (the keys split over the threads for q.k,
// over key slices and head channels for p.v; the sums meet in a fixed order,
// modelled on the CPU in tests/test_torch_int8_attention_order.py). Its
// 2 dh S + 4 S bytes (plus 32 dh + 64) take S up to 3402, 1744 and 878 at dh
// 32, 64 and 128.
//
// What bounds #7: the function reads the 58 MB of int8 qkv and writes 19 MB
// per vision layer at B=128, S=197, H=12, dh=64 (0.0231 ms at 3.35 TB/s),
// against 7.6 G int8 and 7.6 G bf16 multiply-adds (0.008 ms at the dense
// peaks). The tensor-core kernel pads to 16 rows and keys and issues
// mma.sync, which reaches about half the dense rate, and leaves on the CUDA
// cores per logit one convert, two separately rounded f32 ops, exp2, a bf16
// round and one add: about 0.4 G ops at the vision shape. In the
// sequence-major layout a head's 64 bytes of a row lie B*3*D bytes apart, so
// its K/V staging is scattered rather than streamed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "mma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_attention;

constexpr int kClsThreads = 256;  // threads of a CLS block
constexpr int kClsWarps = kClsThreads / 32;
constexpr int kTcMaxWarps = 5;  // warps of a tensor-core block, at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInv127 = 1.0f / 127.0f;
// the dynamic shared memory one block may opt into on sm_90 (227 KB)
constexpr size_t kSmemOptin = 232448;
// what an entry returns, launching nothing, when the head's K and V need more
// shared memory than kSmemOptin (no cudaError_t takes this value)
constexpr int kErrTooLong = -1;

enum Norm : int { kMxu = 0, kReduce = 1, kReduceDefer = 2, kPv8 = 3, kPv8Defer = 4 };
// the normalisations whose PV is the int8 one (p8 = rint(p * 127))
__host__ __device__ constexpr bool pv_int8(int norm) { return norm == kPv8 || norm == kPv8Defer; }

// the decomposition probe's variants of the static kMxu path (template switch
// VAR; kProduction is every entry's kernel, and the probe's "full")
enum Variant : int { kProduction = 0, kNoExp = 1, kQkOnly = 2, kNoPv = 3 };
constexpr float kQkOnlyScale = 2e-5f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// the CLS kernel's shared memory: K and V int8 [S, dh] each, p f32 [S], the
// warps' p.v sums f32 [kClsWarps, dh], and a max and an l a warp
__host__ __device__ size_t smem_bytes_cls(int seq, int dh) {
  return 2 * align16(static_cast<size_t>(seq) * dh) + align16(4 * static_cast<size_t>(seq)) +
         static_cast<size_t>(kClsWarps) * dh * sizeof(float) + 2 * kClsWarps * sizeof(float);
}

// the tensor-core kernel's K (int8) and V (bf16), padded to 16 keys (every
// VAR takes the same, so the probe's cuts keep the occupancy of full)
__host__ __device__ size_t smem_bytes_tc(int seq, int dh) {
  return 3 * static_cast<size_t>(pad16(seq)) * dh;
}

// warps of a tensor-core block: at most kTcMaxWarps, and as few as give every
// warp the same number of 16-row tiles, or one fewer
__host__ __device__ int tc_warps(int seq) {
  const int tiles = (seq + 15) / 16;
  const int per = (tiles + kTcMaxWarps - 1) / kTcMaxWarps;
  return (tiles + per - 1) / per;
}

// byte offset of 16-byte chunk c of row r in a [rows, 16 * CPR] int8 tile: the
// chunks are XOR-swizzled so that the 8 rows one ldmatrix phase reads (128
// bytes) fall on distinct banks (CPR 2, 4 or 8; mma_attention::swz for 4 and 8)
template <int CPR>
__device__ __forceinline__ int swz8(int r, int c) {
  return (r * CPR + (c ^ ((r / (8 / CPR)) & (CPR - 1)))) * 16;
}

// the int8 value in byte i of w, as a float (exact)
__device__ __forceinline__ float s8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}

// Where the operands lie: element (sample b, row r) of q starts at
// q + b*q_batch + r*q_row (bytes), likewise k and v with the kv strides and
// out with the out strides; a head's dh values follow at h*dh.
struct Operands {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  int8_t* out;
  long long q_row, q_batch, kv_row, kv_batch, o_row, o_batch;
};

// ---------------------------------------------------------------------------
// the tensor-core kernel
// ---------------------------------------------------------------------------

// One warp's share of a block: rows [row_w, row_w + 16) of head h against the
// nk keys staged in k_s (int8) and v_s (bf16)
template <int DH, int NORM, bool EXP2I, int VAR>
struct Q3iWarp {
  static constexpr int KS = DH / 32;  // s8 k-steps of q.k
  const int8_t* k_s;
  const bf16* v_s;
  int row_w, causal, lane, g, t, nkw, nb;
  bool use_static;
  float qks, qks2, m2;
  uint32_t qa[KS][4];  // q rows g and g + 8 as s8 A fragments
  float m[2];          // row max of rows g and g + 8 (the row-max softmaxes)

  __device__ __forceinline__ Q3iWarp(const int8_t* k_s_, const bf16* v_s_, int causal_,
                                     const float* qk_scale, const float* qk_m2, int h)
      : k_s(k_s_), v_s(v_s_), causal(causal_) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    use_static = qk_m2 != nullptr;
    qks = qk_scale[h];
    qks2 = __fmul_rn(qks, kLog2e);
    m2 = use_static ? qk_m2[h] : 0.f;
  }

  // the tile of rows [row_w_, row_w_ + 16): its keys and q's A fragments
  // (read straight from device memory; zero past seq)
  __device__ __forceinline__ void tile(int row_w_, int nk, int seq, const int8_t* q_base,
                                       long long q_row) {
    row_w = row_w_;
    nkw = causal ? min(nk, row_w + 16) : nk;  // keys any row of the tile sees
    nb = (nkw + 15) >> 4;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row_w + g + 8 * hr;
      const int8_t* qr = q_base + (row < seq ? row : 0) * q_row + 4 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int hk = 0; hk < 2; ++hk)
          qa[ks][hr + 2 * hk] =
              row < seq ? *reinterpret_cast<const uint32_t*>(qr + ks * 32 + hk * 16) : 0u;
    }
  }

  // c[n] = q . k over key block kb (keys 16 kb + 8 n + 0..7), exact
  __device__ __forceinline__ void qk(int (&c)[2][4], int kb) const {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][i] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t r[4];
      ldsm_x4(r, k_s + swz8<DH / 16>(kb * 16 + (lane >> 4) * 8 + (lane & 7),
                                       2 * ks + ((lane >> 3) & 1)));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_s8(c[0], qa[ks], b0);
      mma_s8(c[1], qa[ks], b1);
    }
  }

  // whether element e of block kb (e = 4 n + accumulator index: row g + 8
  // ((e >> 1) & 1), key 16 kb + 8 n + 2t + (e & 1)) is a key the row sees
  __device__ __forceinline__ bool keep(int kb, int e) const {
    const int key = kb * 16 + (e >> 2) * 8 + 2 * t + (e & 1);
    return key < nkw && (!causal || key <= row_w + g + ((e >> 1) & 1) * 8);
  }

  // no key of block kb is masked for any row of the warp (warp-uniform)
  __device__ __forceinline__ bool whole(int kb) const {
    return (kb + 1) * 16 <= nkw && !(causal && (kb + 1) * 16 > row_w + 1);
  }

  // the softmax numerator of one logit (the variants: their cut stage)
  __device__ __forceinline__ float expo(int acc, int hr) const {
    const float a = static_cast<float>(acc);
    if constexpr (VAR == kQkOnly) {
      return a;
    } else if constexpr (VAR == kNoExp || VAR == kNoPv) {
      const float t2 = __fsub_rn(__fmul_rn(a, qks2), m2);
      return VAR == kNoExp ? t2 : exp2f(t2);
    } else {
      if (use_static) return exp2f(__fsub_rn(__fmul_rn(a, qks2), m2));
      if constexpr (EXP2I) return exp2f(__fmul_rn(__fsub_rn(a, m[hr]), qks2));  // exact difference
      return expf(__fsub_rn(__fmul_rn(a, qks), m[hr]));
    }
  }

  // the row max over the keys each row sees: of acc (exp2i) or of the f32 logits
  __device__ __forceinline__ void row_max() {
    m[0] = m[1] = -CUDART_INF_F;
    for (int kb = 0; kb < nb; ++kb) {
      int c[2][4];
      qk(c, kb);
      const bool all = whole(kb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = static_cast<float>(c[e >> 2][e & 3]);
        const float s = EXP2I ? a : __fmul_rn(a, qks);
        if (all || keep(kb, e)) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], s);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
      m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
    }
  }

  // the numerators of block kb, 0 where masked
  __device__ __forceinline__ void exps(int kb, float (&e8)[8]) const {
    int c[2][4];
    qk(c, kb);
    const bool all = whole(kb);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = expo(c[e >> 2][e & 3], (e >> 1) & 1);
      e8[e] = all || keep(kb, e) ? x : 0.f;
    }
  }

  // the f32 sum of the unrounded numerators of each row (kReduce, kPv8)
  __device__ __forceinline__ void row_sum(float (&l)[2]) const {
    l[0] = l[1] = 0.f;
    for (int kb = 0; kb < nb; ++kb) {
      float e8[8];
      exps(kb, e8);
#pragma unroll
      for (int e = 0; e < 8; ++e) l[(e >> 1) & 1] += e8[e];
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
  }

  // PV over every key block: p as NORM takes it into the A fragment, the
  // row sums that follow PV (kMxu, the deferred forms) into l
  __device__ __forceinline__ void pv(float (&acc)[DH / 8][4], float (&l)[2]) const {
    constexpr bool kLAfter = NORM == kMxu || NORM == kReduceDefer || NORM == kPv8Defer;
    float lp[2] = {0.f, 0.f};
    for (int kb = 0; kb < nb; ++kb) {
      float p[8];
      exps(kb, p);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int hr = (e >> 1) & 1;
        float x = p[e];
        if constexpr (NORM == kMxu) x = __bfloat162float(__float2bfloat16_rn(x));
        if constexpr (kLAfter) lp[hr] += x;
        if constexpr (NORM == kReduce || NORM == kPv8) x = __fdiv_rn(x, l[hr]);
        if constexpr (pv_int8(NORM)) x = fminf(fmaxf(rintf(__fmul_rn(x, 127.f)), 0.f), 127.f);
        p[e] = x;
      }
      const uint32_t a[1][4] = {{pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                                 pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])}};
      pv_block<DH>(acc, a, v_s, kb, lane);
    }
    if constexpr (kLAfter) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        lp[hr] += __shfl_xor_sync(0xffffffffu, lp[hr], 1);
        lp[hr] += __shfl_xor_sync(0xffffffffu, lp[hr], 2);
        l[hr] = lp[hr];
      }
    }
  }
};

// The head's K (int8, by cp.async) and, with STAGE_V, V (bf16, by register
// loads: int8 -> bf16 is exact) for keys [0, nk), zero to pad16(nk) keys, each
// in the swizzled layout its ldmatrix reads; every thread of the block takes part
template <int DH, bool STAGE_V>
__device__ __forceinline__ void stage_kv(const int8_t* k_base, const int8_t* v_base,
                                         long long kv_row, int nk, int8_t* k_s, bf16* v_s) {
  constexpr int kCpr = DH / 16;  // 16-byte chunks of a row of int8
  const int n = pad16(nk) * kCpr;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int r = c / kCpr, ch = c - r * kCpr;
    const bool ok = r < nk;
    cp_async16(k_s + swz8<kCpr>(r, ch), k_base + (ok ? r * kv_row + ch * 16 : 0), ok);
  }
  cp_async_commit();
  if constexpr (STAGE_V) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int r = c / kCpr, ch = c - r * kCpr;
      const uint4 raw = r < nk ? *reinterpret_cast<const uint4*>(v_base + r * kv_row + ch * 16)
                               : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = pack_bf16(s8_at(words[i >> 1], 2 * (i & 1)), s8_at(words[i >> 1], 2 * (i & 1) + 1));
      *reinterpret_cast<uint4*>(v_s + swz(r, 2 * ch, DH / 8)) = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(v_s + swz(r, 2 * ch + 1, DH / 8)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  cp_async_wait(0);
  __syncthreads();
}

// VAR kQkOnly and kNoPv (the probe's cuts with no PV) stage no V and, for
// each row, write clip(rint(f32(acc_j) * 2e-5)) (qkonly) or clip(rint(p_j *
// o_inv)) (nopv) to out[., h*dh + j] for the first DH keys (the caller checks
// seq >= DH); an empty asm keeps the other keys' values
template <int DH, int NORM, bool EXP2I, int VAR = kProduction>
__global__ void __launch_bounds__(kTcMaxWarps * 32, DH == 128 ? 2 : 4)
q3i_kernel_tc(Operands ops, const float* __restrict__ deq_v, const float* __restrict__ qk_scale,
              const float* __restrict__ o_inv, const float* __restrict__ qk_m2, int seq,
              int kv_len, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kDefer = NORM == kReduceDefer || NORM == kPv8Defer;
  constexpr bool kSlice = VAR == kQkOnly || VAR == kNoPv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nk = min(kv_len, seq);
  int8_t* k_s = reinterpret_cast<int8_t*>(smem);
  bf16* v_s = reinterpret_cast<bf16*>(smem + static_cast<size_t>(pad16(nk)) * DH);
  stage_kv<DH, !kSlice>(ops.k + b * ops.kv_batch + h * DH, ops.v + b * ops.kv_batch + h * DH,
                        ops.kv_row, nk, k_s, v_s);

  Q3iWarp<DH, NORM, EXP2I, VAR> wa(k_s, v_s, causal, qk_scale, qk_m2, h);
  const int g = wa.g, t = wa.t;
  const int8_t* q_base = ops.q + b * ops.q_batch + h * DH;
  for (int row_w = (threadIdx.x >> 5) * 16; row_w < seq; row_w += 16 * (blockDim.x >> 5)) {
    wa.tile(row_w, nk, seq, q_base, ops.q_row);
    if constexpr (kSlice) {
      for (int kb = 0; kb < wa.nb; ++kb) {
        int c[2][4];
        wa.qk(c, kb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = wa.expo(c[e >> 2][e & 3], 0);
          const int row = row_w + g + ((e >> 1) & 1) * 8;
          const int key = kb * 16 + (e >> 2) * 8 + 2 * t + (e & 1);
          if (kb < DH / 16) {
            const float o = VAR == kQkOnly ? __fmul_rn(x, kQkOnlyScale)
                                           : __fmul_rn(x, o_inv[h * DH + key]);
            if (row < seq)
              ops.out[b * ops.o_batch + row * ops.o_row + h * DH + key] =
                  static_cast<int8_t>(fminf(fmaxf(rintf(o), -127.f), 127.f));
          } else {
            asm volatile("" ::"f"(x));
          }
        }
      }
    } else {
      float l[2];
      if (!wa.use_static) wa.row_max();
      if constexpr (NORM == kReduce || NORM == kPv8) wa.row_sum(l);
      float acc[DH / 8][4];
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
      wa.pv(acc, l);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row_w + g + 8 * hr;
        if (row >= seq) continue;
        int8_t* dst = ops.out + b * ops.o_batch + row * ops.o_row + h * DH + 2 * t;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
          int8_t o8[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = h * DH + nd * 8 + 2 * t + j;
            float scale = __fmul_rn(deq_v[col], o_inv[col]);
            if constexpr (pv_int8(NORM)) scale = __fmul_rn(scale, kInv127);
            float o = __fmul_rn(acc[nd][2 * hr + j], scale);  // kPv8: an exact integer times scale
            if constexpr (NORM == kMxu || kDefer) o = __fdiv_rn(o, l[hr]);
            o8[j] = static_cast<int8_t>(fminf(fmaxf(rintf(o), -127.f), 127.f));
          }
          *reinterpret_cast<char2*>(dst + nd * 8) = make_char2(o8[0], o8[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the CLS kernel (query row 0; the static or the f32 row-max softmax, the
// ones-column row sum)
// ---------------------------------------------------------------------------

// One block of kClsThreads per (head, sample). The head's K and V rows go to
// shared memory by 16-byte cp.async in two groups (K, then V), so the block's
// q.k runs while its V is still in flight and the other blocks on the SM
// (4 to 6 at S=197) keep their own loads in flight during its compute. K's
// chunks are swizzled (swz8) so that the 8 keys of a quarter warp's 16-byte
// reads fall on distinct banks; V rows lie packed, so that a warp's word
// reads cover 128 contiguous bytes.
// q.k: thread j takes keys j, j + kClsThreads, ... (exact __dp4a sums), p is
// formed and rounded to bf16 as the plain version does, and each thread sums
// its own p in key order; the warps' sums meet by a shuffle tree, then in
// warp order. p.v: thread (slice, word) takes the 4 head channels of its
// word over keys slice, slice + kSlices, ... (an fmaf chain in key order; each
// product of a bf16 p and an int8 v is exact in f32), the slices of a warp
// meet by shuffles (xor kW, 2 kW, ...), the warps' sums in warp order.
template <int DH>
struct Cls {
  static constexpr int kCpr = DH / 16;                // 16-byte chunks of a row
  static constexpr int kW = DH / 4;                   // 32-bit words of a row
  static constexpr int kSlices = kClsThreads / kW;    // key slices of p.v
};

template <int DH>
__global__ void __launch_bounds__(kClsThreads, DH == 128 ? 3 : 4)
q3i_cls_kernel(Operands ops, const float* __restrict__ deq_v, const float* __restrict__ qk_scale,
               const float* __restrict__ o_inv, const float* __restrict__ qk_m2, int seq) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = Cls<DH>;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int8_t* k_s = reinterpret_cast<int8_t*>(smem);
  int8_t* v_s = k_s + align16(static_cast<size_t>(seq) * DH);
  float* p_s = reinterpret_cast<float*>(v_s + align16(static_cast<size_t>(seq) * DH));
  float* part = p_s + align16(4 * static_cast<size_t>(seq)) / 4;  // [kClsWarps][DH]
  float* red = part + kClsWarps * DH;                               // max, then l, a warp each

  const int8_t* k_base = ops.k + b * ops.kv_batch + h * DH;
  const int8_t* v_base = ops.v + b * ops.kv_batch + h * DH;
  const int n = seq * C::kCpr;
  for (int c = tid; c < n; c += kClsThreads) {
    const int r = c / C::kCpr, ch = c - r * C::kCpr;
    cp_async16(k_s + swz8<C::kCpr>(r, ch), k_base + r * ops.kv_row + ch * 16, true);
  }
  cp_async_commit();
  for (int c = tid; c < n; c += kClsThreads) {
    const int r = c / C::kCpr, ch = c - r * C::kCpr;
    cp_async16(v_s + c * 16, v_base + r * ops.kv_row + ch * 16, true);
  }
  cp_async_commit();

  int q[C::kW];
  const int* q_src = reinterpret_cast<const int*>(ops.q + b * ops.q_batch + h * DH);
#pragma unroll
  for (int w = 0; w < C::kW; ++w) q[w] = q_src[w];
  const bool use_static = qk_m2 != nullptr;
  const float qks = qk_scale[h];
  const float qks2 = __fmul_rn(qks, kLog2e);
  const float m2 = use_static ? qk_m2[h] : 0.f;
  cp_async_wait(1);  // this thread's K copies
  __syncthreads();

  float m = -CUDART_INF_F, l = 0.f;
  for (int j = tid; j < seq; j += kClsThreads) {
    int acc = 0;
#pragma unroll
    for (int ch = 0; ch < C::kCpr; ++ch) {
      const int4 k4 = *reinterpret_cast<const int4*>(k_s + swz8<C::kCpr>(j, ch));
      acc = __dp4a(q[4 * ch], k4.x, acc);
      acc = __dp4a(q[4 * ch + 1], k4.y, acc);
      acc = __dp4a(q[4 * ch + 2], k4.z, acc);
      acc = __dp4a(q[4 * ch + 3], k4.w, acc);
    }
    const float a = static_cast<float>(acc);
    if (use_static) {
      const float e = __bfloat162float(__float2bfloat16_rn(exp2f(__fsub_rn(__fmul_rn(a, qks2), m2))));
      p_s[j] = e;
      l += e;
    } else {
      const float s = __fmul_rn(a, qks);
      p_s[j] = s;
      m = fmaxf(m, s);
    }
  }
  if (!use_static) {
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[0];
#pragma unroll
    for (int w = 1; w < kClsWarps; ++w) m = fmaxf(m, red[w]);
    for (int j = tid; j < seq; j += kClsThreads) {  // this thread's own keys
      const float e = __bfloat162float(__float2bfloat16_rn(expf(__fsub_rn(p_s[j], m))));
      p_s[j] = e;
      l += e;
    }
  }
  l = warp_sum(l);
  if (lane == 0) red[kClsWarps + warp] = l;
  cp_async_wait(0);  // this thread's V copies
  __syncthreads();   // p, the warps' sums and V, for every thread
  l = red[kClsWarps];
#pragma unroll
  for (int w = 1; w < kClsWarps; ++w) l += red[kClsWarps + w];

  const int word = tid % C::kW, slice = tid / C::kW;
  float o4[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = slice; j < seq; j += C::kSlices) {
    const float pj = p_s[j];
    const uint32_t v4 = *reinterpret_cast<const uint32_t*>(v_s + j * DH + 4 * word);
#pragma unroll
    for (int i = 0; i < 4; ++i) o4[i] = fmaf(pj, s8_at(v4, i), o4[i]);
  }
#pragma unroll
  for (int o = C::kW; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) o4[i] += __shfl_xor_sync(0xffffffffu, o4[i], o);
  if (lane < C::kW)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[warp * DH + 4 * lane + i] = o4[i];
  __syncthreads();
  if (tid < DH) {
    float o = part[tid];
#pragma unroll
    for (int w = 1; w < kClsWarps; ++w) o += part[w * DH + tid];
    const int col = h * DH + tid;
    o = __fdiv_rn(__fmul_rn(o, __fmul_rn(deq_v[col], o_inv[col])), l);
    ops.out[b * ops.o_batch + h * DH + tid] =
        static_cast<int8_t>(fminf(fmaxf(rintf(o), -127.f), 127.f));
  }
}

// The decomposition probe's copy floor: the q segment of each row of the
// packed [rows, 3*D] int8 tensor to out [rows, D], 16 bytes a thread-step
// (D % 16 == 0 and both tensors 16-byte aligned; the entry checks).
__global__ void __launch_bounds__(256)
q_copy_kernel(const int8_t* __restrict__ qkv, int8_t* __restrict__ out, long long rows, int d) {
  const int chunks = d / 16;
  const long long n = rows * chunks;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = idx / chunks;
    const int c = static_cast<int>(idx - r * chunks);
    reinterpret_cast<uint4*>(out + r * d)[c] = reinterpret_cast<const uint4*>(qkv + r * 3 * d)[c];
  }
}

struct Args {
  Operands ops;
  const float* deq_v;  // v's dequant scales: the [D] segment at 2*D of deq
  const float* qks;
  const float* o_inv;
  const float* qk_m2;
  int batch, seq, heads, dh, kv_len, causal;
  cudaStream_t stream;
};

template <int DH>
int launch_cls(const Args& a) {
  const size_t smem = smem_bytes_cls(a.seq, DH);
  if (smem > kSmemOptin) return kErrTooLong;
  cudaError_t err = cudaFuncSetAttribute(
      q3i_cls_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.heads, a.batch);
  q3i_cls_kernel<DH><<<grid, kClsThreads, smem, a.stream>>>(a.ops, a.deq_v, a.qks, a.o_inv,
                                                            a.qk_m2, a.seq);
  return cudaGetLastError();
}

int launch_cls_dh(const Args& a) {
  switch (a.dh) {
    case 32: return launch_cls<32>(a);
    case 64: return launch_cls<64>(a);
    case 128: return launch_cls<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int DH, int NORM, bool EXP2I, int VAR>
int launch_tc(const Args& a) {
  const size_t smem = smem_bytes_tc(a.seq, DH);
  if (smem > kSmemOptin) return kErrTooLong;
  cudaError_t err = cudaFuncSetAttribute(q3i_kernel_tc<DH, NORM, EXP2I, VAR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.heads, a.batch);
  q3i_kernel_tc<DH, NORM, EXP2I, VAR><<<grid, 32 * tc_warps(a.seq), smem, a.stream>>>(
      a.ops, a.deq_v, a.qks, a.o_inv, a.qk_m2, a.seq, a.kv_len, a.causal);
  return cudaGetLastError();
}

template <int NORM, bool EXP2I, int VAR = kProduction>
int launch_dh(const Args& a) {
  switch (a.dh) {
    case 32: return launch_tc<32, NORM, EXP2I, VAR>(a);
    case 64: return launch_tc<64, NORM, EXP2I, VAR>(a);
    case 128: return launch_tc<128, NORM, EXP2I, VAR>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool EXP2I>
int launch_norm(const Args& a, int norm) {
  switch (norm) {
    case kMxu: return launch_dh<kMxu, EXP2I>(a);
    case kReduce: return launch_dh<kReduce, EXP2I>(a);
    case kReduceDefer: return launch_dh<kReduceDefer, EXP2I>(a);
    case kPv8: return launch_dh<kPv8, EXP2I>(a);
    case kPv8Defer: return launch_dh<kPv8Defer, EXP2I>(a);
    default: return cudaErrorInvalidValue;
  }
}

// deq is the full [3*D] vector of the heads' D = heads*dh columns: v's
// segment starts at 2*D
Args make_args(const void* q, const void* k, const void* v, void* out, const void* deq,
               const void* qks, const void* o_inv, const void* qk_m2, int batch, int seq,
               int heads, int dh, void* stream) {
  Args a;
  a.ops.q = static_cast<const int8_t*>(q);
  a.ops.k = static_cast<const int8_t*>(k);
  a.ops.v = static_cast<const int8_t*>(v);
  a.ops.out = static_cast<int8_t*>(out);
  a.deq_v = static_cast<const float*>(deq) + 2 * static_cast<long long>(heads) * dh;
  a.qks = static_cast<const float*>(qks);
  a.o_inv = static_cast<const float*>(o_inv);
  a.qk_m2 = static_cast<const float*>(qk_m2);
  a.batch = batch;
  a.seq = seq;
  a.heads = heads;
  a.dh = dh;
  a.kv_len = seq;
  a.causal = 0;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// Pointers are device pointers: qkv int8 [B, S, 3*D]; deq float [3*D]; qk_scale
// float [H]; o_inv float [D]; qk_m2 float [H] or NULL for the row-max or
// exp2i softmax; out int8 [B, S, D]. exp2i: 1 for the integer row-max
// softmax (unmasked only); norm: one of Norm. Returns the cudaError_t of the
// launch (0 on success), or -1, launching nothing, when S is longer than the
// kernel's shared memory takes (every entry below does the same).
extern "C" int team_mha_packed_q3i_fwd(const void* qkv, const void* deq, const void* qk_scale,
                                       const void* o_inv, const void* qk_m2, void* out, int batch,
                                       int seq, int heads, int dh, int kv_len, int causal,
                                       int exp2i, int norm, void* stream) {
  const long long d = static_cast<long long>(heads) * dh;
  const int8_t* base = static_cast<const int8_t*>(qkv);
  Args a = make_args(base, base + d, base + 2 * d, out, deq, qk_scale, o_inv, qk_m2, batch, seq,
                     heads, dh, stream);
  a.ops.q_row = a.ops.kv_row = 3 * d;
  a.ops.q_batch = a.ops.kv_batch = 3 * d * seq;
  a.ops.o_row = d;
  a.ops.o_batch = d * seq;
  a.kv_len = kv_len;
  a.causal = causal;
  return exp2i ? launch_norm<true>(a, norm) : launch_norm<false>(a, norm);
}

// The CLS query only: qkv int8 [B, S, 3*D] -> out int8 [B, 1, D], non-causal,
// every key, the default normalisation.
extern "C" int team_mha_packed_q3i_cls_fwd(const void* qkv, const void* deq, const void* qk_scale,
                                           const void* o_inv, const void* qk_m2, void* out,
                                           int batch, int seq, int heads, int dh, void* stream) {
  const long long d = static_cast<long long>(heads) * dh;
  const int8_t* base = static_cast<const int8_t*>(qkv);
  Args a = make_args(base, base + d, base + 2 * d, out, deq, qk_scale, o_inv, qk_m2, batch, seq,
                     heads, dh, stream);
  a.ops.q_row = a.ops.kv_row = 3 * d;
  a.ops.q_batch = a.ops.kv_batch = 3 * d * seq;
  a.ops.o_row = a.ops.o_batch = d;
  return launch_cls_dh(a);
}

// The CLS query over split inputs: q int8 [B, 1, D] (the CLS row's q) and kv
// int8 [B, S, 2*D] (k, then v) -> out int8 [B, 1, D]; deq keeps its [3*D]
// layout (v's scales at [2D, 3D)). The arithmetic of the CLS entry.
extern "C" int team_mha_packed_q3i_cls_split_fwd(const void* q, const void* kv, const void* deq,
                                                 const void* qk_scale, const void* o_inv,
                                                 const void* qk_m2, void* out, int batch, int seq,
                                                 int heads, int dh, void* stream) {
  const long long d = static_cast<long long>(heads) * dh;
  const int8_t* kv8 = static_cast<const int8_t*>(kv);
  Args a = make_args(q, kv8, kv8 + d, out, deq, qk_scale, o_inv, qk_m2, batch, seq, heads, dh,
                     stream);
  a.ops.q_row = a.ops.q_batch = d;
  a.ops.kv_row = 2 * d;
  a.ops.kv_batch = 2 * d * seq;
  a.ops.o_row = a.ops.o_batch = d;
  return launch_cls_dh(a);
}
// The packed entry's heads split over nm tensor-parallel ranks: rank r of nm
// reads heads [r*H/nm, (r+1)*H/nm) of the full qkv int8 [B, S, 3*D] in place
// and writes out int8 [B, S, D/nm]; deq [3*D], qk_scale [H], o_inv [D] and
// qk_m2 [H] (or NULL) are the full vectors, read at the rank's heads through
// offset pointers. heads_local = H/nm; the other arguments as the packed
// entry's, whose arithmetic each head keeps, so the ranks' outputs side by
// side are that entry's bit for bit.
extern "C" int team_mha_packed_q3i_tp_fwd(const void* qkv, const void* deq, const void* qk_scale,
                                          const void* o_inv, const void* qk_m2, void* out,
                                          int batch, int seq, int heads_local, int dh, int rank,
                                          int nm, int kv_len, int causal, int exp2i, int norm,
                                          void* stream) {
  if (nm < 1 || rank < 0 || rank >= nm) return cudaErrorInvalidValue;
  const long long d_local = static_cast<long long>(heads_local) * dh;
  const long long d = d_local * nm;
  const long long head0 = static_cast<long long>(rank) * heads_local;
  const int8_t* base = static_cast<const int8_t*>(qkv) + rank * d_local;
  Args a = make_args(base, base + d, base + 2 * d, out, deq, qk_scale, o_inv, qk_m2, batch, seq,
                     heads_local, dh, stream);
  a.deq_v = static_cast<const float*>(deq) + 2 * d + rank * d_local;
  a.qks = static_cast<const float*>(qk_scale) + head0;
  a.o_inv = static_cast<const float*>(o_inv) + rank * d_local;
  if (qk_m2 != nullptr) a.qk_m2 = static_cast<const float*>(qk_m2) + head0;
  a.ops.q_row = a.ops.kv_row = 3 * d;
  a.ops.q_batch = a.ops.kv_batch = 3 * d * seq;
  a.ops.o_row = d_local;
  a.ops.o_batch = d_local * seq;
  a.kv_len = kv_len;
  a.causal = causal;
  return exp2i ? launch_norm<true>(a, norm) : launch_norm<false>(a, norm);
}

// The variants of scripts/r4_attn_decomp.py:_variant_kernel, the probe that
// cuts the packed entry's static kMxu path into parts: qkv int8 [B, S, 3*D]
// -> out int8 [B, S, D]; qk_scale [H], o_inv [D] and qk_m2 [H] as the packed
// entry's; deq [3*D] is all ones (the probe has no dequant: v's scale 1 makes
// pv_scale = 1 * o_inv = o_inv exactly). variant:
//   0 copy:   out = the q segment of qkv;
//   1 full:   the packed entry's own kernel (static softmax, kMxu);
//   2 noexp:  full with exp2 removed (p = acc*qks*log2e - m2);
//   3 qkonly: out[., h*dh + j] = clip(rint(f32(acc_j) * 2e-5)) for keys j < dh;
//   4 nopv:   out[., h*dh + j] = clip(rint(exp2(...)_j * o_inv)) for keys j < dh.
// qkonly and nopv compute every key's q.k (and exp2) of the row as full does
// and write the first dh: they need seq >= dh.
extern "C" int team_mha_q3i_variant_fwd(const void* qkv, const void* deq, const void* qk_scale,
                                        const void* o_inv, const void* qk_m2, void* out,
                                        int batch, int seq, int heads, int dh, int variant,
                                        void* stream) {
  const long long d = static_cast<long long>(heads) * dh;
  if (variant == 0) {
    if (d % 16 != 0 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return cudaErrorInvalidValue;
    const long long rows = static_cast<long long>(batch) * seq;
    const long long want = (rows * (d / 16) + 255) / 256;
    const int blocks = static_cast<int>(want < 1 ? 1 : (want > 132 * 32 ? 132 * 32 : want));
    q_copy_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(qkv), static_cast<int8_t*>(out), rows, static_cast<int>(d));
    return cudaGetLastError();
  }
  if (qk_m2 == nullptr || variant < 0 || variant > 4) return cudaErrorInvalidValue;
  if ((variant == 3 || variant == 4) && seq < dh) return cudaErrorInvalidValue;
  const int8_t* base = static_cast<const int8_t*>(qkv);
  Args a = make_args(base, base + d, base + 2 * d, out, deq, qk_scale, o_inv, qk_m2, batch, seq,
                     heads, dh, stream);
  a.ops.q_row = a.ops.kv_row = 3 * d;
  a.ops.q_batch = a.ops.kv_batch = 3 * d * seq;
  a.ops.o_row = d;
  a.ops.o_batch = d * seq;
  switch (variant) {
    case 1: return launch_dh<kMxu, false>(a);
    case 2: return launch_dh<kMxu, false, kNoExp>(a);
    case 3: return launch_dh<kMxu, false, kQkOnly>(a);
    default: return launch_dh<kMxu, false, kNoPv>(a);
  }
}

// Sequence-major: qkv int8 [S, B, 3*D] -> out int8 [S, B, D], non-causal,
// every key, the row-max softmax and the kReduce normalisation.
extern "C" int team_mha_packed_q3i_sb_fwd(const void* qkv, const void* deq, const void* qk_scale,
                                          const void* o_inv, void* out, int batch, int seq,
                                          int heads, int dh, void* stream) {
  const long long d = static_cast<long long>(heads) * dh;
  const int8_t* base = static_cast<const int8_t*>(qkv);
  Args a = make_args(base, base + d, base + 2 * d, out, deq, qk_scale, o_inv, nullptr, batch, seq,
                     heads, dh, stream);
  a.ops.q_row = a.ops.kv_row = 3 * d * batch;
  a.ops.q_batch = a.ops.kv_batch = 3 * d;
  a.ops.o_row = d * batch;
  a.ops.o_batch = d;
  return launch_dh<kReduce, false>(a);
}
