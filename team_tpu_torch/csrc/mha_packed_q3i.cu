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
// k with one scale per head, v per channel) and write int8. One kernel serves
// them: it reads q, k and v and writes out through explicit row and sample
// strides, so the packed [B, S, 3*D] layout, the sequence-major [S, B, 3*D]
// layout and the split q [B, 1, D] + kv [B, S, 2*D] inputs differ only in the
// pointers and strides each entry passes. So does the tensor-parallel head
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
// jnp.round), never roundf. Masked keys are skipped rather than set to -1e30:
// exp(-1e30 - max) is 0 in f32, so the sums are the same while every row
// keeps a key (the wrapper checks kv_len >= 1). |acc| <= dh * 127^2 and the
// int8 PV sum <= S * 127^2 stay below 2^24, so both are exact as floats.
//
// Layout: one block per (query tile of kRows rows, head, sample); the CLS
// entries are the same block with only query row 0. The block stages that
// head's K and V rows into shared memory as int8 (25 KB at S=197, dh=64),
// rows padded by one 32-bit word so that lanes reading different keys hit
// different banks. Each warp takes every kWarps-th query row of the tile: q
// stays in registers as dh/4 packed words, lanes split the keys and form q.k
// with __dp4a (four int8 products and the add into the int32 sum in one
// instruction, exact), the row max and sum are warp shuffles, and for p.v the
// lanes split the head dimension.
//
// What bounds it on an H100: this first version runs on the CUDA cores. Per
// (sample, head) it does S^2*dh/4 dp4a for q.k and S^2*dh FMAs for p.v --
// 3.8 G FMAs per vision layer at B=128, S=197, H=12, dh=64 -- fed from
// shared memory, and it reads the 58 MB of int8 qkv and writes 19 MB (each
// query tile re-reads its head's K and V, mostly from L2). The p.v loop,
// one shared-memory broadcast of p and one byte of v per FMA, is the bound;
// moving both products onto the int8 and bf16 tensor cores (mma.sync) is
// the next step. In the sequence-major layout a head's 64 bytes of a row lie
// B*3*D bytes apart, so its K/V staging is scattered rather than streamed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 64;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInv127 = 1.0f / 127.0f;

enum Norm : int { kMxu = 0, kReduce = 1, kReduceDefer = 2, kPv8 = 3, kPv8Defer = 4 };

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

// padded shared-memory row stride of K and V, in 32-bit words
__host__ __device__ constexpr int kv_words(int dh) { return dh / 4 + 1; }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

__host__ __device__ size_t smem_bytes(int seq, int dh) {
  return align16(2 * static_cast<size_t>(seq) * kv_words(dh) * sizeof(int)) +
         static_cast<size_t>(kWarps) * seq * sizeof(float);
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

template <int DH, bool CLS, int NORM, bool EXP2I, int VAR = kProduction>
__global__ void __launch_bounds__(kWarps * 32)
q3i_kernel(Operands ops, const float* __restrict__ deq_v, const float* __restrict__ qk_scale,
           const float* __restrict__ o_inv, const float* __restrict__ qk_m2, int seq, int heads,
           int kv_len, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kW = DH / 4;  // packed words of one head row
  constexpr int kStride = kW + 1;
  constexpr int kPerLane = DH / 32;
  constexpr bool kDefer = NORM == kReduceDefer || NORM == kPv8Defer;
  constexpr bool kPvInt8 = NORM == kPv8 || NORM == kPv8Defer;
  // qkonly and nopv write a slice of each row's first DH keys, without PV
  constexpr bool kSliceOut = VAR == kQkOnly || VAR == kNoPv;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = CLS ? 0 : blockIdx.x * kRows;
  const int row_end = CLS ? 1 : min(row0 + kRows, seq);
  const int8_t* q_base = ops.q + b * ops.q_batch + h * DH;
  const int8_t* k_base = ops.k + b * ops.kv_batch + h * DH;
  const int8_t* v_base = ops.v + b * ops.kv_batch + h * DH;

  int* k_s = reinterpret_cast<int*>(smem);
  int* v_s = k_s + static_cast<size_t>(seq) * kStride;
  float* p_all = reinterpret_cast<float*>(smem + align16(2 * static_cast<size_t>(seq) * kStride * sizeof(int)));

  // keys any row of this tile may attend
  int n_keys = min(kv_len, seq);
  if (causal) n_keys = min(n_keys, row_end);
  for (int idx = threadIdx.x; idx < n_keys * kW; idx += blockDim.x) {
    const int r = idx / kW;
    const int w = idx - r * kW;
    k_s[r * kStride + w] = reinterpret_cast<const int*>(k_base + r * ops.kv_row)[w];
    if constexpr (!kSliceOut) v_s[r * kStride + w] = reinterpret_cast<const int*>(v_base + r * ops.kv_row)[w];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* p = p_all + warp * seq;
  const int8_t* v_bytes = reinterpret_cast<const int8_t*>(v_s);
  const bool use_static = qk_m2 != nullptr;
  const float qks = qk_scale[h];
  const float qks2 = __fmul_rn(qks, kLog2e);
  const float m2 = use_static ? qk_m2[h] : 0.f;
  float pv_scale[kPerLane];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int col = h * DH + lane + 32 * c;
    pv_scale[c] = __fmul_rn(deq_v[col], o_inv[col]);
    if constexpr (kPvInt8) pv_scale[c] = __fmul_rn(pv_scale[c], kInv127);
  }

  for (int i = row0 + warp; i < row_end; i += kWarps) {
    int q[kW];
    const int* q_src = reinterpret_cast<const int*>(q_base + i * ops.q_row);
#pragma unroll
    for (int w = 0; w < kW; ++w) q[w] = q_src[w];

    const int nk = causal ? min(n_keys, i + 1) : n_keys;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nk; j += 32) {
      const int* k_row = k_s + j * kStride;
      int acc = 0;
#pragma unroll
      for (int w = 0; w < kW; ++w) acc = __dp4a(q[w], k_row[w], acc);
      const float a = static_cast<float>(acc);
      float s;
      if constexpr (VAR == kQkOnly) {
        s = a;
      } else if constexpr (VAR == kNoExp || VAR == kNoPv) {
        const float t = __fsub_rn(__fmul_rn(a, qks2), m2);
        s = VAR == kNoExp ? t : exp2f(t);
      } else if (use_static) {
        s = exp2f(__fsub_rn(__fmul_rn(a, qks2), m2));
      } else if constexpr (EXP2I) {
        s = a;  // the integer row max comes first; a float holds acc exactly
        m = fmaxf(m, s);
      } else {
        s = __fmul_rn(a, qks);
        m = fmaxf(m, s);
      }
      p[j] = s;
    }
    if constexpr (kSliceOut) {
      // qkonly: clip(rint(f32(acc) * 2e-5)); nopv: clip(rint(p * o_inv)), for
      // the first DH keys (the caller checks seq >= DH); each lane reads back
      // the keys it wrote
      int8_t* dst = ops.out + b * ops.o_batch + i * ops.o_row + h * DH;
      for (int c = lane; c < DH; c += 32) {
        const float o = VAR == kQkOnly ? __fmul_rn(p[c], kQkOnlyScale)
                                       : __fmul_rn(p[c], o_inv[h * DH + c]);
        dst[c] = static_cast<int8_t>(fminf(fmaxf(rintf(o), -127.f), 127.f));
      }
      __syncwarp();  // p is rewritten by the next row
      continue;
    }
    if (!use_static) m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      float e;
      if (use_static) {
        e = p[j];
      } else if constexpr (EXP2I) {
        e = exp2f(__fmul_rn(__fsub_rn(p[j], m), qks2));  // acc - max is exact in f32
      } else {
        e = expf(__fsub_rn(p[j], m));
      }
      if constexpr (NORM == kMxu) e = __bfloat162float(__float2bfloat16_rn(e));
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    if constexpr (NORM != kMxu) {
      // the [S] probabilities as the PV product takes them: normalised
      // unless deferred, then bf16 or, for the int8 PV, p8 = rint(p*127)
      __syncwarp();
      for (int j = lane; j < nk; j += 32) {
        float pj = p[j];
        if constexpr (!kDefer) pj = __fdiv_rn(pj, l);
        if constexpr (kPvInt8) {
          pj = fminf(fmaxf(rintf(__fmul_rn(pj, 127.f)), 0.f), 127.f);
        } else {
          pj = __bfloat162float(__float2bfloat16_rn(pj));
        }
        p[j] = pj;
      }
    }
    __syncwarp();

    float o[kPerLane];
    if constexpr (kPvInt8) {
      int acc_i[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) acc_i[c] = 0;
      for (int j = 0; j < nk; ++j) {
        const int pj = static_cast<int>(p[j]);
        const int8_t* v_row = v_bytes + j * kStride * 4;
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) acc_i[c] += pj * static_cast<int>(v_row[lane + 32 * c]);
      }
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) o[c] = __fmul_rn(static_cast<float>(acc_i[c]), pv_scale[c]);
    } else {
      float acc_o[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) acc_o[c] = 0.f;
      for (int j = 0; j < nk; ++j) {
        const float pj = p[j];
        const int8_t* v_row = v_bytes + j * kStride * 4;
#pragma unroll
        for (int c = 0; c < kPerLane; ++c)
          acc_o[c] = fmaf(pj, static_cast<float>(v_row[lane + 32 * c]), acc_o[c]);
      }
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        o[c] = __fmul_rn(acc_o[c], pv_scale[c]);
        if constexpr (NORM == kMxu) o[c] = __fdiv_rn(o[c], l);
      }
    }
    int8_t* dst = ops.out + b * ops.o_batch + i * ops.o_row + h * DH;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      float oc = o[c];
      if constexpr (kDefer) oc = __fdiv_rn(oc, l);
      dst[lane + 32 * c] = static_cast<int8_t>(fminf(fmaxf(rintf(oc), -127.f), 127.f));
    }
    __syncwarp();  // p is rewritten by the next row
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

template <int DH, bool CLS, int NORM, bool EXP2I, int VAR = kProduction>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(a.seq, DH);
  cudaError_t err = cudaFuncSetAttribute(q3i_kernel<DH, CLS, NORM, EXP2I, VAR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(CLS ? 1 : (a.seq + kRows - 1) / kRows, a.heads, a.batch);
  q3i_kernel<DH, CLS, NORM, EXP2I, VAR><<<grid, kWarps * 32, smem, a.stream>>>(
      a.ops, a.deq_v, a.qks, a.o_inv, a.qk_m2, a.seq, a.heads, a.kv_len, a.causal);
  return cudaGetLastError();
}

template <bool CLS, int NORM, bool EXP2I, int VAR = kProduction>
int launch_dh(const Args& a) {
  switch (a.dh) {
    case 32: return launch<32, CLS, NORM, EXP2I, VAR>(a);
    case 64: return launch<64, CLS, NORM, EXP2I, VAR>(a);
    case 128: return launch<128, CLS, NORM, EXP2I, VAR>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool EXP2I>
int launch_norm(const Args& a, int norm) {
  switch (norm) {
    case kMxu: return launch_dh<false, kMxu, EXP2I>(a);
    case kReduce: return launch_dh<false, kReduce, EXP2I>(a);
    case kReduceDefer: return launch_dh<false, kReduceDefer, EXP2I>(a);
    case kPv8: return launch_dh<false, kPv8, EXP2I>(a);
    case kPv8Defer: return launch_dh<false, kPv8Defer, EXP2I>(a);
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

extern "C" size_t team_mha_packed_q3i_smem_bytes(int seq, int dh) { return smem_bytes(seq, dh); }

// Pointers are device pointers: qkv int8 [B, S, 3*D]; deq float [3*D]; qk_scale
// float [H]; o_inv float [D]; qk_m2 float [H] or NULL for the row-max or
// exp2i softmax; out int8 [B, S, D]. exp2i: 1 for the integer row-max
// softmax (unmasked only); norm: one of Norm. Returns the cudaError_t of the
// launch (0 on success).
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
  return launch_dh<true, kMxu, false>(a);
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
  return launch_dh<true, kMxu, false>(a);
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
    case 1: return launch_dh<false, kMxu, false>(a);
    case 2: return launch_dh<false, kMxu, false, kNoExp>(a);
    case 3: return launch_dh<false, kMxu, false, kQkOnly>(a);
    default: return launch_dh<false, kMxu, false, kNoPv>(a);
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
  return launch_dh<false, kReduce, false>(a);
}
