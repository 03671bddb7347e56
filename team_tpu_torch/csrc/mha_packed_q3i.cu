// Integer-QK^T packed attention of the int8 static-W8A8 tier, for Hopper
// (sm_90a), forward only.
//
// Replaces two TPU kernels of team_tpu/ops/mha_short.py:
//   _mha_packed_q3i_kernel     (entry fused_mha_packed_q3i)     -> team_mha_packed_q3i_fwd
//   _mha_packed_q3i_cls_kernel (entry fused_mha_packed_q3i_cls) -> team_mha_packed_q3i_cls_fwd
// Both read the int8 packed qkv [B, S, 3*D] as the qkv GEMM's requantize
// wrote it (q and k with one scale per head, v per channel) and write int8:
// [B, S, D], or [B, 1, D] for the CLS query only. The math is the TPU
// kernel's default route (rowsum "mxu", mha_short.py:516-571):
//   acc = q8 . k8 as an exact int32 sum;
//   static form (qk_m2 given; the wrapper passes it only when nothing is
//   masked): p = exp2(float(acc) * (qks[h] * log2e) - m2[h]);
//   row-max form: logits = float(acc) * qks[h], causal and kv_len masks,
//   p = exp(logits - rowmax);
//   p is rounded to bf16; num = sum_j p_j * v8[j] and den = sum_j p_j in f32
//   (the ones-column of the TPU kernel's PV dot);
//   out = rint(num * (deq_v * o_inv) / den), clipped to +-127.
// Every product and difference the TPU kernel rounds separately is rounded
// separately here too (__fmul_rn, __fsub_rn, __fdiv_rn): nvcc would contract
// a*b - c into one FMA, which rounds once. Rounding is rint (half to even, as
// jnp.round), never roundf. Masked keys are skipped rather than set to -1e30:
// exp(-1e30 - max) is 0 in f32, so the sums are the same while every row
// keeps a key (the wrapper checks kv_len >= 1).
//
// Layout: one block per (query tile of kRows rows, head, sample); the CLS
// kernel is the same block with only query row 0. The block stages that
// head's K and V slices of the packed rows into shared memory as int8 (25 KB
// at S=197, dh=64), rows padded by one 32-bit word so that lanes reading
// different keys hit different banks. Each warp takes every kWarps-th query
// row of the tile: q stays in registers as dh/4 packed words, lanes split the
// keys and form q.k with __dp4a (four int8 products and the add into the
// int32 sum in one instruction, exact), the row max and sum are warp
// shuffles, and for p.v the lanes split the head dimension.
//
// What bounds it on an H100: this first version runs on the CUDA cores. Per
// (sample, head) it does S^2*dh/4 dp4a for q.k and S^2*dh FMAs for p.v --
// 3.8 G FMAs per vision layer at B=128, S=197, H=12, dh=64 -- fed from
// shared memory, and it reads the 58 MB of int8 qkv and writes 19 MB (each
// query tile re-reads its head's K and V, mostly from L2). The p.v loop,
// one shared-memory broadcast of p and one byte of v per FMA, is the bound;
// moving both products onto the int8 and bf16 tensor cores (mma.sync) is
// the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 64;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

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

template <int DH, bool CLS>
__global__ void __launch_bounds__(kWarps * 32)
q3i_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ deq,
           const float* __restrict__ qk_scale, const float* __restrict__ o_inv,
           const float* __restrict__ qk_m2, int8_t* __restrict__ out, int seq, int heads,
           int kv_len, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kW = DH / 4;  // packed words of one head row
  constexpr int kStride = kW + 1;
  constexpr int kPerLane = DH / 32;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = CLS ? 0 : blockIdx.x * kRows;
  const int row_end = CLS ? 1 : min(row0 + kRows, seq);
  const int d_model = heads * DH;
  const size_t ld = 3 * static_cast<size_t>(d_model);  // packed row stride in bytes
  const int8_t* base = qkv + static_cast<size_t>(b) * seq * ld + h * DH;

  int* k_s = reinterpret_cast<int*>(smem);
  int* v_s = k_s + static_cast<size_t>(seq) * kStride;
  float* p_all = reinterpret_cast<float*>(smem + align16(2 * static_cast<size_t>(seq) * kStride * sizeof(int)));

  // keys any row of this tile may attend
  int n_keys = min(kv_len, seq);
  if (causal) n_keys = min(n_keys, row_end);
  for (int idx = threadIdx.x; idx < n_keys * kW; idx += blockDim.x) {
    const int r = idx / kW;
    const int w = idx - r * kW;
    const int* src = reinterpret_cast<const int*>(base + r * ld);
    k_s[r * kStride + w] = src[d_model / 4 + w];
    v_s[r * kStride + w] = src[d_model / 2 + w];
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
    pv_scale[c] = __fmul_rn(deq[2 * d_model + col], o_inv[col]);
  }

  for (int i = row0 + warp; i < row_end; i += kWarps) {
    int q[kW];
    const int* q_src = reinterpret_cast<const int*>(base + i * ld);
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
      if (use_static) {
        s = exp2f(__fsub_rn(__fmul_rn(a, qks2), m2));
      } else {
        s = __fmul_rn(a, qks);
        m = fmaxf(m, s);
      }
      p[j] = s;
    }
    if (!use_static) m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = use_static ? p[j] : expf(__fsub_rn(p[j], m));
      const float eb = __bfloat162float(__float2bfloat16_rn(e));
      p[j] = eb;
      l += eb;
    }
    l = warp_sum(l);
    __syncwarp();

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
    int8_t* dst = out + (static_cast<size_t>(b) * (CLS ? 1 : seq) + i) * d_model + h * DH;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const float o = rintf(__fdiv_rn(__fmul_rn(acc_o[c], pv_scale[c]), l));
      dst[lane + 32 * c] = static_cast<int8_t>(fminf(fmaxf(o, -127.f), 127.f));
    }
    __syncwarp();  // p is rewritten by the next row
  }
}

template <int DH, bool CLS>
cudaError_t launch(const void* qkv, const void* deq, const void* qks, const void* o_inv,
                   const void* qk_m2, void* out, int batch, int seq, int heads, int kv_len,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(seq, DH);
  cudaError_t err = cudaFuncSetAttribute(q3i_kernel<DH, CLS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(CLS ? 1 : (seq + kRows - 1) / kRows, heads, batch);
  q3i_kernel<DH, CLS><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(deq),
      static_cast<const float*>(qks), static_cast<const float*>(o_inv),
      static_cast<const float*>(qk_m2), static_cast<int8_t*>(out), seq, heads, kv_len, causal);
  return cudaGetLastError();
}

template <bool CLS>
int launch_dh(const void* qkv, const void* deq, const void* qks, const void* o_inv,
              const void* qk_m2, void* out, int batch, int seq, int heads, int dh, int kv_len,
              int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32, CLS>(qkv, deq, qks, o_inv, qk_m2, out, batch, seq, heads, kv_len, causal, s);
    case 64:
      return launch<64, CLS>(qkv, deq, qks, o_inv, qk_m2, out, batch, seq, heads, kv_len, causal, s);
    case 128:
      return launch<128, CLS>(qkv, deq, qks, o_inv, qk_m2, out, batch, seq, heads, kv_len, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" size_t team_mha_packed_q3i_smem_bytes(int seq, int dh) { return smem_bytes(seq, dh); }

// Pointers are device pointers: qkv int8 [B, S, 3*D]; deq float [3*D]; qk_scale
// float [H]; o_inv float [D]; qk_m2 float [H] or NULL for the row-max softmax;
// out int8 [B, S, D]. Returns the cudaError_t of the launch (0 on success).
extern "C" int team_mha_packed_q3i_fwd(const void* qkv, const void* deq, const void* qk_scale,
                                       const void* o_inv, const void* qk_m2, void* out, int batch,
                                       int seq, int heads, int dh, int kv_len, int causal,
                                       void* stream) {
  return launch_dh<false>(qkv, deq, qk_scale, o_inv, qk_m2, out, batch, seq, heads, dh, kv_len,
                          causal, stream);
}

// The CLS query only: out int8 [B, 1, D], non-causal, every key.
extern "C" int team_mha_packed_q3i_cls_fwd(const void* qkv, const void* deq, const void* qk_scale,
                                           const void* o_inv, const void* qk_m2, void* out,
                                           int batch, int seq, int heads, int dh, void* stream) {
  return launch_dh<true>(qkv, deq, qk_scale, o_inv, qk_m2, out, batch, seq, heads, dh, seq, 0,
                         stream);
}
