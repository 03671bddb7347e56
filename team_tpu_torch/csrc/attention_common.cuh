// Device helpers shared by the attention sources of this directory
// (mha_packed.cu, attn_block.cu), for Hopper (sm_90a):
//   - conversions with the TPU kernels' roundings to the input dtype;
//   - warp reductions;
//   - the padded shared-memory layout of one head's K and V, and its staging;
//   - one warp's attention over query rows against K/V in shared memory
//     (the arithmetic of the TPU kernels _mha_kernel, _mha_packed_kernel,
//     _mha_packed_proj_kernel and _attn_block_kernel in
//     team_tpu/ops/mha_short.py);
//   - a tile GEMM on the CUDA cores, [R, K] from shared memory times a
//     [K, N] weight streamed through shared memory in k-slices, f32
//     accumulation, for the fused out-projection and qkv products.
//
// Nothing here allocates or launches: each kernel source includes it and
// builds its kernels from these pieces. The sources are compiled on their
// own (one nvcc each), so the helpers live in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the TPU kernels' casts of q and p back to the input dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

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

template <int DH>
__device__ __forceinline__ float dot_row(const float (&q)[DH], const float* k) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc = fmaf(q[d], k[d], acc);
  return acc;
}

template <int DH>
__device__ __forceinline__ float dot_row(const float (&q)[DH], const __nv_bfloat16* k) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k);
  float acc = 0.f;
#pragma unroll
  for (int d2 = 0; d2 < DH / 2; ++d2) {
    const float2 kf = __bfloat1622float2(k2[d2]);
    acc = fmaf(q[2 * d2], kf.x, acc);
    acc = fmaf(q[2 * d2 + 1], kf.y, acc);
  }
  return acc;
}

// padded shared-memory row stride of K and V, in elements (keeps rows 4-byte
// aligned and puts neighbouring keys in different banks)
template <typename T>
__host__ __device__ constexpr int kv_stride(int dh) { return dh + (sizeof(T) == 2 ? 2 : 1); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// bytes of one head's K and V staged for `seq` keys
template <typename T>
__host__ __device__ size_t kv_bytes(int seq, int dh) {
  return align16(2 * static_cast<size_t>(seq) * kv_stride<T>(dh) * sizeof(T));
}

// bytes of the per-warp softmax row and scaled-q buffers
__host__ __device__ inline size_t row_buffer_bytes(int seq, int dh) {
  return static_cast<size_t>(kWarps) * (seq + dh) * sizeof(float);
}

// Copy rows [0, n) of one head's K and V (row stride `row_stride` elements)
// into shared memory with the padded stride ks. The whole block takes part.
template <typename T>
__device__ __forceinline__ void stage_kv(const T* k, const T* v, long long row_stride, int n,
                                         int dh, T* k_s, T* v_s, int ks) {
  for (int idx = threadIdx.x; idx < n * dh; idx += blockDim.x) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    k_s[r * ks + d] = k[r * row_stride + d];
    v_s[r * ks + d] = v[r * row_stride + d];
  }
}

// One warp's attention over the query rows i = first, first + step, ... < end
// of one head: q_i is read from q + i*q_row; K and V are staged in k_s/v_s
// (n_keys rows, stride ks); round(out_i) goes to dst + (i - dst_row0)*dst_row.
//   q = round(q * scale); logits = q.k in f32; causal rows see keys <= i;
//   f32 row-max softmax normalised before PV; p = round(p);
//   out = p.v accumulated in f32.
// Masked keys are skipped rather than set to -1e30: exp(-1e30 - max) is 0 in
// f32, so both give the same sums while every row keeps one key. Lanes split
// the keys for q.k, the row max and sum are warp shuffles, and for p.v the
// lanes split the head dimension. p and q_sh are this warp's buffers
// (n_keys and DH floats).
// Two switches, off by default (the kernels above), give _mha_kernel_v2's
// softmax: DEFER keeps p unnormalised, rounds it to the input dtype for PV
// and divides the f32 output by the row sum instead (out = (sum_j p_j v_j) /
// sum_j p_j); BF16_EXP takes the exponential of a bfloat16 argument as XLA
// computes exp_dtype=bfloat16 on the CPU: p = exp(bf16(logit - max)), the
// result kept in f32 (XLA's excess precision elides its rounding to bf16
// before the f32 row sum; p is rounded to the input dtype for PV).
template <typename T, int DH, bool DEFER = false, bool BF16_EXP = false>
__device__ __forceinline__ void attend_rows(const T* q, long long q_row, const T* k_s,
                                            const T* v_s, int ks, int first, int end, int step,
                                            int n_keys, int causal, float scale, float* p,
                                            float* q_sh, T* dst, long long dst_row, int dst_row0) {
  constexpr int kPerLane = DH / 32;
  const int lane = threadIdx.x & 31;
  for (int i = first; i < end; i += step) {
    const T* q_src = q + i * q_row;
    for (int d = lane; d < DH; d += 32) q_sh[d] = round_to<T>(to_float(q_src[d]) * scale);
    __syncwarp();
    float qr[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = q_sh[d];

    const int nk = causal ? min(n_keys, i + 1) : n_keys;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nk; j += 32) {
      const float s = dot_row<DH>(qr, k_s + j * ks);
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      float e;
      if constexpr (BF16_EXP) {
        e = expf(round_to<__nv_bfloat16>(p[j] - m));
      } else {
        e = expf(p[j] - m);
      }
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < nk; j += 32) {
      if constexpr (DEFER) {
        p[j] = round_to<T>(p[j]);
      } else {
        p[j] = round_to<T>(p[j] / l);
      }
    }
    __syncwarp();

    float acc[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) acc[c] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float pj = p[j];
      const T* v_row = v_s + j * ks;
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) acc[c] = fmaf(pj, to_float(v_row[lane + 32 * c]), acc[c]);
    }
    T* out = dst + (i - dst_row0) * dst_row;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      if constexpr (DEFER) {
        out[lane + 32 * c] = from_float<T>(__fdiv_rn(acc[c], l));
      } else {
        out[lane + 32 * c] = from_float<T>(acc[c]);
      }
    }
    __syncwarp();  // q_sh and p are rewritten by the next row
  }
}

// ---------------------------------------------------------------------------
// tile GEMM on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kGemmNc = 128;                 // output columns per pass
constexpr int kGemmKt = 32;                  // depth of one k-slice of the weight
constexpr int kGemmTx = 16;                  // threads across a pass; each owns 8 adjacent columns
constexpr int kGemmTy = kThreads / kGemmTx;  // threads down the rows; each owns rows ty + 16*i

// padded row stride, in elements, of an activation tile in shared memory:
// even (for the two-wide k reads) and off a multiple of 32 words
__host__ __device__ constexpr int tile_stride(int width) { return width + 2; }

template <typename T>
__host__ __device__ constexpr size_t gemm_slice_bytes() {
  return static_cast<size_t>(kGemmKt) * kGemmNc * sizeof(T);
}

// 8 adjacent values of shared memory as floats (16-byte aligned)
__device__ __forceinline__ void load8(const float* s, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* s, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// two k-adjacent values of a tile row
__device__ __forceinline__ float2 load2(const float* s) { return *reinterpret_cast<const float2*>(s); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* s) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
}

// out[r, n] for r < R and n in [n_begin, n_end): sum over k < k_total of
// a_s[r, k] * w[k, n], accumulated in f32 in k order; epi(r, n, acc) finishes
// each output. a_s: the activation tile in shared memory (row stride lda, even);
// w: the weight in device memory, row-major [K, ldw]; w_s: kGemmKt x kGemmNc
// elements of shared memory for the weight's k-slices. k_total must be a
// multiple of kGemmKt and n_end - n_begin a multiple of 8. The whole block
// calls it; it synchronises before each slice it stages, so the caller's
// writes to a_s (and its last reads of what w_s overlays) come first.
template <typename T, int R, typename Epi>
__device__ __forceinline__ void tile_gemm(const T* a_s, int lda, const T* w, long long ldw,
                                          int k_total, int n_begin, int n_end, T* w_s, Epi epi) {
  static_assert(R % kGemmTy == 0, "tile rows must be a multiple of 16");
  constexpr int TM = R / kGemmTy;
  const int tx = threadIdx.x % kGemmTx;
  const int ty = threadIdx.x / kGemmTx;
  for (int n0 = n_begin; n0 < n_end; n0 += kGemmNc) {
    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < k_total; k0 += kGemmKt) {
      __syncthreads();  // every thread is done with what w_s held
      for (int idx = threadIdx.x; idx < kGemmKt * kGemmNc; idx += kThreads) {
        const int kk = idx / kGemmNc;
        const int col = n0 + idx - kk * kGemmNc;
        w_s[idx] = col < n_end ? w[(k0 + kk) * ldw + col] : from_float<T>(0.f);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kGemmKt; kk += 2) {
        float b0[8], b1[8];
        load8(w_s + kk * kGemmNc + tx * 8, b0);
        load8(w_s + (kk + 1) * kGemmNc + tx * 8, b1);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float2 a = load2(a_s + (ty + kGemmTy * i) * lda + k0 + kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a.x, b0[j], acc[i][j]);
            acc[i][j] = fmaf(a.y, b1[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx * 8 + j;
        if (col < n_end) epi(ty + kGemmTy * i, col, acc[i][j]);
      }
  }
}

}  // namespace
