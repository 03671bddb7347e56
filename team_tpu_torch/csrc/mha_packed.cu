// Packed multi-head attention for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel team_tpu/ops/mha_short.py:_mha_packed_kernel (entry
// fused_mha_packed). It reads the packed qkv projection [B, S, 3*D] as the
// qkv GEMM wrote it and writes [B, S, D], with the same numerics:
//   q = round_to_input_dtype(q * dh^-0.5); logits = q.k in f32;
//   optional causal mask and key mask (keys >= kv_len);
//   f32 row-max softmax, normalised before PV;
//   p = round_to_input_dtype(p); out = p.v accumulated in f32, stored in the
//   input dtype.
// Masked keys are skipped rather than set to -1e30: exp(-1e30 - max) is 0 in
// f32, so both give the same sums as long as every row keeps one key
// (kv_len >= 1, which the wrapper checks).
//
// Layout: one block per (query tile of kRows rows, head, sample). The block
// stages that head's K and V slices of the packed rows into shared memory
// (row stride padded by 4 bytes so that lanes reading different keys hit
// different banks), then each warp takes every kWarps-th query row of the
// tile: lanes split the keys for q.k, the row max and sum are warp shuffles,
// and for p.v the lanes split the head dimension.
//
// What bounds it on an H100: this first version runs on the CUDA cores, so
// the bound is the FMA rate of the two products, about 4*S^2*dh flops per
// (sample, head) -- 15 GFLOP per vision layer at B=128, S=197, H=12, dh=64 --
// fed from shared memory at about two loads per FMA. The design keeps q in
// registers, reads K two bf16 at a time, skips the causal upper triangle, and
// keeps the logits out of device memory (a per-warp row buffer in shared
// memory). Moving the products onto the tensor cores (mma/wgmma) is the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 64;  // query rows per block

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

// the TPU kernel's casts of q and p back to the input dtype
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

// padded shared-memory row stride of K and V, in elements (keeps rows 4-byte aligned)
template <typename T>
__host__ __device__ constexpr int kv_stride(int dh) { return dh + (sizeof(T) == 2 ? 2 : 1); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

template <typename T>
__host__ __device__ size_t smem_bytes(int seq, int dh) {
  return align16(2 * static_cast<size_t>(seq) * kv_stride<T>(dh) * sizeof(T)) +
         static_cast<size_t>(kWarps) * (seq + dh) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
mha_packed_kernel(const T* __restrict__ qkv, T* __restrict__ out, int seq, int heads,
                  int kv_len, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPerLane = DH / 32;
  const int ks = kv_stride<T>(DH);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int row_end = min(row0 + kRows, seq);
  const int d_model = heads * DH;
  const size_t ld = 3 * static_cast<size_t>(d_model);  // packed row stride
  const T* base = qkv + static_cast<size_t>(b) * seq * ld + h * DH;

  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + static_cast<size_t>(seq) * ks;
  float* p_all = reinterpret_cast<float*>(smem + align16(2 * static_cast<size_t>(seq) * ks * sizeof(T)));
  float* q_all = p_all + kWarps * seq;

  // keys any row of this tile may attend
  int n_keys = min(kv_len, seq);
  if (causal) n_keys = min(n_keys, row_end);
  for (int idx = threadIdx.x; idx < n_keys * DH; idx += blockDim.x) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const T* src = base + r * ld + d;
    k_s[r * ks + d] = src[d_model];
    v_s[r * ks + d] = src[2 * d_model];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* p = p_all + warp * seq;
  float* q_sh = q_all + warp * DH;

  for (int i = row0 + warp; i < row_end; i += kWarps) {
    const T* q_src = base + i * ld;
    for (int d = lane; d < DH; d += 32) q_sh[d] = round_to<T>(to_float(q_src[d]) * scale);
    __syncwarp();
    float q[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = q_sh[d];

    const int nk = causal ? min(n_keys, i + 1) : n_keys;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nk; j += 32) {
      const float s = dot_row<DH>(q, k_s + j * ks);
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < nk; j += 32) p[j] = round_to<T>(p[j] / l);
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
    T* dst = out + (static_cast<size_t>(b) * seq + i) * d_model + h * DH;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) dst[lane + 32 * c] = from_float<T>(acc[c]);
    __syncwarp();  // q_sh and p are rewritten by the next row
  }
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, void* out, int batch, int seq, int heads, int kv_len,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(seq, DH);
  cudaError_t err = cudaFuncSetAttribute(mha_packed_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  mha_packed_kernel<T, DH><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, heads, kv_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* qkv, void* out, int batch, int seq, int heads, int dh,
                      int kv_len, int causal, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(qkv, out, batch, seq, heads, kv_len, causal, scale, stream);
    case 64: return launch<T, 64>(qkv, out, batch, seq, heads, kv_len, causal, scale, stream);
    case 128: return launch<T, 128>(qkv, out, batch, seq, heads, kv_len, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the codes of team_tpu_torch/ops/mha_short.py)
extern "C" size_t team_mha_packed_smem_bytes(int dtype, int seq, int dh) {
  return dtype == 1 ? smem_bytes<__nv_bfloat16>(seq, dh) : smem_bytes<float>(seq, dh);
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int team_mha_packed_fwd(const void* qkv, void* out, int dtype, int batch, int seq,
                                   int heads, int dh, int kv_len, int causal, float scale,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(qkv, out, batch, seq, heads, dh, kv_len, causal, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(qkv, out, batch, seq, heads, dh, kv_len, causal, scale, s);
  return cudaErrorInvalidValue;
}
