// int8-in / int8-out packed attention of the int8 static-W8A8 tier, for
// Hopper (sm_90a), forward only.
//
// Replaces two TPU kernels of team_tpu/ops/mha_short.py:
//   _mha_packed_q_kernel  (entry fused_mha_packed_q,  :308) -> team_mha_packed_q_fwd
//   _mha_packed_q3_kernel (entry fused_mha_packed_q3, :395) -> team_mha_packed_q3_fwd
// Both read the packed qkv [B*S, 3*D] (or [B, S, 3*D]: the same rows) as the
// qkv GEMM's static requantize wrote it, with one dequant scale per channel,
// and write int8 [B*S, D] requantized with the out-projection's scales. They
// differ only in the dequant, which the template switch kBf16Deq keeps apart:
//   f32 (q):  q = bf16((float(q8) * deq) * dh^-0.5), k, v = bf16(float(x8) * deq);
//   bf16 (q3): k, v = bf16(float(x8) * bf16(deq)), q = bf16(float(q8) *
//             bf16(deq * dh^-0.5)) -- a bf16 product of two bf16 values, which
//             an f32 product holds exactly and one rounding gives.
// From there both are the bf16 packed attention: q.k with bf16 operands in
// f32, causal and kv_len masks, an f32 row-max softmax normalised before PV
// (p = bf16(e / l)), p.v in f32, then out * o_inv rounded half to even
// (rint) and clipped to +-127. Every product the TPU kernel rounds on its
// own is rounded on its own here (__fmul_rn). Masked keys are skipped
// rather than set to -1e30: exp(-1e30 - max) is 0 in f32, so the sums are
// the same while every row keeps a key (the wrapper checks kv_len >= 1).
//
// Layout: one block per (query tile of kRows rows, head, sample), as in
// mha_packed.cu. The block reads that head's K and V slices of the int8 rows
// (four bytes a load), dequantizes them and stages them in shared memory as
// bf16 (50 KB at S=197, dh=64; rows padded by one 32-bit word so that lanes
// reading different keys hit different banks). Each warp takes every
// kWarps-th query row of the tile: it dequantizes q into registers, lanes
// split the keys for q.k, the row max and sum are warp shuffles, and for p.v
// the lanes split the head dimension. The row stride of the packed input is
// an argument, so the 2-D and the 3-D entry share the code.
//
// What bounds it on an H100: the bytes of the function are 58.1 MB of int8
// qkv in and 19.4 MB of int8 out per vision layer at B=128, S=197, D=768
// (0.0231 ms at 3.35 TB/s, against 0.0154 ms for its 15.26 GFLOP at the
// bf16 tensor-core rate). Reading int8 halves the bytes of the bf16 packed
// kernel, but this first version runs both products on the CUDA cores, at
// about two shared-memory loads per FMA, and that is its bound; moving q.k
// and p.v onto the bf16 tensor cores (mma.sync, then wgmma) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 64;  // query rows per block
constexpr int kDh = 64;    // the compiled head width (ViT-B/16)
constexpr int kStride = kDh + 2;  // padded shared-memory row of K and V, in bf16

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

__host__ __device__ size_t smem_bytes(int seq) {
  return align16(2 * static_cast<size_t>(seq) * kStride * sizeof(__nv_bfloat16)) +
         static_cast<size_t>(kWarps) * (seq + kDh) * sizeof(float);
}

// the dequant scale of K or V at packed column col
template <bool kBf16Deq>
__device__ __forceinline__ float kv_scale(const float* deq, int col) {
  return kBf16Deq ? bf16_round(deq[col]) : deq[col];
}

// q8 -> the bf16 value the TPU kernel feeds to its q.k dot (scale = dh^-0.5)
template <bool kBf16Deq>
__device__ __forceinline__ float dequant_q(int8_t q8, float deq, float scale) {
  const float x = static_cast<float>(q8);
  if (kBf16Deq) return bf16_round(__fmul_rn(x, bf16_round(__fmul_rn(deq, scale))));
  return bf16_round(__fmul_rn(__fmul_rn(x, deq), scale));
}

template <bool kBf16Deq>
__global__ void __launch_bounds__(kWarps * 32)
mha_q_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ deq,
             const float* __restrict__ o_inv, int8_t* __restrict__ out, int seq, int heads,
             int ld, int kv_len, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kWords = kDh / 4;  // 32-bit words of one head row of int8
  constexpr int kPerLane = kDh / 32;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int row_end = min(row0 + kRows, seq);
  const int d_model = heads * kDh;
  const int8_t* base = qkv + static_cast<size_t>(b) * seq * ld;

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + static_cast<size_t>(seq) * kStride;
  float* p_all = reinterpret_cast<float*>(
      smem + align16(2 * static_cast<size_t>(seq) * kStride * sizeof(__nv_bfloat16)));
  float* q_all = p_all + kWarps * seq;

  // keys any row of this tile may attend, dequantized into shared memory
  int n_keys = min(kv_len, seq);
  if (causal) n_keys = min(n_keys, row_end);
  for (int idx = threadIdx.x; idx < n_keys * kWords; idx += blockDim.x) {
    const int r = idx / kWords;
    const int w = idx - r * kWords;
    const int8_t* row = base + static_cast<size_t>(r) * ld;
    const int kcol = d_model + h * kDh + 4 * w;
    const int vcol = 2 * d_model + h * kDh + 4 * w;
    const char4 k4 = *reinterpret_cast<const char4*>(row + kcol);
    const char4 v4 = *reinterpret_cast<const char4*>(row + vcol);
    const int8_t kb[4] = {k4.x, k4.y, k4.z, k4.w};
    const int8_t vb[4] = {v4.x, v4.y, v4.z, v4.w};
    __nv_bfloat16* kd = k_s + r * kStride + 4 * w;
    __nv_bfloat16* vd = v_s + r * kStride + 4 * w;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      kd[t] = __float2bfloat16_rn(__fmul_rn(static_cast<float>(kb[t]), kv_scale<kBf16Deq>(deq, kcol + t)));
      vd[t] = __float2bfloat16_rn(__fmul_rn(static_cast<float>(vb[t]), kv_scale<kBf16Deq>(deq, vcol + t)));
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* p = p_all + warp * seq;
  float* q_sh = q_all + warp * kDh;
  float q_deq[kPerLane], o_scale[kPerLane];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int col = h * kDh + lane + 32 * c;
    q_deq[c] = deq[col];
    o_scale[c] = o_inv[col];
  }

  for (int i = row0 + warp; i < row_end; i += kWarps) {
    const int8_t* q_src = base + static_cast<size_t>(i) * ld + h * kDh;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c)
      q_sh[lane + 32 * c] = dequant_q<kBf16Deq>(q_src[lane + 32 * c], q_deq[c], scale);
    __syncwarp();
    float q[kDh];
#pragma unroll
    for (int d = 0; d < kDh; ++d) q[d] = q_sh[d];

    const int nk = causal ? min(n_keys, i + 1) : n_keys;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nk; j += 32) {
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k_s + j * kStride);
      float s = 0.f;
#pragma unroll
      for (int d2 = 0; d2 < kDh / 2; ++d2) {
        const float2 kf = __bfloat1622float2(k2[d2]);
        s = fmaf(q[2 * d2], kf.x, s);
        s = fmaf(q[2 * d2 + 1], kf.y, s);
      }
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(__fsub_rn(p[j], m));
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < nk; j += 32) p[j] = bf16_round(__fdiv_rn(p[j], l));
    __syncwarp();

    float acc[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) acc[c] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float pj = p[j];
      const __nv_bfloat16* v_row = v_s + j * kStride;
#pragma unroll
      for (int c = 0; c < kPerLane; ++c)
        acc[c] = fmaf(pj, __bfloat162float(v_row[lane + 32 * c]), acc[c]);
    }
    int8_t* dst = out + (static_cast<size_t>(b) * seq + i) * d_model + h * kDh;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const float o = rintf(__fmul_rn(acc[c], o_scale[c]));
      dst[lane + 32 * c] = static_cast<int8_t>(fminf(fmaxf(o, -127.f), 127.f));
    }
    __syncwarp();  // q_sh and p are rewritten by the next row
  }
}

template <bool kBf16Deq>
int launch(const void* qkv, const void* deq, const void* o_inv, void* out, int batch, int seq,
           int heads, int dh, int ld, int kv_len, int causal, void* stream) {
  if (dh != kDh || batch < 0 || seq < 1 || heads < 1 || ld < 3 * heads * kDh || ld % 4 ||
      kv_len < 1)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const size_t smem = smem_bytes(seq);
  cudaError_t err = cudaFuncSetAttribute(mha_q_kernel<kBf16Deq>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  mha_q_kernel<kBf16Deq><<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(deq),
      static_cast<const float*>(o_inv), static_cast<int8_t*>(out), seq, heads, ld, kv_len,
      causal, 1.0f / sqrtf(static_cast<float>(kDh)));
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t team_mha_packed_q_smem_bytes(int seq) { return smem_bytes(seq); }

// Pointers are device pointers: qkv int8 rows of 3*D values, ld bytes apart
// (ld a multiple of 4, the pointer 4-byte aligned), batch*seq of them; deq
// float [3*D]; o_inv float [D]; out int8 [batch*seq, D]. dh must be 64.
// Returns the cudaError_t of the launch (0 on success). f32 dequant:
extern "C" int team_mha_packed_q_fwd(const void* qkv, const void* deq, const void* o_inv,
                                     void* out, int batch, int seq, int heads, int dh, int ld,
                                     int kv_len, int causal, void* stream) {
  return launch<false>(qkv, deq, o_inv, out, batch, seq, heads, dh, ld, kv_len, causal, stream);
}

// The same with the bf16 dequant of fused_mha_packed_q3.
extern "C" int team_mha_packed_q3_fwd(const void* qkv, const void* deq, const void* o_inv,
                                      void* out, int batch, int seq, int heads, int dh, int ld,
                                      int kv_len, int causal, void* stream) {
  return launch<true>(qkv, deq, o_inv, out, batch, seq, heads, dh, ld, kv_len, causal, stream);
}
