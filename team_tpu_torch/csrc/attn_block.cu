// The fused attention sub-block for Hopper (sm_90a), forward only.
//
// Replaces two TPU kernels of team_tpu/ops/mha_short.py:
//   - _mha_packed_proj_kernel (entry fused_mha_packed_proj):
//       out = round(x + (attention(qkv) @ W_out + b_out))
//     over the packed qkv [B, S, 3*D], residual x [B, S, D];
//   - _attn_block_kernel (entry fused_attn_block):
//       qkv = round(LN(x) @ W_qkv + b_qkv); then the same as above.
// The numerics are the TPU kernels': the layer norm in f32 (two-pass mean
// and variance, (x - mean) * rsqrt(var + 1e-5) * g + b, rounded to the input
// dtype); each product accumulates in f32 and its f32 bias is added before
// the one rounding; each head's attention output is rounded to the input
// dtype before the out-projection (attend_rows in attention_common.cuh); the
// residual is added in f32 and the sum rounded once.
//
// Design. On the TPU one program holds a sample's whole qkv (197 x 2304 bf16,
// 908 KB) and both weights in VMEM. A Hopper block has 227 KB of shared
// memory, so the work is cut in two kernels:
//   ln_qkv_kernel: one block per tile of R rows of [B*S, D] and per third of
//     the 3*D output columns (q, k or v): the tile's rows are normalised into
//     shared memory, then multiplied by W_qkv streamed through shared memory
//     in 32-row k-slices (tile_gemm), bias added, rounded, and written to a
//     [B, S, 3*D] workspace in device memory (at B=128, S=197, D=768 that is
//     116 MB written and read again per layer, which the TPU design avoided);
//   mha_packed_proj_kernel: one block per (tile of R query rows, sample). For
//     each head it stages K and V in shared memory, as mha_packed.cu does,
//     and the warps leave that head's output rows in a shared tile [R, D];
//     then the tile times W_out (k-slices through the same shared memory
//     that held K and V), + b_out + x, one rounding.
// R is 64 rows in bf16 (o tile 98.5 KB + K/V 52 KB + row buffers 8 KB at
// D=768, S=197) and 32 in f32 (98.8 KB + 102 KB + 8 KB): the largest tile
// that fits 227 KB, since the out-projection's weight traffic per output
// falls as R grows.
//
// What bounds it on an H100: the products run on the CUDA cores (f32 FMA,
// 67 TFLOP/s peak), 2*S*D*3D + 4*S^2*D + 2*S*D^2 flops per sample -- 134
// GFLOP per vision layer at B=128 -- so operations, not the 82 MB of input
// and output, are the bound even at the tensor cores' rate. The tile GEMM
// keeps 32 (bf16) or 16 (f32) accumulators a thread and reads 8 weight
// columns with one 16-byte load per k. Tensor-core products (mma/wgmma) and
// one launch that keeps qkv on chip (thread-block clusters sharing their
// shared memory) are the next steps.

#include "attention_common.cuh"

namespace {

template <typename T>
struct Tile;  // query or row tile of each dtype
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int R = 64;
};
template <>
struct Tile<float> {
  static constexpr int R = 32;
};

template <typename T>
size_t proj_smem_bytes(int seq, int d_model, int dh) {
  const size_t kv = kv_bytes<T>(seq, dh);
  const size_t w = gemm_slice_bytes<T>();
  return align16(static_cast<size_t>(Tile<T>::R) * tile_stride(d_model) * sizeof(T)) +
         align16(kv > w ? kv : w) + row_buffer_bytes(seq, dh);
}

template <typename T>
size_t ln_qkv_smem_bytes(int d_model) {
  return align16(static_cast<size_t>(Tile<T>::R) * tile_stride(d_model) * sizeof(T)) +
         gemm_slice_bytes<T>();
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mha_packed_proj_kernel(const T* __restrict__ qkv, const T* __restrict__ w_out,
                       const float* __restrict__ b_out, const T* __restrict__ x,
                       T* __restrict__ out, int seq, int heads, int causal, float scale) {
  constexpr int R = Tile<T>::R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d_model = heads * DH;
  const int lda = tile_stride(d_model);
  const int ks = kv_stride<T>(DH);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int row_end = min(row0 + R, seq);
  const long long ld = 3LL * d_model;
  const T* base = qkv + b * seq * ld;

  T* o_s = reinterpret_cast<T*>(smem);
  unsigned char* shared = smem + align16(static_cast<size_t>(R) * lda * sizeof(T));
  T* k_s = reinterpret_cast<T*>(shared);  // K and V of one head, then the W_out slices
  T* v_s = k_s + static_cast<size_t>(seq) * ks;
  const size_t kv = kv_bytes<T>(seq, DH);
  float* p_all = reinterpret_cast<float*>(
      shared + align16(kv > gemm_slice_bytes<T>() ? kv : gemm_slice_bytes<T>()));
  float* q_all = p_all + kWarps * seq;

  // rows past the sequence's end take part in the product but are never stored
  for (int idx = (row_end - row0) * lda + threadIdx.x; idx < R * lda; idx += kThreads)
    o_s[idx] = from_float<T>(0.f);

  const int n_keys = causal ? row_end : seq;  // keys any row of this tile may attend
  const int warp = threadIdx.x >> 5;
  for (int h = 0; h < heads; ++h) {
    __syncthreads();  // every warp is done with the previous head's K and V
    stage_kv(base + d_model + h * DH, base + 2 * d_model + h * DH, ld, n_keys, DH, k_s, v_s, ks);
    __syncthreads();
    attend_rows<T, DH>(base + h * DH, ld, k_s, v_s, ks, row0 + warp, row_end, kWarps, n_keys,
                       causal, scale, p_all + warp * seq, q_all + warp * DH, o_s + h * DH, lda,
                       row0);
  }

  // out-projection and residual (tile_gemm synchronises before it reuses K/V's memory)
  const long long out_row0 = static_cast<long long>(b) * seq + row0;
  tile_gemm<T, R>(o_s, lda, w_out, d_model, d_model, 0, d_model, k_s,
                  [&](int r, int col, float acc) {
                    if (row0 + r >= seq) return;
                    const long long o = (out_row0 + r) * d_model + col;
                    out[o] = from_float<T>(__fadd_rn(to_float(x[o]), __fadd_rn(acc, b_out[col])));
                  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
              const float* __restrict__ ln_b, const T* __restrict__ w_qkv,
              const float* __restrict__ b_qkv, T* __restrict__ qkv, int rows, int d_model) {
  constexpr int R = Tile<T>::R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = tile_stride(d_model);
  T* h_s = reinterpret_cast<T*>(smem);
  T* w_s = reinterpret_cast<T*>(smem + align16(static_cast<size_t>(R) * lda * sizeof(T)));
  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float n = static_cast<float>(d_model);

  // layer norm of the tile's rows, one warp a row: the raw row is copied into
  // the tile, the statistics read it there, and the normalised values replace it
  for (int r = warp; r < R; r += kWarps) {
    T* hr = h_s + r * lda;
    const int i = row0 + r;
    if (i >= rows) {
      for (int d = lane; d < d_model; d += 32) hr[d] = from_float<T>(0.f);
      continue;
    }
    const T* xr = x + static_cast<long long>(i) * d_model;
    float s = 0.f;
    for (int d = lane; d < d_model; d += 32) {
      const T xv = xr[d];
      hr[d] = xv;
      s += to_float(xv);
    }
    const float mean = __fdiv_rn(warp_sum(s), n);
    float ss = 0.f;
    for (int d = lane; d < d_model; d += 32) {
      const float c = __fsub_rn(to_float(hr[d]), mean);
      ss = __fadd_rn(ss, __fmul_rn(c, c));
    }
    const float var = __fdiv_rn(warp_sum(ss), n);
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    for (int d = lane; d < d_model; d += 32) {
      const float y = __fmul_rn(__fsub_rn(to_float(hr[d]), mean), rstd);
      hr[d] = from_float<T>(__fadd_rn(__fmul_rn(y, ln_g[d]), ln_b[d]));
    }
  }

  // the tile times this block's third of W_qkv, + b_qkv, one rounding
  const int n_begin = blockIdx.y * d_model;
  const long long ld = 3LL * d_model;
  tile_gemm<T, R>(h_s, lda, w_qkv, ld, d_model, n_begin, n_begin + d_model, w_s,
                  [&](int r, int col, float acc) {
                    if (row0 + r >= rows) return;
                    qkv[(static_cast<long long>(row0) + r) * ld + col] =
                        from_float<T>(__fadd_rn(acc, b_qkv[col]));
                  });
}

template <typename T, int DH>
cudaError_t launch_proj(const void* qkv, const void* w_out, const float* b_out, const void* x,
                        void* out, int batch, int seq, int heads, int causal, float scale,
                        cudaStream_t stream) {
  const size_t smem = proj_smem_bytes<T>(seq, heads * DH, DH);
  cudaError_t err = cudaFuncSetAttribute(mha_packed_proj_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + Tile<T>::R - 1) / Tile<T>::R, batch);
  mha_packed_proj_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(w_out), b_out, static_cast<const T*>(x),
      static_cast<T*>(out), seq, heads, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_proj_dh(const void* qkv, const void* w_out, const float* b_out, const void* x,
                           void* out, int batch, int seq, int heads, int dh, int causal,
                           float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_proj<T, 32>(qkv, w_out, b_out, x, out, batch, seq, heads, causal, scale, stream);
    case 64: return launch_proj<T, 64>(qkv, w_out, b_out, x, out, batch, seq, heads, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_ln_qkv(const void* x, const float* ln_g, const float* ln_b, const void* w_qkv,
                          const float* b_qkv, void* qkv, int rows, int d_model,
                          cudaStream_t stream) {
  const size_t smem = ln_qkv_smem_bytes<T>(d_model);
  cudaError_t err = cudaFuncSetAttribute(ln_qkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + Tile<T>::R - 1) / Tile<T>::R, 3);
  ln_qkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ln_g, ln_b, static_cast<const T*>(w_qkv), b_qkv,
      static_cast<T*>(qkv), rows, d_model);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the codes of team_tpu_torch/ops/mha_short.py).
// Shared memory of one block: kernel 0 = attention + out-projection, 1 = layer norm + qkv.
extern "C" size_t team_attn_block_smem_bytes(int kernel, int dtype, int seq, int d_model, int dh) {
  if (kernel == 0)
    return dtype == 1 ? proj_smem_bytes<__nv_bfloat16>(seq, d_model, dh)
                      : proj_smem_bytes<float>(seq, d_model, dh);
  return dtype == 1 ? ln_qkv_smem_bytes<__nv_bfloat16>(d_model) : ln_qkv_smem_bytes<float>(d_model);
}

// qkv [B, S, 3*D], w_out [D, D] (input dtype), b_out [D] f32, x [B, S, D] -> out [B, S, D].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int team_mha_packed_proj_fwd(const void* qkv, const void* w_out, const void* b_out,
                                        const void* x, void* out, int dtype, int batch, int seq,
                                        int heads, int dh, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b_out);
  if (dtype == 0)
    return launch_proj_dh<float>(qkv, w_out, bias, x, out, batch, seq, heads, dh, causal, scale, s);
  if (dtype == 1)
    return launch_proj_dh<__nv_bfloat16>(qkv, w_out, bias, x, out, batch, seq, heads, dh, causal,
                                         scale, s);
  return cudaErrorInvalidValue;
}

// x [rows, D], ln_g/ln_b [D] f32, w_qkv [D, 3*D] (input dtype), b_qkv [3*D] f32 -> qkv [rows, 3*D].
extern "C" int team_ln_qkv_fwd(const void* x, const void* ln_g, const void* ln_b,
                               const void* w_qkv, const void* b_qkv, void* qkv, int dtype,
                               int rows, int d_model, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* bl = static_cast<const float*>(ln_b);
  const float* bq = static_cast<const float*>(b_qkv);
  if (dtype == 0) return launch_ln_qkv<float>(x, g, bl, w_qkv, bq, qkv, rows, d_model, s);
  if (dtype == 1) return launch_ln_qkv<__nv_bfloat16>(x, g, bl, w_qkv, bq, qkv, rows, d_model, s);
  return cudaErrorInvalidValue;
}
