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
//     exponential (attend_rows' DEFER and BF16_EXP switches, off for the
//     other entries, whose instantiations are unchanged).
// All are one kernel over a strided [B, H, S, Dh] view: the packed layout is
// (batch, head, row) strides (S*3D, Dh, 3D) with k and v at +D and +2D, the
// head split the same with q, k and v offset by the rank's r*D/nm columns
// (its heads are read in place, no copy), the pre-split one the tensor's own
// strides. The numerics are the TPU kernels':
//   q = round_to_input_dtype(q * dh^-0.5); logits = q.k in f32;
//   f32 row-max softmax, normalised before PV;
//   p = round_to_input_dtype(p); out = p.v accumulated in f32, stored in the
//   input dtype (attend_rows in attention_common.cuh).
//
// Layout: one block per (query tile of kRows rows, head, sample). The block
// stages that head's K and V rows into shared memory (row stride padded so
// that lanes reading different keys hit different banks), then each warp
// takes every kWarps-th query row of the tile.
//
// What bounds it on an H100: this first version runs on the CUDA cores, so
// the bound is the FMA rate of the two products, about 4*S^2*dh flops per
// (sample, head) -- 15 GFLOP per vision layer at B=128, S=197, H=12, dh=64 --
// fed from shared memory at about two loads per FMA. The design keeps q in
// registers, reads K two bf16 at a time, skips the causal upper triangle, and
// keeps the logits out of device memory (a per-warp row buffer in shared
// memory). Moving the products onto the tensor cores (mma/wgmma) is the next
// step.

#include "attention_common.cuh"

namespace {

constexpr int kRows = 64;  // query rows per block

// element strides of a [B, H, S, Dh] view
struct Strides {
  long long batch, head, row;
};

template <typename T>
size_t smem_bytes(int seq, int dh) {
  return kv_bytes<T>(seq, dh) + row_buffer_bytes(seq, dh);
}

template <typename T, int DH, bool DEFER = false, bool BF16_EXP = false>
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
  attend_rows<T, DH, DEFER, BF16_EXP>(q + off, in.row, k_s, v_s, ks, row0 + warp, row_end, kWarps, n_keys, causal,
                     scale, p_all + warp * seq, q_all + warp * DH,
                     out + b * os.batch + h * os.head, os.row, 0);
}

template <typename T, int DH, bool DEFER, bool BF16_EXP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, Strides in,
                   Strides os, int batch, int seq, int heads, int kv_len, int causal, float scale,
                   cudaStream_t stream) {
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

template <typename T, bool DEFER, bool BF16_EXP>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out, Strides in,
                      Strides os, int batch, int seq, int heads, int dh, int kv_len, int causal,
                      float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32, DEFER, BF16_EXP>(q, k, v, out, in, os, batch, seq, heads, kv_len, causal, scale, stream);
    case 64: return launch<T, 64, DEFER, BF16_EXP>(q, k, v, out, in, os, batch, seq, heads, kv_len, causal, scale, stream);
    case 128: return launch<T, 128, DEFER, BF16_EXP>(q, k, v, out, in, os, batch, seq, heads, kv_len, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// DEFER and BF16_EXP: the v2 softmax switches of attend_rows (off: _mha_kernel's)
template <bool DEFER = false, bool BF16_EXP = false>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, void* out,
                         Strides in, Strides os, int batch, int seq, int heads, int dh,
                         int kv_len, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float, DEFER, BF16_EXP>(q, k, v, out, in, os, batch, seq, heads, dh, kv_len, causal, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16, DEFER, BF16_EXP>(q, k, v, out, in, os, batch, seq, heads, dh, kv_len, causal,
                                    scale, s);
  return cudaErrorInvalidValue;
}

size_t element_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the codes of team_tpu_torch/ops/mha_short.py)
extern "C" size_t team_mha_packed_smem_bytes(int dtype, int seq, int dh) {
  return dtype == 1 ? smem_bytes<__nv_bfloat16>(seq, dh) : smem_bytes<float>(seq, dh);
}

// Packed [B, S, 3*D] -> [B, S, D]. Returns the cudaError_t of the launch (0 on success).
extern "C" int team_mha_packed_fwd(const void* qkv, void* out, int dtype, int batch, int seq,
                                   int heads, int dh, int kv_len, int causal, float scale,
                                   void* stream) {
  const long long d_model = static_cast<long long>(heads) * dh;
  const char* base = static_cast<const char*>(qkv);
  const size_t e = element_bytes(dtype);
  return launch_dtype(dtype, base, base + d_model * e, base + 2 * d_model * e, out,
                      {seq * 3 * d_model, dh, 3 * d_model}, {seq * d_model, dh, d_model}, batch,
                      seq, heads, dh, kv_len, causal, scale, stream);
}

// Pre-split q, k, v [B, H, S, Dh], each with the element strides (sb, sh, sr)
// and a unit stride along Dh, -> out [B, H, S, Dh] contiguous; non-causal.
extern "C" int team_mha_short_fwd(const void* q, const void* k, const void* v, void* out,
                                  int dtype, int batch, int heads, int seq, int dh, long long sb,
                                  long long sh, long long sr, int kv_len, float scale,
                                  void* stream) {
  return launch_dtype(dtype, q, k, v, out, {sb, sh, sr},
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
    return launch_dtype<true, true>(dtype, q, k, v, out, {sb, sh, sr}, os, batch, seq, heads, dh,
                                    kv_len, 0, scale, stream);
  return launch_dtype<true, false>(dtype, q, k, v, out, {sb, sh, sr}, os, batch, seq, heads, dh,
                                   kv_len, 0, scale, stream);
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
  return launch_dtype(dtype, base, base + d_model * e, base + 2 * d_model * e, out,
                      {seq * 3 * d_model, dh, 3 * d_model}, {seq * d_local, dh, d_local}, batch,
                      seq, heads_local, dh, kv_len, causal, scale, stream);
}
