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
//     other entries).
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
// Two kernels, by an explicit dispatch in the entries (launch below):
// float32, and #4's bfloat16, run on the CUDA cores (attend_rows of
// attention_common.cuh): one block per (query tile of kRows rows, head,
// sample) stages that head's K and V rows into shared memory (row stride
// padded so that lanes reading different keys hit different banks), then each
// warp takes every kWarps-th query row of the tile. team_tpu runs f32 at
// precision "highest", which the tensor cores' TF32 would not meet; #4's
// plain version pins its p = round(e) to logits summed in order over the head
// dimension, which attend_rows' sum repeats and the tensor cores' sums do not
// (PERF.md §6).
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
// What bounds it on an H100: about 4*S^2*dh flops per (sample, head) -- 15
// GFLOP per vision layer at B=128, S=197, H=12, dh=64 -- against 155 MB of
// q, k, v and out in bf16: the memory (0.046 ms at 3.35 TB/s) at the tensor
// cores' rate (0.015 ms at 989 TFLOP/s); the CUDA-core kernels the FMA rate.

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

// the launch of every entry, over strided q, k, v and out of a [B, H, S, Dh]
// view. dtype 0 (float32) takes the CUDA-core kernel; 1 (bfloat16) the
// tensor-core one, except with the v2 switches (DEFER, BF16_EXP): #4's
// bfloat16 keeps the CUDA-core kernel, whose f32 logits sum over the head
// dimension in order, as its plain version's matmul does, so p = round(e)
// rounds alike (the tensor cores' sums move ~0.07 % of its outputs by a p
// step: PERF.md)
template <bool DEFER = false, bool BF16_EXP = false>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out, Strides in,
                   Strides os, int batch, int seq, int heads, int dh, int kv_len, int causal,
                   float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cuda_core_dh<float, DEFER, BF16_EXP>(dh, q, k, v, out, in, os, batch, seq, heads,
                                                       kv_len, causal, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (DEFER) {
    return launch_cuda_core_dh<bf16, DEFER, BF16_EXP>(dh, q, k, v, out, in, os, batch, seq, heads,
                                                      kv_len, causal, scale, s);
  } else {
    return launch_tc_dh(dh, seq, kv_len, q, k, v, out, in, os, batch, seq, heads, kv_len, causal,
                        scale, s);
  }
}

size_t element_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the codes of team_tpu_torch/ops/mha_short.py);
// v2: 1 for the entry team_mha_short_v2_fwd, 0 for the others
extern "C" size_t team_mha_packed_smem_bytes(int dtype, int seq, int dh, int v2) {
  if (dtype == 0) return smem_bytes<float>(seq, dh);
  return v2 ? smem_bytes<bf16>(seq, dh) : smem_bytes_tc(seq, dh);
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
    return launch<true, true>(dtype, q, k, v, out, {sb, sh, sr}, os, batch, seq, heads, dh,
                              kv_len, 0, scale, stream);
  return launch<true, false>(dtype, q, k, v, out, {sb, sh, sr}, os, batch, seq, heads, dh, kv_len,
                             0, scale, stream);
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
