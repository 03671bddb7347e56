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
// Layout: one block of kTcWarps = 4 warps per
// (query tile of 64 rows, head, sample), as mha_packed.cu's tensor-core
// kernel. The block dequantizes that head's K and V rows while staging them:
// each thread loads 8 int8 values of a row (its 8 columns are fixed, so their
// scales stay in registers), rounds each product to bf16 as above and stores
// the 16 bytes into the swizzled tile that mma_attention::stage_rows_tc lays
// out (zero past the keys, to 16). Each warp dequantizes its 16 query rows
// with its form's rounding straight into the A fragments of mma.sync m16n8k16
// and runs mma_attention::WarpAttention on them: QK^T and PV on the bf16
// tensor cores with f32 sums, the logits of up to 16 * WIN keys in registers
// (WIN 8, 13 or 16 blocks from the keys), the f32 row max and sum over the
// quad, and p = bf16(e / l) before PV; its PV sums are then scaled by o_inv
// and requantized. K and V take 4 * pad16(S) * 64 bytes (S=197: 53 KB), so S
// reaches 896 (the CUDA-core kernel, 778). Only the order of the f32 sums of
// q.k, l and p.v differs from that kernel; every rounding is the same.
//
// What bounds it on an H100: the bytes of the function are 58.1 MB of int8
// qkv in and 19.4 MB of int8 out per vision layer at B=128, S=197, D=768
// (0.0231 ms at 3.35 TB/s), against 0.0154 ms for its 15.26 GFLOP at the
// bf16 tensor-core rate. mma.sync reaches about half that rate, and the
// per-logit work (exp, the max and sum, the divide and the bf16 round of p)
// runs on the CUDA cores, as in #1's kernel; each 64-row tile dequantizes its
// head's K and V again (four times a head at S=197), from L2 after the first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_attention;

constexpr int kDh = 64;  // the compiled head width (ViT-B/16)
constexpr int kTcWarps = kGroupWarps;  // 16 query rows each
constexpr int kTcRows = 16 * kTcWarps;
constexpr int kCpr = kDh / 8;  // 16-byte bf16 chunks of a K or V row

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the int8 value in byte i of w, as a float (exact)
__device__ __forceinline__ float s8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}

// K and V of one head, padded to 16 keys
__host__ __device__ size_t smem_bytes(int seq) {
  return 2 * static_cast<size_t>(pad16(seq)) * kDh * sizeof(bf16);
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

template <bool kBf16Deq, int WIN>
__global__ void __launch_bounds__(kTcWarps * 32)
mha_q_kernel_tc(const int8_t* __restrict__ qkv, const float* __restrict__ deq,
                const float* __restrict__ o_inv, int8_t* __restrict__ out, int seq, int heads,
                int ld, int kv_len, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int d_model = heads * kDh;
  const int8_t* base = qkv + static_cast<size_t>(b) * seq * ld;

  // keys any row of this tile may attend, dequantized into shared memory
  int nk = min(kv_len, seq);
  if (causal) nk = min(nk, min(row0 + kTcRows, seq));
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + pad16(nk) * kDh;
  const int ch = threadIdx.x % kCpr;  // the thread's chunk of every row it stages
  const int kcol = d_model + h * kDh + ch * 8, vcol = kcol + d_model;
  float ks[8], vs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ks[j] = kv_scale<kBf16Deq>(deq, kcol + j);
    vs[j] = kv_scale<kBf16Deq>(deq, vcol + j);
  }
#pragma unroll 4
  for (int r = threadIdx.x / kCpr; r < pad16(nk); r += kTcWarps * 32 / kCpr) {
    const bool ok = r < nk;
    const int8_t* row = base + static_cast<size_t>(r) * ld;
    const uint2 k8 = ok ? *reinterpret_cast<const uint2*>(row + kcol) : make_uint2(0u, 0u);
    const uint2 v8 = ok ? *reinterpret_cast<const uint2*>(row + vcol) : make_uint2(0u, 0u);
    const uint32_t kx[2] = {k8.x, k8.y}, vx[2] = {v8.x, v8.y};
    uint32_t kw[4], vw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 2 * (j & 1);  // bytes i and i + 1 of word j / 2
      kw[j] = pack_bf16(__fmul_rn(s8_at(kx[j >> 1], i), ks[2 * j]),
                        __fmul_rn(s8_at(kx[j >> 1], i + 1), ks[2 * j + 1]));
      vw[j] = pack_bf16(__fmul_rn(s8_at(vx[j >> 1], i), vs[2 * j]),
                        __fmul_rn(s8_at(vx[j >> 1], i + 1), vs[2 * j + 1]));
    }
    *reinterpret_cast<uint4*>(k_s + swz(r, ch, kCpr)) = make_uint4(kw[0], kw[1], kw[2], kw[3]);
    *reinterpret_cast<uint4*>(v_s + swz(r, ch, kCpr)) = make_uint4(vw[0], vw[1], vw[2], vw[3]);
  }

  // the warp's q rows, dequantized into A fragments (zero past seq)
  const int row_w = row0 + (threadIdx.x >> 5) * 16;
  const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  uint32_t qf[kDh / 16][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_w + g + 8 * hr;
    const int8_t* qr = base + static_cast<size_t>(row < seq ? row : 0) * ld + h * kDh;
#pragma unroll
    for (int kstep = 0; kstep < kDh / 16; ++kstep)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int col = kstep * 16 + hc * 8 + 2 * t;
        const char2 q2 = row < seq ? *reinterpret_cast<const char2*>(qr + col) : make_char2(0, 0);
        qf[kstep][hr + 2 * hc] =
            pack_bf16(dequant_q<kBf16Deq>(q2.x, deq[h * kDh + col], scale),
                      dequant_q<kBf16Deq>(q2.y, deq[h * kDh + col + 1], scale));
      }
  }
  __syncthreads();
  if (row_w >= seq) return;
  WarpAttention<kDh, WIN, true> att(qf, k_s, v_s, nk, row_w, causal);
  att.softmax();
  att.pv_sum([&](const float (&acc)[kDh / 8][4]) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row_w + g + 8 * hr;
      if (row >= seq) continue;
      int8_t* dst = out + (static_cast<size_t>(b) * seq + row) * d_model + h * kDh + 2 * t;
#pragma unroll
      for (int nd = 0; nd < kDh / 8; ++nd) {
        const int col = h * kDh + nd * 8 + 2 * t;
        const float o0 = rintf(__fmul_rn(acc[nd][2 * hr], o_inv[col]));
        const float o1 = rintf(__fmul_rn(acc[nd][2 * hr + 1], o_inv[col + 1]));
        *reinterpret_cast<char2*>(dst + nd * 8) =
            make_char2(static_cast<int8_t>(fminf(fmaxf(o0, -127.f), 127.f)),
                       static_cast<int8_t>(fminf(fmaxf(o1, -127.f), 127.f)));
      }
    }
  });
}

template <bool kBf16Deq, int WIN>
cudaError_t launch_tc(const void* qkv, const void* deq, const void* o_inv, void* out, int batch,
                      int seq, int heads, int ld, int kv_len, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(seq);
  cudaError_t err = cudaFuncSetAttribute(mha_q_kernel_tc<kBf16Deq, WIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTcRows - 1) / kTcRows, heads, batch);
  mha_q_kernel_tc<kBf16Deq, WIN><<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(deq),
      static_cast<const float*>(o_inv), static_cast<int8_t*>(out), seq, heads, ld, kv_len,
      causal, 1.0f / sqrtf(static_cast<float>(kDh)));
  return cudaGetLastError();
}

// the logits window sized to the keys, as mha_packed.cu's: 8, 13 or 16 blocks
template <bool kBf16Deq>
int launch(const void* qkv, const void* deq, const void* o_inv, void* out, int batch, int seq,
           int heads, int dh, int ld, int kv_len, int causal, void* stream) {
  if (dh != kDh || batch < 0 || seq < 1 || heads < 1 || ld < 3 * heads * kDh || ld % 8 ||
      kv_len < 1)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = ((kv_len < seq ? kv_len : seq) + 15) / 16;
#define TEAM_Q_TC(WIN) \
  launch_tc<kBf16Deq, WIN>(qkv, deq, o_inv, out, batch, seq, heads, ld, kv_len, causal, s)
  return nb <= 8 ? TEAM_Q_TC(8) : nb <= 13 ? TEAM_Q_TC(13) : TEAM_Q_TC(16);
#undef TEAM_Q_TC
}

}  // namespace

extern "C" size_t team_mha_packed_q_smem_bytes(int seq) { return smem_bytes(seq); }

// Pointers are device pointers: qkv int8 rows of 3*D values, ld bytes apart
// (ld a multiple of 8, the pointer 8-byte aligned), batch*seq of them; deq
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
