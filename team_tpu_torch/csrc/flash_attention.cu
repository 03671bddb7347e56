// Blockwise (flash) attention for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel team_tpu/ops/flash_attention.py:_flash_kernel (entry
// flash_attention), with its numerics:
//   q is cast to f32 and multiplied by dh^-0.5 before the dot;
//   K and V are upcast to f32, and p stays f32 in the PV product;
//   an online softmax (running max m, running sum l) over K/V tiles;
//   keys >= kv_len and, when causal, keys after the query are masked;
//   out = acc / max(l, 1e-30), stored in the input dtype.
// Masked keys get -inf instead of -1e30: exp of either minus the running max
// is 0 in f32, and every row keeps key 0 (kv_len >= 1, which the wrapper
// checks), so the sums are the same. A tile that lies wholly above a row's
// diagonal is skipped for that row, as the TPU kernel skips such blocks.
//
// Layout: q and out are [B, H, Sq, Dh], k and v [B, H, S, Dh] views with any
// strides for B, H and S and a unit stride for Dh, so the towers pass
// head-split views of the packed qkv projection without copying them, and the
// output is written straight into the [B, S, H, Dh] order the out-projection
// reads. Sq is S but for a pooling query (SigLIP's attention-pool head: one
// learned query over every token, Sq = 1, non-causal). The TPU pads S to a
// multiple of its block; here positions past S are masked instead, and
// nothing is padded in memory.
//
// float32 runs on the CUDA cores: one block per (b*h, tile of kRows query
// rows) scales its q tile into shared memory once, then streams K and V
// through shared memory in tiles of kKeys keys (one key per lane). Each warp
// owns kRowsPerWarp rows and keeps their m, l and output accumulator in
// registers: for every K/V tile a lane scores its key against the row, the
// warp reduces the tile's max and sum with shuffles, and for p.v the lanes
// split the head dimension while p is broadcast from lane j by a shuffle.
// team_tpu runs f32 at precision "highest", which TF32 would not meet.
//
// bfloat16 (the towers' dtype) runs both products on the tensor cores
// (mma.sync m16n8k16 bf16 -> f32, the fragment helpers of
// csrc/mma_attention.cuh; head widths 32, 64 and 72, the last SigLIP's: QK^T
// contracts over 4 k16 steps and one of 8, PV writes 9 n8 tiles), FA2-style: one block of kTcWarps warps per (b*h,
// tile of 16 * kTcWarps query rows), 16 rows a warp, streams K and V in tiles
// of kTcKeys keys through a double-buffered cp.async ring (16-byte chunks
// XOR-swizzled), so S has no shared-memory limit. QK^T takes the unscaled
// bf16 q as A fragments and multiplies the f32 logits by dh^-0.5 after the
// product: at dh 64 the scale is 1/8 and this is the TPU kernel's
// (q * scale) . k exactly, up to the order of the sum; at dh 32 a logit moves
// by about one f32 ulp. The online softmax keeps m and l per row in
// registers and scales the accumulators by exp(m_old - m_new); a warp skips
// the key blocks past its last causal row and past kv_len. p stays f32 as
// in the TPU kernel: PV runs twice on the same V fragments (ldmatrix.trans),
// once with p_hi = bf16(p) and once with p_lo = bf16(p - p_hi), which keeps p
// to about 2^-17 relative. out = acc / max(l, 1e-30), stored through the
// output strides.
//
// What bounds it on an H100: about 4*S^2*dh flops per (sample, head) --
// 15.3 GFLOP at B=128, H=12, S=197, dh=64 (the split PV makes the tensor
// cores do 1.5 times that) -- against about 155 MB of q, k, v and out in
// bf16: the memory (0.046 ms at 3.35 TB/s). At SigLIP's S=729, dh=72, H=16
// it is the products: 2.45 GFLOP a layer an image, 8.46 TFLOP at B=128
// (8.6 ms at the bf16 peak) against 861 MB (0.26 ms). The design reads each
// K/V tile once per block of query rows and keeps the scores and p out of
// device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "mma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_attention;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block, float32
constexpr int kKeys = 32;                      // keys per K/V tile, one per lane
constexpr int kKPad = 4;                       // K row padding: conflict-free float4 reads

constexpr int kTcWarps = kGroupWarps;       // warps per block, bfloat16: 16 query rows each
constexpr int kTcRows = 16 * kTcWarps;      // query rows per block, bfloat16
constexpr int kTcKeys = 32;                 // keys per K/V stage, bfloat16
constexpr int kTcBlocks = kTcKeys / 16;     // 16-key blocks of a stage

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

__host__ __device__ constexpr size_t smem_floats(int dh) {
  return static_cast<size_t>(kRows) * dh + static_cast<size_t>(kKeys) * (dh + kKPad) +
         static_cast<size_t>(kKeys) * dh;
}

// two stages of K and V, kTcKeys rows each
__host__ __device__ constexpr size_t smem_bytes_tc(int dh) {
  return 2 * 2 * static_cast<size_t>(kTcKeys) * dh * sizeof(bf16);
}

struct Strides {
  long long b, h, s;
};

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int heads, int q_len, int seq,
             int kv_len, int causal, float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kCols = DH / 32;  // output columns per lane
  constexpr int kStrideK = DH + kKPad;
  float* q_s = smem;                   // [kRows][DH], scaled
  float* k_s = q_s + kRows * DH;       // [kKeys][DH + kKPad]
  float* v_s = k_s + kKeys * kStrideK;  // [kKeys][DH]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row0 = blockIdx.y * kRows;
  const int row_end = min(row0 + kRows, q_len);
  const float* q_base = q + b * qs.b + h * qs.h;
  const float* k_base = k + b * ks.b + h * ks.h;
  const float* v_base = v + b * vs.b + h * vs.h;
  float* o_base = out + b * os.b + h * os.h;

  for (int idx = threadIdx.x; idx < kRows * DH; idx += blockDim.x) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int i = row0 + r;
    q_s[idx] = i < q_len ? q_base[i * qs.s + d] * scale : 0.f;
  }

  // keys any row of this tile may attend
  int n_keys = min(kv_len, seq);
  if (causal) n_keys = min(n_keys, row_end);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and, the first time, q_s is written)
    for (int idx = threadIdx.x; idx < kKeys * DH; idx += blockDim.x) {
      const int j = idx / DH;
      const int d = idx - j * DH;
      const int key = t0 + j;
      const bool ok = key < n_keys;
      k_s[j * kStrideK + d] = ok ? k_base[key * ks.s + d] : 0.f;
      v_s[j * DH + d] = ok ? v_base[key * vs.s + d] : 0.f;
    }
    __syncthreads();

    const int key = t0 + lane;
    const float4* k4 = reinterpret_cast<const float4*>(k_s + lane * kStrideK);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = row0 + warp + r * kWarps;  // rows interleave over warps: causal balance
      if (i >= row_end || (causal && t0 > i)) continue;  // warp-uniform
      const float4* q4 = reinterpret_cast<const float4*>(q_s + (i - row0) * DH);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 a = q4[d4];
        const float4 c = k4[d4];
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      const bool valid = key < n_keys && (!causal || key <= i);
      s = valid ? s : -CUDART_INF_F;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[r] - m_new);  // 0 on the row's first tile
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* v_row = v_s + j * DH + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, v_row[32 * c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + warp + r * kWarps;
    if (i >= row_end) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* dst = o_base + i * os.s;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[lane + 32 * c] = acc[r][c] * inv;
  }
}

// q rows 4-byte aligned, k and v rows 16-byte aligned (the wrapper sees to it)
template <int DH>
__global__ void __launch_bounds__(kTcWarps * 32)
flash_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int heads, int q_len,
                int seq, int kv_len, int causal, float scale, Strides qs, Strides ks, Strides vs,
                Strides os) {
  constexpr int KS = (DH + 15) / 16;  // k-steps of QK^T, the last one 8 wide at dh 72
  constexpr int kStage = 2 * kTcKeys * DH;  // elements of one stage: K, then V
  extern __shared__ __align__(16) float smem[];  // the f32 kernel's declaration
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row0 = blockIdx.y * kTcRows;
  const bf16* q_base = q + b * qs.b + h * qs.h;
  const bf16* k_base = k + b * ks.b + h * ks.h;
  const bf16* v_base = v + b * vs.b + h * vs.h;

  // keys any row of this tile may attend
  int n_keys = min(kv_len, seq);
  if (causal) n_keys = min(n_keys, min(row0 + kTcRows, q_len));
  const int ntiles = (n_keys + kTcKeys - 1) / kTcKeys;
  // keys [key0, key0 + kTcKeys) of K and V into a stage (rows past the last
  // key block of the tile are left as they were: no warp reads them)
  auto stage = [&](int key0, bf16* st) {
    const int nk = min(kTcKeys, n_keys - key0);
    stage_rows_tc<DH>(k_base + key0 * ks.s, ks.s, nk, st, threadIdx.x);
    stage_rows_tc<DH>(v_base + key0 * vs.s, vs.s, nk, st + kTcKeys * DH, threadIdx.x);
  };
  stage(0, ring);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = row0 + (threadIdx.x >> 5) * 16;
  // the warp's 16 rows of q, unscaled, as A fragments (rows past q_len and
  // columns past DH zero)
  uint32_t qf[KS][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_w + g + 8 * hr;
    const bf16* qr = q_base + static_cast<long long>(row < q_len ? row : 0) * qs.s;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc)
        qf[kk][hr + 2 * hc] =
            row < q_len && kk * 16 + hc * 8 < DH
                ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + hc * 8 + 2 * t)
                : 0u;
  }
  // keys any row of the warp sees; its rows' running max and (thread-partial) sum
  const int nkw = causal ? min(n_keys, row_w + 16) : n_keys;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4] = {};

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) stage((it + 1) * kTcKeys, ring + ((it + 1) & 1) * kStage);
    cp_async_commit();  // an empty group past the end keeps the count
    cp_async_wait(1);   // this tile has landed
    __syncthreads();    // ... for every thread
    const bf16* k_s = ring + (it & 1) * kStage;
    const bf16* v_s = k_s + kTcKeys * DH;
    const int key0 = it * kTcKeys;
    const int nbl = min(kTcBlocks, (nkw - key0 + 15) >> 4);  // the warp's key blocks here
    if (row_w < q_len && nbl > 0) {  // warp-uniform
      // logits * scale, masked to -inf; e = 4 * n-tile + the accumulator index
      float s[kTcBlocks][8];
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kTcBlocks; ++j) {
        if (j >= nbl) continue;
        float c[2][4] = {};
        qk_block<DH>(c, qf, k_s, j, lane);
        // only a block past the warp's keys or across its causal diagonal is
        // masked (a warp-uniform test)
        const int end = key0 + (j + 1) * 16;
        if (end <= nkw && !(causal && end > row_w + 1)) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s[j][e] = c[e >> 2][e & 3] * scale;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int key = end - 16 + (e >> 2) * 8 + 2 * t + (e & 1);
            const int row = row_w + g + ((e >> 1) & 1) * 8;
            const bool keep = key < nkw && (!causal || key <= row);
            s[j][e] = keep ? c[e >> 2][e & 3] * scale : -CUDART_INF_F;
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], s[j][e]);
      }
      // the new row max (finite: every row keeps key 0 of the first tile)
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
        mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
        alpha[hr] = expf(m[hr] - mt[hr]);  // 0 on the first tile
        m[hr] = mt[hr];
        l[hr] *= alpha[hr];
      }
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        acc[nd][0] *= alpha[0];
        acc[nd][1] *= alpha[0];
        acc[nd][2] *= alpha[1];
        acc[nd][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < kTcBlocks; ++j) {
        if (j >= nbl) continue;
        // p = p_hi + p_lo, both as A fragments against the same V fragments:
        // a[0][i] holds p of e = 2i and 2i + 1 (row g + 8 (i & 1)), rounded
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p0 = expf(s[j][2 * i] - m[i & 1]);
          const float p1 = expf(s[j][2 * i + 1] - m[i & 1]);
          l[i & 1] += p0;
          l[i & 1] += p1;
          a[0][i] = pack_bf16(p0, p1);
          const float2 hi = unpack_bf16(a[0][i]);
          a[1][i] = pack_bf16(p0 - hi.x, p1 - hi.y);
        }
        pv_block<DH, 2>(acc, a, v_s, j, lane);
      }
    }
    __syncthreads();  // the stage is consumed before the next iteration refills it
  }

  // the row sums over the quad, and out = acc / max(l, 1e-30) for rows < q_len
  bf16* o_base = out + b * os.b + h * os.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int row = row_w + g + 8 * hr;
    if (row >= q_len) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    bf16* dst = o_base + static_cast<long long>(row) * os.s + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          pack_bf16(__fdiv_rn(acc[nd][2 * hr], den), __fdiv_rn(acc[nd][2 * hr + 1], den));
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int batch,
                       int heads, int q_len, int seq, int kv_len, int causal, float scale,
                       Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = smem_floats(DH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (q_len + kRows - 1) / kRows);
  flash_kernel<DH><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), heads, q_len, seq, kv_len, causal, scale, qs, ks, vs, os);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int batch,
                      int heads, int q_len, int seq, int kv_len, int causal, float scale,
                      Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = smem_bytes_tc(DH);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_tc<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (q_len + kTcRows - 1) / kTcRows);
  flash_kernel_tc<DH><<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), heads, q_len, seq, kv_len, causal, scale, qs, ks, vs, os);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, h, s) for q, k, v and out in that order.
// dtype: 0 = float32 (the CUDA-core kernel, head widths 32 and 64), 1 =
// bfloat16 (the tensor-core one, 32, 64 and 72; every stride even and k, v
// 16-byte aligned, rows too); the codes of team_tpu_torch/ops/flash_attention.py.
// q_len: the query rows (seq, or fewer where not causal); seq: the keys.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int team_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        const long long* strides, int dtype, int batch,
                                        int heads, int q_len, int seq, int dh, int kv_len,
                                        int causal, float scale, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_len < 1 || q_len > seq || (causal && q_len != seq)) return cudaErrorInvalidValue;
  if (dtype == 0 && dh == 32)
    return launch_f32<32>(q, k, v, out, batch, heads, q_len, seq, kv_len, causal, scale, qs, ks,
                          vs, os, s);
  if (dtype == 0 && dh == 64)
    return launch_f32<64>(q, k, v, out, batch, heads, q_len, seq, kv_len, causal, scale, qs, ks,
                          vs, os, s);
  if (dtype == 1 && dh == 32)
    return launch_tc<32>(q, k, v, out, batch, heads, q_len, seq, kv_len, causal, scale, qs, ks,
                         vs, os, s);
  if (dtype == 1 && dh == 64)
    return launch_tc<64>(q, k, v, out, batch, heads, q_len, seq, kv_len, causal, scale, qs, ks,
                         vs, os, s);
  if (dtype == 1 && dh == 72)
    return launch_tc<72>(q, k, v, out, batch, heads, q_len, seq, kv_len, causal, scale, qs, ks,
                         vs, os, s);
  return cudaErrorInvalidValue;
}
