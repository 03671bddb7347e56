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
// the one rounding; q = round(q * dh^-0.5); f32 logits, the causal mask by
// position; the f32 row max, expf, the row sum, p = round(p / l) normalised
// before PV; each head's attention output is rounded to the input dtype
// before the out-projection; the residual is added in f32 and the sum
// rounded once.
//
// Design. On the TPU one program holds a sample's whole qkv (197 x 2304 bf16,
// 908 KB) and both weights in VMEM. A Hopper block has 227 KB of shared
// memory, so the work is cut in two kernels, with a [B, S, 3*D] workspace in
// device memory between them (116 MB at B=128, S=197, D=768: 0.07 ms of
// traffic at 3.35 TB/s):
//   ln_qkv: a tile of 64 rows of [B*S, D] is normalised into shared memory
//     once, then multiplied by W_qkv, bias added, rounded, stored;
//   mha_packed_proj: one block per (tile of 64 query rows, sample). For each
//     head it stages K and V in shared memory and leaves that head's output
//     rows in a shared tile [64, D]; then the tile times W_out (k-slices
//     through the memory that held K and V), + b_out + x, one rounding.
// What bounds it on an H100: 2*S*D*3D + 4*S^2*D + 2*S*D^2 flops per sample,
// 134 GFLOP per vision layer at B=128, against 82 MB of input and output:
// operations, even at the tensor cores' rate.
//
// bfloat16 (the towers' dtype) runs every product on the tensor cores, with
// mma.sync m16n8k16 bf16 -> f32 (csrc/mma_frag.cuh), eight warps a block:
//   - the qkv and out-projection GEMMs (TcGemm): the 64-row A tile stays in
//     shared memory (row pitch D + 8: conflict-free ldmatrix); the weight,
//     row-major [K, N], streams through a cp.async ring (three 64-deep
//     k-slices where they fit, chunks XOR-swizzled) and is read as the "col"
//     operand by ldmatrix.trans, so it is never transposed; each warp owns
//     64 rows x 32 columns of a 256-column CTA tile. ln_qkv copies its 64
//     raw rows in with the first weight slices, normalises them in place
//     and walks all 3*D columns of its rows (the text tower's few row tiles
//     split the columns over more blocks), so the layer norm runs once and
//     the ring runs on across column tiles;
//   - the attention (WarpAttention of csrc/mma_attention.cuh, which
//     mha_packed.cu shares): two groups of four warps, 16 query
//     rows a warp, each group on every other head with K and V of its own
//     (one group where two heads' K/V do not fit). K and V of a head are
//     staged whole, padded with zeros to a multiple of 16 keys (chunks
//     XOR-swizzled). QK^T reads K as the "col" operand; a thread keeps
//     the logits of up to 256 keys in registers (16 blocks of 16), so the
//     max, the sum and p come from one QK^T; past 256 keys the logits are
//     recomputed per 256-key window in three passes (max, sum, p and PV),
//     and the fixed mma order gives the same logits each time. p,
//     normalised and rounded, goes straight from the accumulator layout
//     into PV's A fragments; V's B fragments come from ldmatrix.trans.
//   Only the order of the f32 sums differs from the CUDA-core kernel (the
//   products' k order inside the mma, the row max and sum by quad
//   shuffles); every rounding is the same. Shared memory is the o tile plus
//   one or two heads' K/V: every shape the CUDA-core bf16 kernel took still
//   fits (S <= 520 at D=768).
// float32 keeps the CUDA-core path (attend_rows and tile_gemm of
// attention_common.cuh; f32 FMA, no TF32): team_tpu runs f32 at precision
// "highest", which TF32's 10-bit mantissa would not meet.

#include "attention_common.cuh"
#include "mma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_frag;
using namespace mma_attention;

// ---------------------------------------------------------------------------
// shared by both paths
// ---------------------------------------------------------------------------

// layer norm of the rows r < tile_rows of a tile, row r read from
// x + r * x_row, into the tile h_s (row pitch lda; x may be h_s itself), one
// warp a row, `warps` warps: the raw row is copied into the tile, the
// statistics read it there, and the normalised values replace it; rows
// r >= valid_rows are zero
template <typename T>
__device__ __forceinline__ void layer_norm_rows(const T* x, long long x_row,
                                                const float* __restrict__ ln_g,
                                                const float* __restrict__ ln_b, T* h_s, int lda,
                                                int tile_rows, int valid_rows, int d_model,
                                                int warps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float n = static_cast<float>(d_model);
  for (int r = warp; r < tile_rows; r += warps) {
    T* hr = h_s + r * lda;
    if (r >= valid_rows) {
      for (int d = lane; d < d_model; d += 32) hr[d] = from_float<T>(0.f);
      continue;
    }
    const T* xr = x + r * x_row;
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
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core path
// ---------------------------------------------------------------------------

constexpr int kRowsF32 = 32;  // query or row tile: o tile 98.8 KB + K/V 102 KB at D=768, S=197

size_t proj_smem_bytes(int seq, int d_model, int dh) {
  const size_t kv = kv_bytes<float>(seq, dh);
  const size_t w = gemm_slice_bytes<float>();
  return align16(static_cast<size_t>(kRowsF32) * tile_stride(d_model) * sizeof(float)) +
         align16(kv > w ? kv : w) + row_buffer_bytes(seq, dh);
}

size_t ln_qkv_smem_bytes(int d_model) {
  return align16(static_cast<size_t>(kRowsF32) * tile_stride(d_model) * sizeof(float)) +
         gemm_slice_bytes<float>();
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_packed_proj_kernel(const float* __restrict__ qkv, const float* __restrict__ w_out,
                       const float* __restrict__ b_out, const float* __restrict__ x,
                       float* __restrict__ out, int seq, int heads, int causal, float scale) {
  constexpr int R = kRowsF32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d_model = heads * DH;
  const int lda = tile_stride(d_model);
  const int ks = kv_stride<float>(DH);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int row_end = min(row0 + R, seq);
  const long long ld = 3LL * d_model;
  const float* base = qkv + b * seq * ld;

  float* o_s = reinterpret_cast<float*>(smem);
  unsigned char* shared = smem + align16(static_cast<size_t>(R) * lda * sizeof(float));
  float* k_s = reinterpret_cast<float*>(shared);  // K and V of one head, then the W_out slices
  float* v_s = k_s + static_cast<size_t>(seq) * ks;
  const size_t kv = kv_bytes<float>(seq, DH);
  float* p_all = reinterpret_cast<float*>(
      shared + align16(kv > gemm_slice_bytes<float>() ? kv : gemm_slice_bytes<float>()));
  float* q_all = p_all + kWarps * seq;

  // rows past the sequence's end take part in the product but are never stored
  for (int idx = (row_end - row0) * lda + threadIdx.x; idx < R * lda; idx += kThreads) o_s[idx] = 0.f;

  const int n_keys = causal ? row_end : seq;  // keys any row of this tile may attend
  const int warp = threadIdx.x >> 5;
  for (int h = 0; h < heads; ++h) {
    __syncthreads();  // every warp is done with the previous head's K and V
    stage_kv(base + d_model + h * DH, base + 2 * d_model + h * DH, ld, n_keys, DH, k_s, v_s, ks);
    __syncthreads();
    attend_rows<float, DH>(base + h * DH, ld, k_s, v_s, ks, row0 + warp, row_end, kWarps, n_keys,
                           causal, scale, p_all + warp * seq, q_all + warp * DH, o_s + h * DH, lda,
                           row0);
  }

  // out-projection and residual (tile_gemm synchronises before it reuses K/V's memory)
  const long long out_row0 = static_cast<long long>(b) * seq + row0;
  tile_gemm<float, R>(o_s, lda, w_out, d_model, d_model, 0, d_model, k_s,
                      [&](int r, int col, float acc) {
                        if (row0 + r >= seq) return;
                        const long long o = (out_row0 + r) * d_model + col;
                        out[o] = __fadd_rn(x[o], __fadd_rn(acc, b_out[col]));
                      });
}

__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
              const float* __restrict__ ln_b, const float* __restrict__ w_qkv,
              const float* __restrict__ b_qkv, float* __restrict__ qkv, int rows, int d_model) {
  constexpr int R = kRowsF32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = tile_stride(d_model);
  float* h_s = reinterpret_cast<float*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + align16(static_cast<size_t>(R) * lda * sizeof(float)));
  const int row0 = blockIdx.x * R;
  layer_norm_rows<float>(x + static_cast<long long>(row0) * d_model, d_model, ln_g, ln_b, h_s,
                         lda, R, rows - row0, d_model, kWarps);

  // the tile times this block's third of W_qkv, + b_qkv, one rounding
  const int n_begin = blockIdx.y * d_model;
  const long long ld = 3LL * d_model;
  tile_gemm<float, R>(h_s, lda, w_qkv, ld, d_model, n_begin, n_begin + d_model, w_s,
                      [&](int r, int col, float acc) {
                        if (row0 + r >= rows) return;
                        qkv[(static_cast<long long>(row0) + r) * ld + col] = __fadd_rn(acc, b_qkv[col]);
                      });
}

template <int DH>
cudaError_t launch_proj(const void* qkv, const void* w_out, const float* b_out, const void* x,
                        void* out, int batch, int seq, int heads, int causal, float scale,
                        cudaStream_t stream) {
  const size_t smem = proj_smem_bytes(seq, heads * DH, DH);
  cudaError_t err = cudaFuncSetAttribute(mha_packed_proj_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRowsF32 - 1) / kRowsF32, batch);
  mha_packed_proj_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(w_out), b_out,
      static_cast<const float*>(x), static_cast<float*>(out), seq, heads, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_ln_qkv(const void* x, const float* ln_g, const float* ln_b, const void* w_qkv,
                          const float* b_qkv, void* qkv, int rows, int d_model,
                          cudaStream_t stream) {
  const size_t smem = ln_qkv_smem_bytes(d_model);
  cudaError_t err = cudaFuncSetAttribute(ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kRowsF32 - 1) / kRowsF32, 3);
  ln_qkv_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), ln_g, ln_b, static_cast<const float*>(w_qkv), b_qkv,
      static_cast<float*>(qkv), rows, d_model);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core path
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;          // rows of the A tile (query tile, row tile)
constexpr int kTcWarps = 8;          // both kernels; the attention runs in groups of 4 warps
constexpr int kMaxStages = 4;        // weight ring depth at most (cp_async_wait takes up to 4)
constexpr long long kSmemLimit = 232448;  // dynamic shared memory a block may opt into on sm_90

__host__ __device__ constexpr int tc_pitch(int d_model) { return d_model + 8; }

__host__ __device__ constexpr size_t tc_tile_bytes(int d_model) {
  return static_cast<size_t>(kTcRows) * tc_pitch(d_model) * sizeof(bf16);
}

// the weight ring of a GEMM: nst stages of `depth` k-rows (16, 32 or 64:
// one to four mma k-steps) by the CTA tile's columns
struct Ring {
  int depth, nst;
};

// the ring that `bytes` hold for tiles `bn` columns wide over a depth k_total
// (a multiple of 32): 64-deep stages where three fit and 64 divides k_total,
// 32-deep where two fit, else 16-deep; 1 to kMaxStages stages (fewer,
// deeper stages: fewer barriers a k-step)
Ring ring_for(size_t bytes, int bn, int k_total) {
  const size_t row = static_cast<size_t>(bn) * sizeof(bf16);  // one k-row of a stage
  const int depth = bytes >= 3 * 64 * row && k_total % 64 == 0 ? 64
                    : bytes >= 2 * 32 * row                    ? 32
                                                               : 16;
  const size_t n = bytes / (depth * row);
  return {depth, n < 1 ? 1 : (n > kMaxStages ? kMaxStages : static_cast<int>(n))};
}

// C[0:64, n_begin:n_end) = A[0:64, 0:k_total) . W[0:k_total, n_begin:n_end)
// in f32 on the tensor cores, kTcWarps warps. A is a tile in shared memory
// (row pitch lda, a multiple of 8); W is row-major in device memory (row
// stride ldw), read through the ring (chunks XOR-swizzled) in one pipeline
// over every (column tile, k-slice) of the range. k_total is a multiple of
// the ring's depth (ring_for) and the range's width a multiple of 8; columns
// past n_end are zero-filled and never passed to the epilogue.
struct TcGemm {
  static constexpr int BN = 32 * kTcWarps;  // columns of a CTA tile; warp w owns [32w, 32w + 32)
  static constexpr int kThreadsG = 32 * kTcWarps;
  static constexpr int kCpr = BN / 8;  // 16-byte chunks in a stage row

  // position in the pipeline: column tile, k-slice, ring stage
  struct Cursor {
    int nt = 0, kt = 0, slot = 0;
  };

  const bf16* w;
  long long ldw;
  int n_begin, n_end, ntiles, nks;
  Ring ring;
  bf16* stages;
  Cursor next;  // the next slice to load

  __device__ TcGemm(const bf16* w_, long long ldw_, int n_begin_, int n_end_, int k_total,
                    bf16* stages_, Ring ring_)
      : w(w_), ldw(ldw_), n_begin(n_begin_), n_end(n_end_),
        ntiles((n_end_ - n_begin_ + BN - 1) / BN), nks(k_total / ring_.depth), ring(ring_),
        stages(stages_) {}

  __device__ __forceinline__ void advance(Cursor& c) const {
    if (++c.kt == nks) {
      c.kt = 0;
      ++c.nt;
    }
    if (++c.slot == ring.nst) c.slot = 0;
  }

  // the next slice into its stage, zero-filled past n_end; nothing past the end
  __device__ __forceinline__ void load_next() {
    if (next.nt < ntiles) {
      const int n0 = n_begin + next.nt * BN;
      const int k0 = next.kt * ring.depth;
      bf16* st = stages + next.slot * ring.depth * BN;
      for (int c = threadIdx.x; c < ring.depth * kCpr; c += kThreadsG) {
        const int kr = c / kCpr, ch = c % kCpr;
        const int col = n0 + ch * 8;
        const bool ok = col < n_end;
        cp_async16(st + swz(kr, ch, kCpr), ok ? w + (k0 + kr) * ldw + col : w, ok);
      }
    }
    advance(next);
  }

  // the first nst - 1 slices; may be issued before the A tile is written
  __device__ __forceinline__ void prologue() {
    for (int s = 0; s < ring.nst - 1; ++s) {
      load_next();
      cp_async_commit();
    }
  }

  // the product; epi(r, col, v0, v1) gets the f32 sums of row r, columns col
  // and col + 1, for every r < 64 of the m-tiles that hold a row < rows_valid
  template <typename Epi>
  __device__ __forceinline__ void run(const bf16* a_s, int lda, int rows_valid, Epi epi) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int mt_valid = min(4, (rows_valid + 15) >> 4);
    // ldmatrix rows of this lane: A rows (l % 8) + 8 * ((l / 8) % 2) at k half
    // l / 16; W k-rows the same, at column chunk l / 16 of a pair of n-tiles
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int lhalf = lane >> 4;
    float acc[4][4][4];
    for (Cursor c; c.nt < ntiles; advance(c)) {
      if (c.kt == 0) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
      }
      if (ring.nst == 1) {
        __syncthreads();  // every warp is done with the stage
        load_next();
        cp_async_commit();
        cp_async_wait(0);
      } else {
        cp_async_wait(ring.nst - 2);  // this slice has landed
      }
      __syncthreads();  // ... for every thread; and the previous slice's stage is free
      if (ring.nst > 1) {
        load_next();
        cp_async_commit();  // an empty group past the end keeps the count
      }
      const bf16* st = stages + c.slot * ring.depth * BN;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks * 16 >= ring.depth) break;
        uint32_t bfr[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, st + swz(ks * 16 + lrow, warp * 4 + np * 2 + lhalf, kCpr));
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
        const int k0 = c.kt * ring.depth + ks * 16;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < mt_valid) {
            uint32_t af[4];
            ldsm_x4(af, a_s + (mt * 16 + lrow) * lda + k0 + lhalf * 8);
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_bf16(acc[mt][n], af, bfr[n]);
          }
        }
      }
      if (c.kt == nks - 1) {
        const int col0 = n_begin + c.nt * BN + warp * 32 + 2 * t;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= mt_valid) continue;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = col0 + n * 8;
            if (col >= n_end) continue;
            epi(mt * 16 + g, col, acc[mt][n][0], acc[mt][n][1]);
            epi(mt * 16 + g + 8, col, acc[mt][n][2], acc[mt][n][3]);
          }
        }
      }
    }
  }
};

// K and V of one head, padded to 16 keys
size_t kv_tc_bytes(int seq, int dh) { return 2 * static_cast<size_t>(pad16(seq)) * dh * sizeof(bf16); }

// attention groups of mha_packed_proj: two (each with a head's K and V of its
// own) where both fit beside the o tile, else one
int proj_tc_groups(int seq, int d_model, int dh) {
  const size_t two = tc_tile_bytes(d_model) + 2 * kv_tc_bytes(seq, dh);
  return two <= static_cast<size_t>(kSmemLimit) ? 2 : 1;
}

// the K/V buffers, which the out-projection's weight ring then uses (at least 8 KB)
size_t proj_tc_region_bytes(int seq, int d_model, int dh) {
  const size_t kv = proj_tc_groups(seq, d_model, dh) * kv_tc_bytes(seq, dh);
  return kv > 8192 ? kv : 8192;
}

size_t proj_tc_smem_bytes(int seq, int d_model, int dh) {
  return tc_tile_bytes(d_model) + proj_tc_region_bytes(seq, d_model, dh);
}

// ln_qkv's ring: what fits beside the tile, at most three 64-deep stages
Ring ln_qkv_tc_ring(int d_model) {
  const long long room = kSmemLimit - static_cast<long long>(tc_tile_bytes(d_model));
  const long long most = 3 * 64LL * TcGemm::BN * sizeof(bf16);
  return ring_for(static_cast<size_t>(room < 0 ? 0 : (room < most ? room : most)), TcGemm::BN,
                  d_model);
}

size_t ln_qkv_tc_smem_bytes(int d_model) {
  const Ring r = ln_qkv_tc_ring(d_model);
  return tc_tile_bytes(d_model) + static_cast<size_t>(r.nst) * r.depth * TcGemm::BN * sizeof(bf16);
}

template <int DH>
__global__ void __launch_bounds__(kTcWarps * 32)
mha_packed_proj_kernel_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ w_out,
                          const float* __restrict__ b_out, const bf16* __restrict__ x,
                          bf16* __restrict__ out, int seq, int heads, int causal, float scale,
                          int groups, Ring ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d_model = heads * DH;
  const int lda = tc_pitch(d_model);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int rows_valid = min(kTcRows, seq - row0);
  const long long ld = 3LL * d_model;
  const bf16* base = qkv + static_cast<long long>(b) * seq * ld;

  bf16* o_s = reinterpret_cast<bf16*>(smem);
  bf16* region = reinterpret_cast<bf16*>(smem + tc_tile_bytes(d_model));
  const int nk = causal ? min(seq, row0 + kTcRows) : seq;  // keys any row of this tile may attend
  const int warp = threadIdx.x >> 5;
  const int group = warp / kGroupWarps;
  const int row_w = row0 + (warp % kGroupWarps) * 16;
  // each group walks its own heads (group, group + groups, ...) with its own
  // K/V buffers and barrier
  if (group < groups) {
    bf16* k_s = region + group * 2 * pad16(seq) * DH;
    bf16* v_s = k_s + pad16(seq) * DH;
    const int tid = threadIdx.x % (kGroupWarps * 32);
    for (int h = group; h < heads; h += groups) {
      group_sync(group);  // the group is done with the previous head's K and V
      stage_rows_tc<DH>(base + d_model + h * DH, ld, nk, k_s, tid);
      stage_rows_tc<DH>(base + 2 * d_model + h * DH, ld, nk, v_s, tid);
      cp_async_commit();
      cp_async_wait(0);
      group_sync(group);
      // a warp whose rows all lie past the sequence leaves its rows of the o
      // tile unwritten: the product skips their m-tile
      if (row_w < seq) {
        WarpAttention<DH> att(base + h * DH, ld, k_s, v_s, seq, nk, row_w, causal, scale);
        att.softmax();
        att.pv(o_s + (row_w - row0) * lda + h * DH, lda);
      }
    }
  }

  __syncthreads();  // the o tile is whole, and K/V's memory is free for W_out
  TcGemm gemm(w_out, d_model, 0, d_model, d_model, region, ring);
  gemm.prologue();
  const long long out_row0 = static_cast<long long>(b) * seq + row0;
  gemm.run(o_s, lda, rows_valid, [&](int r, int col, float v0, float v1) {
    if (r >= rows_valid) return;
    const long long i = (out_row0 + r) * d_model + col;
    const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + i));
    *reinterpret_cast<uint32_t*>(out + i) = pack_bf16(__fadd_rn(xv.x, __fadd_rn(v0, b_out[col])),
                                                      __fadd_rn(xv.y, __fadd_rn(v1, b_out[col + 1])));
  });
}

__global__ void __launch_bounds__(kTcWarps * 32)
ln_qkv_kernel_tc(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                 const float* __restrict__ ln_b, const bf16* __restrict__ w_qkv,
                 const float* __restrict__ b_qkv, bf16* __restrict__ qkv, int rows, int d_model,
                 int tiles_per_block, Ring ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = tc_pitch(d_model);
  bf16* h_s = reinterpret_cast<bf16*>(smem);
  bf16* stages = reinterpret_cast<bf16*>(smem + tc_tile_bytes(d_model));
  const int row0 = blockIdx.x * kTcRows;
  const int n3 = 3 * d_model;
  const int n_begin = blockIdx.y * tiles_per_block * TcGemm::BN;
  const int n_end = min(n3, n_begin + tiles_per_block * TcGemm::BN);
  const int valid_rows = min(kTcRows, rows - row0);
  // the tile's raw rows, then the first weight slices, all in flight together
  const int cpr = d_model / 8;
  for (int c = threadIdx.x; c < kTcRows * cpr; c += kTcWarps * 32) {
    const int r = c / cpr, ch = c - r * cpr;
    const bool ok = r < valid_rows;
    cp_async16(h_s + r * lda + ch * 8, ok ? x + (static_cast<long long>(row0) + r) * d_model + ch * 8 : x,
               ok);
  }
  cp_async_commit();
  TcGemm gemm(w_qkv, n3, n_begin, n_end, d_model, stages, ring);
  gemm.prologue();
  cp_async_wait(ring.nst - 1);  // the rows have landed (the oldest group)
  __syncthreads();
  layer_norm_rows<bf16>(h_s, lda, ln_g, ln_b, h_s, lda, kTcRows, valid_rows, d_model, kTcWarps);
  gemm.run(h_s, lda, valid_rows, [&](int r, int col, float v0, float v1) {
    if (row0 + r >= rows) return;
    *reinterpret_cast<uint32_t*>(qkv + (static_cast<long long>(row0) + r) * n3 + col) =
        pack_bf16(__fadd_rn(v0, b_qkv[col]), __fadd_rn(v1, b_qkv[col + 1]));
  });
}

template <int DH>
cudaError_t launch_proj_tc(const void* qkv, const void* w_out, const float* b_out, const void* x,
                           void* out, int batch, int seq, int heads, int causal, float scale,
                           cudaStream_t stream) {
  const int d_model = heads * DH;
  const size_t smem = proj_tc_smem_bytes(seq, d_model, DH);
  cudaError_t err = cudaFuncSetAttribute(mha_packed_proj_kernel_tc<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTcRows - 1) / kTcRows, batch);
  mha_packed_proj_kernel_tc<DH><<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(w_out), b_out,
      static_cast<const bf16*>(x), static_cast<bf16*>(out), seq, heads, causal, scale,
      proj_tc_groups(seq, d_model, DH),
      ring_for(proj_tc_region_bytes(seq, d_model, DH), TcGemm::BN, d_model));
  return cudaGetLastError();
}

cudaError_t launch_ln_qkv_tc(const void* x, const float* ln_g, const float* ln_b, const void* w_qkv,
                             const float* b_qkv, void* qkv, int rows, int d_model,
                             cudaStream_t stream) {
  const size_t smem = ln_qkv_tc_smem_bytes(d_model);
  cudaError_t err = cudaFuncSetAttribute(ln_qkv_kernel_tc,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // a few row tiles (the text tower) split the column tiles over more blocks
  const int row_tiles = (rows + kTcRows - 1) / kTcRows;
  const int col_tiles = (3 * d_model + TcGemm::BN - 1) / TcGemm::BN;
  int splits = sms / row_tiles;
  splits = splits < 1 ? 1 : (splits > col_tiles ? col_tiles : splits);
  const int per_block = (col_tiles + splits - 1) / splits;
  const dim3 grid(row_tiles, (col_tiles + per_block - 1) / per_block);
  ln_qkv_kernel_tc<<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), ln_g, ln_b, static_cast<const bf16*>(w_qkv), b_qkv,
      static_cast<bf16*>(qkv), rows, d_model, per_block, ln_qkv_tc_ring(d_model));
  return cudaGetLastError();
}

template <typename... A>
cudaError_t launch_proj_dh(int dtype, int dh, A... args) {
  if (dtype == 0 && dh == 32) return launch_proj<32>(args...);
  if (dtype == 0 && dh == 64) return launch_proj<64>(args...);
  if (dtype == 1 && dh == 32) return launch_proj_tc<32>(args...);
  if (dtype == 1 && dh == 64) return launch_proj_tc<64>(args...);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); the codes of
// team_tpu_torch/ops/mha_short.py. Shared memory of one block: kernel 0 =
// attention + out-projection, 1 = layer norm + qkv.
extern "C" size_t team_attn_block_smem_bytes(int kernel, int dtype, int seq, int d_model, int dh) {
  if (kernel == 0)
    return dtype == 1 ? proj_tc_smem_bytes(seq, d_model, dh) : proj_smem_bytes(seq, d_model, dh);
  return dtype == 1 ? ln_qkv_tc_smem_bytes(d_model) : ln_qkv_smem_bytes(d_model);
}

// qkv [B, S, 3*D], w_out [D, D] (input dtype), b_out [D] f32, x [B, S, D] -> out [B, S, D].
// bf16 pointers 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
extern "C" int team_mha_packed_proj_fwd(const void* qkv, const void* w_out, const void* b_out,
                                        const void* x, void* out, int dtype, int batch, int seq,
                                        int heads, int dh, int causal, float scale, void* stream) {
  return launch_proj_dh(dtype, dh, qkv, w_out, static_cast<const float*>(b_out), x, out, batch,
                        seq, heads, causal, scale, static_cast<cudaStream_t>(stream));
}

// x [rows, D], ln_g/ln_b [D] f32, w_qkv [D, 3*D] (input dtype), b_qkv [3*D] f32 -> qkv [rows, 3*D].
// bf16 pointers 16-byte aligned.
extern "C" int team_ln_qkv_fwd(const void* x, const void* ln_g, const void* ln_b,
                               const void* w_qkv, const void* b_qkv, void* qkv, int dtype,
                               int rows, int d_model, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* bl = static_cast<const float*>(ln_b);
  const float* bq = static_cast<const float*>(b_qkv);
  if (dtype == 0) return launch_ln_qkv(x, g, bl, w_qkv, bq, qkv, rows, d_model, s);
  if (dtype == 1) return launch_ln_qkv_tc(x, g, bl, w_qkv, bq, qkv, rows, d_model, s);
  return cudaErrorInvalidValue;
}
