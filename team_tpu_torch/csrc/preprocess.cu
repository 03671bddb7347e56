// One-pass uint8 -> normalised float32 image preprocessing for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _normalize_kernel of team_tpu/ops/preprocess.py
// (entry normalize_uint8_kernel): [B, S, S, 3] uint8 -> float32
//   out = f32(fma(u, f32(1/255), -f32(mean_c))) * f32(1/std_c),
// c the channel (the innermost axis). That is the arithmetic XLA compiles the
// TPU kernel to: the multiply by 1/255 and the subtraction of the mean are
// one fused multiply-add (rounded once), the division by std is a product
// with its float32 reciprocal. The wrapper passes the seven float32
// constants, so the kernel and its plain version share them; __fmaf_rn and
// __fmul_rn keep nvcc from rounding anywhere else.
//
// What bounds it on an H100: bytes. It reads one byte and writes four per
// element (19.3 MB in, 77.1 MB out at B=128, 224^2: 0.029 ms at 3.35 TB/s)
// and does two flops per element. Each thread-step takes four consecutive
// elements: one aligned 32-bit load and one 16-byte store, so a warp reads
// 128 and writes 512 contiguous bytes per step, over a grid-stride loop. The
// channel of element i is i % 3; four elements starting at 4g start at
// channel g % 3. A tail of fewer than four elements goes one by one.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Consts {
  float inv255;
  float mean[3];
  float inv_std[3];
};

__device__ __forceinline__ float normalize(unsigned int u, int c, const Consts& k) {
  const float mean = c == 0 ? k.mean[0] : (c == 1 ? k.mean[1] : k.mean[2]);
  const float inv_std = c == 0 ? k.inv_std[0] : (c == 1 ? k.inv_std[1] : k.inv_std[2]);
  return __fmul_rn(__fmaf_rn(static_cast<float>(u), k.inv255, -mean), inv_std);
}

__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint8_t* __restrict__ in, float* __restrict__ out, long long n,
                    Consts k) {
  const long long quads = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint32_t* in4 = reinterpret_cast<const uint32_t*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < quads;
       g += stride) {
    const uint32_t w = in4[g];
    int c = static_cast<int>(g % 3);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = normalize((w >> (8 * e)) & 0xffu, c, k);
      c = c == 2 ? 0 : c + 1;
    }
    out4[g] = make_float4(v[0], v[1], v[2], v[3]);
  }
  // the tail: elements [quads*4, n), one thread each
  const long long t = quads * 4 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) out[t] = normalize(in[t], static_cast<int>(t % 3), k);
}

}  // namespace

// in: uint8 [B, S, S, 3] contiguous and 4-byte aligned; out: float32 of the
// same shape, 16-byte aligned; n = B*S*S*3. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int team_normalize_u8_fwd(const void* in, void* out, long long n, float inv255,
                                     float mean0, float mean1, float mean2, float inv_std0,
                                     float inv_std1, float inv_std2, void* stream) {
  if (n < 0 || n % 3 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(in) % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  const Consts k = {inv255, {mean0, mean1, mean2}, {inv_std0, inv_std1, inv_std2}};
  // enough blocks to fill the card several times over; the loop takes the rest
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > 132 * 32 ? 132 * 32 : want));
  normalize_u8_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<float*>(out), n, k);
  return cudaGetLastError();
}
