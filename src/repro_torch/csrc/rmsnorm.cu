// RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel rmsnorm (_kernel) of
// src/repro/kernels/rmsnorm.py:
//   y[n, :] = x[n, :] * (1 / sqrt(mean(x[n, :]^2) + eps)) * scale
// with float32 statistics, out in x's dtype (float32 or bfloat16; the
// scale is float32, the wrapper widens a bfloat16 one exactly).
//
// Design: one warp per row, eight rows per block of 256 threads. Lane l
// sums the squares of elements l, l + 32, ... in that order, then the
// warp adds the 32 partial sums by a fixed xor butterfly, so the sum is
// the same from run to run; the mean is that sum / D. The inverse root is
// the IEEE 1.0f / sqrtf (two correctly rounded operations, as PyTorch's
// CPU rsqrt), not the approximate rsqrtf. A second pass rereads the row
// (from L1/L2) and writes (x * inv) * scale, rounded once to bfloat16
// where x is bfloat16. Loads and stores of a warp touch consecutive
// elements.
//
// Bound: bytes. Each element is read once from device memory and written
// once (2 flops to square-and-add, 2 to scale); the rows on the serving
// path ([4T, 5120] for the layer norms, [4T*40, 128] and [4T*8, 128] for
// the qk-norms) are far below the card's operations-per-byte line.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ y, long long N, int D,
                               float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float acc = 0.0f;
  for (int i = lane; i < D; i += 32) {
    const float v = to_f32(xr[i]);
    acc += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  const float inv = 1.0f / sqrtf(acc / static_cast<float>(D) + eps);
  for (int i = lane; i < D; i += 32) {
    store(yr + i, to_f32(xr[i]) * inv * scale[i]);
  }
}

template <typename T>
int launch(const T* x, const float* scale, T* y, long long N, int D,
           float eps, void* stream) {
  const long long blocks = (N + kWarps - 1) / kWarps;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, scale, y, N,
                                                           D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const float* x, const float* scale, float* y,
                           long long N, int D, float eps, void* stream) {
  return launch(x, scale, y, N, D, eps, stream);
}

extern "C" int rmsnorm_bf16(const __nv_bfloat16* x, const float* scale,
                            __nv_bfloat16* y, long long N, int D, float eps,
                            void* stream) {
  return launch(x, scale, y, N, D, eps, stream);
}
