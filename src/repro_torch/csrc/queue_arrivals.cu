// Dense fluid-queue update for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel queue_arrivals (_kernel) of
// src/repro/kernels/queue_arrivals.py, the "fused" backend's queue update:
//   arr[q] = sum_h sum_f lam[h, f] * onehot[h, f, q]
//   q'[q]  = clip(q[q] + (arr[q] - out[q]) * dt, 0, caps[q])
//
// Design: one thread per queue column q, with a fixed loop order (h
// outer, f inner) and one float32 accumulator, so the sum is the same
// from run to run; it is not bitwise the reference scatter's order (the
// TPU kernel reassociates too), and is held to the plain version at rtol
// 1e-5. A warp reads 32 consecutive q of one onehot[h, f, :] row, so the
// loads coalesce, and every thread of the warp reads the same lam[h, f]
// (a broadcast). The integration is fused into the same thread, so
// arrivals and the new queue leave the kernel once. No tensor cores: the
// product is a one-row GEMV, and TF32 would break the 1e-5 bar.
//
// Bound: bytes. The incidence is H*F*(Q+1) floats read once per tick
// (8.3 MB for the padded paper fabric), two flops per float. This simple
// form runs only ceil((Q+1)/128) blocks, so it is far from the memory
// rate; a sparse (CSR) form that reads only the nonzeros is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

constexpr int kThreads = 128;

__global__ void queue_arrivals_kernel(
    const float* __restrict__ lam, const float* __restrict__ onehot,
    const float* __restrict__ q, const float* __restrict__ out_rate,
    const float* __restrict__ caps, float* __restrict__ arr,
    float* __restrict__ q_new, int H, int F, int Q, float dt) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Q) return;
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) {
    const float* lam_h = lam + static_cast<long long>(h) * F;
    const float* col = onehot + static_cast<long long>(h) * F * Q + c;
#pragma unroll 8
    for (int f = 0; f < F; ++f) {
      acc += lam_h[f] * col[static_cast<long long>(f) * Q];
    }
  }
  arr[c] = acc;
  q_new[c] = pmin(pmax(q[c] + (acc - out_rate[c]) * dt, 0.0f), caps[c]);
}

}  // namespace

extern "C" int queue_arrivals_f32(const float* lam, const float* onehot,
                                  const float* q, const float* out_rate,
                                  const float* caps, float* arr,
                                  float* q_new, int H, int F, int Q,
                                  float dt, void* stream) {
  const int blocks = (Q + kThreads - 1) / kThreads;
  queue_arrivals_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      lam, onehot, q, out_rate, caps, arr, q_new, H, F, Q, dt);
  return static_cast<int>(cudaGetLastError());
}
