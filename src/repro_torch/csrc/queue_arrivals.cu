// Dense fluid-queue update for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel queue_arrivals (_kernel) of
// src/repro/kernels/queue_arrivals.py, the "fused" backend's queue update:
//   arr[q] = sum_h sum_f lam[h, f] * onehot[h, f, q]
//   q'[q]  = clip(q[q] + (arr[q] - out[q]) * dt, 0, caps[q])
//
// Bound: bytes. The incidence is H*F*(Q+1) floats read once per tick
// (8.3 MB for the padded paper fabric, 1.3 MB for the slot pool), two
// flops per float. Reading it at the memory rate needs a few MB in flight,
// so the work is spread over the whole card as a split reduction over the
// rows r = h*F + f of the incidence seen as [H*F, Q+1]:
//
// * a 2-D grid of (column tiles of kCols = 64 queues) x (row chunks of
//   kRows = 64 rows): 5 x 113 = 565 blocks at the padded shape (four
//   per SM), 5 x 18 at the slot shape. A block's 256 threads are 4
//   groups of 64, one thread per column; group g sums rows 16g .. 16g+15
//   of the chunk in ascending order (two warps read one 256-byte row
//   segment, so the loads coalesce, and a thread's sixteen loads are
//   independent and in flight together). lam for the chunk is staged in
//   shared memory. The four group sums are added in group order and the
//   chunk's partial goes to a [chunks, Q+1] scratch buffer;
// * the last chunk block of each column tile to finish (elected by a
//   per-tile counter taken with atomicAdd after __threadfence; it resets
//   the counter to 0, so the next launch, or a CUDA graph replay, finds
//   it zeroed) adds the tile's partials: its four groups each sum a
//   quarter of the chunks in chunk order (eight loads in flight), the
//   quarters are added in order, and only it applies the integration
//   with NaN-propagating pmax/pmin, so arrivals and the new queue leave
//   the kernel once.
//
// A batch of B scenarios (the batched engines) runs in the same launch on
// a third grid axis, blockIdx.z = scenario: each scenario has its own
// rows, queues, partials and counters, and its tiles elect their own last
// blocks, so each scenario's sums run in the order of a launch of its own.
//
// Every sum runs in this fixed order, so the result is the same from run
// to run (the counter only elects a block; no atomics touch the data). It
// is not the reference scatter's order and is held to the plain version
// at rtol 1e-5. No tensor cores: the product is a one-row GEMV, and TF32
// would break that bar.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;                 // queue columns per tile
constexpr int kGroups = 4;                // row groups per block
constexpr int kGroupRows = 16;            // rows per group
constexpr int kRows = kGroups * kGroupRows;   // rows per chunk
constexpr int kThreads = kCols * kGroups;

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
    queue_arrivals_kernel(const float* __restrict__ lam,
                          const float* __restrict__ onehot,
                          const float* __restrict__ q,
                          const float* __restrict__ out_rate,
                          const float* __restrict__ caps,
                          float* __restrict__ arr, float* __restrict__ q_new,
                          float* __restrict__ part,
                          unsigned int* __restrict__ count, int R, int Q,
                          int rate_stride, int caps_stride, float dt) {
  __shared__ float lam_s[kRows];
  __shared__ float group_s[kGroups][kCols];
  __shared__ bool last_s;
  const int col = threadIdx.x % kCols;
  const int grp = threadIdx.x / kCols;
  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  // this block's scenario
  const long long b = blockIdx.z;
  lam += b * R;
  onehot += b * R * static_cast<long long>(Q);
  q += b * Q;
  out_rate += b * rate_stride;
  caps += b * caps_stride;
  arr += b * Q;
  q_new += b * Q;
  part += b * chunks * static_cast<long long>(Q);
  count += b * gridDim.x;
  const int c = tile * kCols + col;
  const int r0 = chunk * kRows;
  if (threadIdx.x < kRows) {
    const int r = r0 + threadIdx.x;
    lam_s[threadIdx.x] = r < R ? lam[r] : 0.0f;
  }
  __syncthreads();

  float acc = 0.0f;
  if (c < Q) {
    const int rg = r0 + grp * kGroupRows;
    const float* src = onehot + static_cast<long long>(rg) * Q + c;
    float x[kGroupRows];
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      x[i] = rg + i < R ? src[static_cast<long long>(i) * Q] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      acc += lam_s[grp * kGroupRows + i] * x[i];
    }
  }
  group_s[grp][col] = acc;
  __syncthreads();
  if (grp == 0 && c < Q) {
    float s = group_s[0][col];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) s += group_s[g][col];
    part[static_cast<long long>(chunk) * Q + c] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_s = atomicAdd(count + tile, 1u) == static_cast<unsigned>(chunks - 1);
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the tile's combine: group g sums chunks [lo, hi) in chunk order
  const int per = (chunks + kGroups - 1) / kGroups;
  const int lo = min(chunks, grp * per);
  const int hi = min(chunks, lo + per);
  float s = 0.0f;
  if (c < Q) {
#pragma unroll 8
    for (int k = lo; k < hi; ++k) {
      s += __ldcg(part + static_cast<long long>(k) * Q + c);
    }
  }
  group_s[grp][col] = s;
  __syncthreads();
  if (grp == 0 && c < Q) {
    float a = group_s[0][col];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) a += group_s[g][col];
    arr[c] = a;
    q_new[c] = pmin(pmax(q[c] + (a - out_rate[c]) * dt, 0.0f), caps[c]);
  }
  if (threadIdx.x == 0) count[tile] = 0u;
}

}  // namespace

extern "C" int queue_arrivals_tiles(int Q) { return (Q + kCols - 1) / kCols; }

extern "C" int queue_arrivals_chunks(int R) {
  return R > 0 ? (R + kRows - 1) / kRows : 1;
}

// B scenarios of lam [H, F], onehot [H, F, Q], q [Q]; out_rate and caps
// advance by rate_stride / caps_stride per scenario (0: shared). part:
// B * queue_arrivals_chunks(H*F) * Q floats of scratch; count:
// B * queue_arrivals_tiles(Q) zeroed counters (left zeroed on return).
extern "C" int queue_arrivals_f32(const float* lam, const float* onehot,
                                  const float* q, const float* out_rate,
                                  const float* caps, float* arr,
                                  float* q_new, float* part,
                                  unsigned int* count, int B, int H, int F,
                                  int Q, int rate_stride, int caps_stride,
                                  float dt, void* stream) {
  const int R = H * F;
  const dim3 grid(queue_arrivals_tiles(Q), queue_arrivals_chunks(R), B);
  queue_arrivals_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      lam, onehot, q, out_rate, caps, arr, q_new, part, count, R, Q,
      rate_stride, caps_stride, dt);
  return static_cast<int>(cudaGetLastError());
}
