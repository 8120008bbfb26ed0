// RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel rmsnorm (_kernel) of
// src/repro/kernels/rmsnorm.py:
//   y[n, :] = x[n, :] * (1 / sqrt(mean(x[n, :]^2) + eps)) * scale
// with float32 statistics, out in x's dtype (float32 or bfloat16; the
// scale is float32, the wrapper widens a bfloat16 one exactly).
//
// Bound: bytes. Each element is read once from device memory and written
// once (2 flops to square-and-add, 2 to scale); the rows on the serving
// path ([4T, 5120] for the layer norms, [4T*40, 128] and [4T*8, 128] for
// the qk-norms) are far below the card's operations-per-byte line.
//
// Design: a group of G lanes normalizes one row, and the row stays in
// registers between the square sum and the scaling, so it is read from
// device memory once and written once. The row is cut into 16-byte
// vectors of E elements (E = 8 bfloat16 or 4 float32); vector v belongs
// to lane v % G, in its slot v / G, and each lane holds its VPT vectors.
// Wide rows (D >= 1024) take a whole block per row, about four vectors a
// lane (G = 32 * ceil(vectors / 128), at most 512: 160 threads at D =
// 5 120 in bfloat16), so the grid has a block per row and all of a row's
// loads are in flight at once; narrow rows take G lanes of a warp (the
// next power of two >= the row's vectors, at most 32: 16 lanes x 8
// bfloat16 at D = 128, two rows per warp), 256 threads a block. When the
// grid is at most one block per SM (the decode rows), a lane also loads
// its scale with its x, before the reduction, so the scale's round trip
// overlaps the load of x; on a full grid that would cost registers, and
// the scale, read by every row, comes from L1 after the reduction. The
// wrapper plans G, VPT and the prefetch (kernels/rmsnorm.py::plan).
//
// Loads and stores are 16-byte vectors when the row length is a multiple
// of E and every base is 16-byte aligned: x is read and y written with
// the streaming (evict-first) cache hints, since each is touched once,
// and the scale, which every row reads, through the read-only path;
// otherwise the same lanes load and store the same elements one at a
// time. Elements past the row are zero in the registers, and adding
// their +0.0 squares leaves every partial sum as it is.
//
// Sum order, fixed, so results are the same run to run: each lane adds
// the squares of its slots' elements in order (slot 0 element 0 first)
// from +0.0; the lanes of each warp (or of the G-lane group) are added by
// an xor butterfly (offsets 16 or G/2 down to 1, which adds lane l and
// lane l + half as a tree); for G > 32 the warp sums are added in warp
// order through shared memory. The mean is that sum / D, the inverse root
// the IEEE 1.0f / sqrtf (two correctly rounded operations, as PyTorch's
// CPU rsqrt), not the approximate rsqrtf; y = (x * inv) * scale, rounded
// once to bfloat16 where x is bfloat16. tests/test_torch_support.py::
// rmsnorm_in_k6_order spells the same order in torch.
//
// The backward (rmsnorm_bwd_*) stands for jax.grad through the norm
// (src/repro/models/layers.py:124, norm_apply, whose Pallas kernel has no
// backward): given dy, with g = dy * scale and float32 statistics,
//   inv = 1 / sqrt(mean(x^2) + eps),  c = mean(g * x),
//   dx = inv * g - (x * inv^3) * c          (in x's dtype),
//   dscale = sum over rows of (dy * x) * inv (float32).
// Bound: bytes (x and dy read once, dx written once). One launch, no
// float atomics, so the result is the same run to run (the trainer's
// crash/restart is held bit for bit on the card): row chunks a block,
// the next row's loads started before this row's two sums so that memory
// stays in flight, the blocks' float32 dscale partials added in block
// order by the last blocks to finish, each a slice of the columns
// (rmsnorm_bwd_kernel below). tests/test_torch_support.py::
// rmsnorm_bwd_in_k6_order spells the same order in torch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowThreads = 256;
constexpr int kMaxWarps = 16;  // G <= 512
constexpr int kSegs = 8;       // runs of partials a dscale column is cut into
constexpr int kBatch = 16;     // partials a lane loads before adding them

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int E = 4;
  __device__ static float get(const uint4& r, int e) {
    return __uint_as_float((&r.x)[e]);
  }
  __device__ static void put(uint4& r, int e, float v) {
    (&r.x)[e] = __float_as_uint(v);
  }
  __device__ static void put_raw(uint4& r, int e, const float* p) {
    (&r.x)[e] = __float_as_uint(*p);
  }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static float get(const uint4& r, int e) {
    const uint32_t w = (&r.x)[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static void put(uint4& r, int e, float v) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    uint32_t& w = (&r.x)[e >> 1];
    w = (e & 1) ? ((w & 0x0000ffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
  }
  __device__ static void put_raw(uint4& r, int e, const __nv_bfloat16* p) {
    const uint32_t b = __bfloat16_as_ushort(*p);
    uint32_t& w = (&r.x)[e >> 1];
    w = (e & 1) ? ((w & 0x0000ffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// VEC: 16-byte loads and stores (else element at a time); PRE: the scale
// loaded with x (VEC only).
template <typename T, int VPT, bool PRE, bool VEC>
__global__ void __launch_bounds__(512)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, long long N, int D, int G, float eps) {
  using El = Elem<T>;
  constexpr int E = El::E;
  __shared__ float wsum[kMaxWarps];
  const int tid = threadIdx.x;
  // a wide row is the whole block; narrow rows are G-lane groups, G a
  // power of two
  const int lane = G > 32 ? tid : (tid & (G - 1));
  const long long row =
      G > 32 ? static_cast<long long>(blockIdx.x)
             : static_cast<long long>(blockIdx.x) * (blockDim.x / G) + tid / G;
  const bool live = row < N;
  const int nv = (D + E - 1) / E;
  const T* xr = x + (live ? row : 0) * D;
  T* yr = y + (live ? row : 0) * D;

  uint4 r[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = k * G + lane;
    r[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live && v < nv) {
      if (VEC) {
        r[k] = __ldcs(reinterpret_cast<const uint4*>(xr) + v);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (v * E + e < D) El::put_raw(r[k], e, xr + v * E + e);
      }
    }
  }
  float sc[VPT][E];
  if (PRE && VEC) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = k * G + lane;
      if (live && v < nv) {
        const float4* sp = reinterpret_cast<const float4*>(scale + v * E);
#pragma unroll
        for (int j = 0; j < E / 4; ++j) {
          const float4 q = __ldg(sp + j);
          sc[k][4 * j] = q.x;
          sc[k][4 * j + 1] = q.y;
          sc[k][4 * j + 2] = q.z;
          sc[k][4 * j + 3] = q.w;
        }
      }
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float f = El::get(r[k], e);
      acc = acc + f * f;
    }
  }
  for (int off = (G < 32 ? G : 32) >> 1; off > 0; off >>= 1)
    acc = acc + __shfl_xor_sync(kFull, acc, off);
  if (G > 32) {
    if ((tid & 31) == 0) wsum[tid >> 5] = acc;
    __syncthreads();
    acc = wsum[0];
    for (int w = 1; w < G / 32; ++w) acc = acc + wsum[w];
  }
  const float inv = 1.0f / sqrtf(acc / static_cast<float>(D) + eps);

#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = k * G + lane;
    if (!live || v >= nv) continue;
    if (VEC) {
      float s[E];
      if (PRE) {
#pragma unroll
        for (int e = 0; e < E; ++e) s[e] = sc[k][e];
      } else {
        const float4* sp = reinterpret_cast<const float4*>(scale + v * E);
#pragma unroll
        for (int j = 0; j < E / 4; ++j) {
          const float4 q = __ldg(sp + j);
          s[4 * j] = q.x;
          s[4 * j + 1] = q.y;
          s[4 * j + 2] = q.z;
          s[4 * j + 3] = q.w;
        }
      }
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < E; ++e) El::put(o, e, El::get(r[k], e) * inv * s[e]);
      __stcs(reinterpret_cast<uint4*>(yr) + v, o);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (v * E + e < D)
          El::store(yr + v * E + e, El::get(r[k], e) * inv * scale[v * E + e]);
    }
  }
}

template <typename T, int VPT>
int launch_vpt(const T* x, const float* scale, T* y, long long N, int D,
               int G, float eps, int vec, int pre, cudaStream_t stream) {
  const int threads = G > 32 ? G : kNarrowThreads;
  const long long rows = threads / G;
  const unsigned blocks = static_cast<unsigned>((N + rows - 1) / rows);
  if (!vec)
    rmsnorm_kernel<T, VPT, false, false><<<blocks, threads, 0, stream>>>(
        x, scale, y, N, D, G, eps);
  else if (pre)
    rmsnorm_kernel<T, VPT, true, true><<<blocks, threads, 0, stream>>>(
        x, scale, y, N, D, G, eps);
  else
    rmsnorm_kernel<T, VPT, false, true><<<blocks, threads, 0, stream>>>(
        x, scale, y, N, D, G, eps);
  return static_cast<int>(cudaGetLastError());
}

// VPT is the wrapper's plan rounded up to an instantiated width; the
// slots past the row's vectors load nothing. G is a power of two up to a
// warp (narrow rows), or a multiple of 32 up to 512 (a block per row).
template <typename T>
int launch(const T* x, const float* scale, T* y, long long N, int D, int G,
           int vpt, float eps, int vec, int pre, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = G > 32 ? (G <= 512 && G % 32 == 0)
                         : (G >= 1 && (G & (G - 1)) == 0);
  if (!ok) return cudaErrorInvalidValue;
#define K6_VPT(n)                                                       \
  if (vpt <= n)                                                         \
    return launch_vpt<T, n>(x, scale, y, N, D, G, eps, vec, pre, s);
  K6_VPT(1) K6_VPT(2) K6_VPT(3) K6_VPT(4) K6_VPT(5) K6_VPT(6) K6_VPT(8)
  K6_VPT(10) K6_VPT(12) K6_VPT(16)
#undef K6_VPT
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------

template <typename T, int VPT, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, uint4* r,
                                         int lane, int G, int nv, int D,
                                         bool live) {
  using El = Elem<T>;
  constexpr int E = El::E;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = k * G + lane;
    r[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live && v < nv) {
      if (VEC) {
        r[k] = __ldcs(reinterpret_cast<const uint4*>(p) + v);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (v * E + e < D) El::put_raw(r[k], e, p + v * E + e);
      }
    }
  }
}

// The scale of vector v (0 past the row): 16-byte loads where VEC, read
// through L1, where every row's lanes find it.
template <int E, bool VEC>
__device__ __forceinline__ void load_scale(const float* __restrict__ scale,
                                           int v, int nv, int D,
                                           float (&s)[E]) {
  if (VEC && v < nv) {
    const float4* sp = reinterpret_cast<const float4*>(scale + v * E);
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const float4 q = __ldg(sp + j);
      s[4 * j] = q.x;
      s[4 * j + 1] = q.y;
      s[4 * j + 2] = q.z;
      s[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = v * E + e;
      s[e] = (v < nv && c < D) ? __ldg(scale + c) : 0.0f;
    }
  }
}

// The sum of a (and of b) over the G lanes of a group (G <= 32: the xor
// butterfly) or over the block (G > 32: each warp's butterfly, then the
// warps in warp order through ws[2][kMaxWarps]).
__device__ __forceinline__ void group_sum2(float* a, float* b, int G,
                                           int tid, float (*ws)[kMaxWarps]) {
  for (int off = (G < 32 ? G : 32) >> 1; off > 0; off >>= 1) {
    *a = *a + __shfl_xor_sync(kFull, *a, off);
    *b = *b + __shfl_xor_sync(kFull, *b, off);
  }
  if (G > 32) {
    __syncthreads();    // the previous row's sums are read
    if ((tid & 31) == 0) {
      ws[0][tid >> 5] = *a;
      ws[1][tid >> 5] = *b;
    }
    __syncthreads();
    *a = ws[0][0];
    *b = ws[1][0];
    for (int w = 1; w < G / 32; ++w) {
      *a = *a + ws[0][w];
      *b = *b + ws[1][w];
    }
  }
}

// One launch. The grid cuts the rows into contiguous chunks of R, one
// chunk a block; the lanes keep the forward's plan, so a lane owns the
// same columns in every row (their scale read through L1 where it is
// used: in registers it would push the row buffers into local memory)
// and adds its columns' dscale terms over its rows in row order. A wide row is the
// whole block and the block walks its chunk row by row; narrow rows go to
// the block's groups in turn (group i: rows i, i + groups, ...). Each
// round starts the next round's loads of x and dy before this round's two
// sums (of x^2, of g * x, in the forward's order: lane slots in order,
// the xor butterfly, the warps in warp order), so a row's loads are in
// flight while the previous row reduces. The block's groups add their
// dscale partials in group order through shared memory and the block
// writes one float32 partial row [D]. Then each block takes a ticket; the
// last K to finish wait for the rest (K is at most half the blocks the
// card holds at once, so the blocks still to run always find room) and
// split the columns: a column's P partials are cut into kSegs runs of
// blocks in order, a lane adds each run from +0.0 in block order (loading
// kBatch at a time, so that many loads are in flight), and the runs are
// added in run order. The last of the K resets the two counters.
template <typename T, int VPT, bool VEC>
__global__ void __launch_bounds__(512)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ part, float* __restrict__ dscale,
                   unsigned* __restrict__ count, long long N, int D, int G,
                   int R, int K, float eps) {
  using El = Elem<T>;
  constexpr int E = El::E;
  __shared__ float ws[2][kMaxWarps];
  __shared__ unsigned ticket;
  extern __shared__ float gpart[];          // [groups][D] (narrow rows)
  const int tid = threadIdx.x;
  const int lane = G > 32 ? tid : (tid & (G - 1));
  const int group = G > 32 ? 0 : tid / G;
  const int groups = G > 32 ? 1 : blockDim.x / G;
  const int nv = (D + E - 1) / E;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const long long r1 = min(r0 + R, N);

  float acc[VPT][E];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.0f;
  }
  // every group runs the same number of rounds (the butterfly and the
  // block's barriers take all lanes); a round past the chunk is dead
  const long long rounds = (R + groups - 1) / groups;
  uint4 xr[VPT], gr[VPT], xn[VPT], gn[VPT];
  {
    const long long row = r0 + group;
    const long long off = (row < r1 ? row : 0) * D;
    load_row<T, VPT, VEC>(x + off, xr, lane, G, nv, D, row < r1);
    load_row<T, VPT, VEC>(dy + off, gr, lane, G, nv, D, row < r1);
  }
  for (long long i = 0; i < rounds; ++i) {
    const long long row = r0 + i * groups + group;
    const bool live = row < r1;
    const long long off = (live ? row : 0) * D;
    const bool more = i + 1 < rounds;
    if (more) {
      const long long nrow = row + groups;
      const long long noff = (nrow < r1 ? nrow : 0) * D;
      load_row<T, VPT, VEC>(x + noff, xn, lane, G, nv, D, nrow < r1);
      load_row<T, VPT, VEC>(dy + noff, gn, lane, G, nv, D, nrow < r1);
    }
    float ss = 0.0f, gx = 0.0f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float f = El::get(xr[k], e);
        ss = ss + f * f;
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      float sc[E];
      load_scale<E, VEC>(scale, k * G + lane, nv, D, sc);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        gx = gx + (El::get(gr[k], e) * sc[e]) * El::get(xr[k], e);
      }
    }
    group_sum2(&ss, &gx, G, tid, ws);
    const float inv = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
    const float c = gx / static_cast<float>(D);
    const float inv3 = (inv * inv) * inv;
    if (live) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = k * G + lane;
        if (v >= nv) continue;
        float sc[E];
        load_scale<E, VEC>(scale, v, nv, D, sc);
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xf = El::get(xr[k], e), dyf = El::get(gr[k], e);
          const float g = dyf * sc[e];
          const float d = inv * g - (xf * inv3) * c;
          acc[k][e] = acc[k][e] + (dyf * xf) * inv;
          if (VEC) {
            El::put(o, e, d);
          } else if (v * E + e < D) {
            El::store(dx + off + v * E + e, d);
          }
        }
        if (VEC) __stcs(reinterpret_cast<uint4*>(dx + off) + v, o);
      }
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        xr[k] = xn[k];
        gr[k] = gn[k];
      }
    }
  }
  // the groups' partials in group order; a wide row's block has one group
  float* out = part + static_cast<long long>(blockIdx.x) * D;
  if (groups == 1) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = k * G + lane;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (v < nv && v * E + e < D) out[v * E + e] = acc[k][e];
    }
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = k * G + lane;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (v < nv && v * E + e < D) gpart[group * D + v * E + e] = acc[k][e];
    }
    __syncthreads();
    for (int c = tid; c < D; c += blockDim.x) {
      float s = gpart[c];
      for (int q = 1; q < groups; ++q) s = s + gpart[q * D + c];
      out[c] = s;
    }
  }

  // dscale: the last K blocks add the partials
  const unsigned P = gridDim.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    ticket = atomicAdd(count, 1u);
    if (ticket + K >= P) {
      while (*reinterpret_cast<volatile unsigned*>(count) < P) __nanosleep(64);
    }
  }
  __syncthreads();
  if (ticket + K < P) return;
  __threadfence();
  const int j = static_cast<int>(ticket + K - P);   // 0 .. K - 1
  const int per = (D + K - 1) / K;
  const int cbeg = j * per, cend = min(D, cbeg + per);
  const int seg = tid % kSegs;
  const unsigned lo = P * seg / kSegs, hi = P * (seg + 1) / kSegs;
  // all lanes of a warp run the same rounds (the shuffles take them all)
  const int cols = blockDim.x / kSegs;
  for (int base = cbeg; base < cend; base += cols) {
    const int c = base + tid / kSegs;
    float s = 0.0f;
    if (c < cend) {
      unsigned p = lo;
      for (; p + kBatch <= hi; p += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] = __ldcg(part + static_cast<long long>(p + u) * D + c);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) s = s + v[u];
      }
      for (; p < hi; ++p) {
        s = s + __ldcg(part + static_cast<long long>(p) * D + c);
      }
    }
    float t = s;
#pragma unroll
    for (int q = 1; q < kSegs; ++q) {
      const float u = __shfl_down_sync(kFull, s, q);
      t = t + u;
    }
    if (seg == 0 && c < cend) dscale[c] = t;
  }
  __syncthreads();
  if (tid == 0 && atomicAdd(count + 1, 1u) == static_cast<unsigned>(K) - 1u) {
    count[0] = 0u;
    count[1] = 0u;
  }
}

template <typename T, int VPT, bool VEC>
int launch_bwd_kernel(const T* x, const float* scale, const T* dy, T* dx,
                      float* part, float* dscale, unsigned* count,
                      long long N, int D, int G, int R, float eps,
                      cudaStream_t stream) {
  const auto kernel = rmsnorm_bwd_kernel<T, VPT, VEC>;
  const int threads = G > 32 ? G : kNarrowThreads;
  const int groups = G > 32 ? 1 : kNarrowThreads / G;
  const long long blocks = (N + R - 1) / R;
  const int smem = groups > 1 ? groups * D * static_cast<int>(sizeof(float))
                              : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the adding blocks: half of those the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int K = static_cast<int>(
      blocks < per_sm * sms / 2 ? blocks : max(1, per_sm * sms / 2));
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x, scale, dy, dx, part, dscale, count, N, D, G, R, K, eps);
  return static_cast<int>(cudaGetLastError());
}

// part: ceil(N / R) * D floats of scratch; dscale: D floats; count: two
// zeroed counters (left zeroed).
template <typename T>
int launch_bwd(const T* x, const float* scale, const T* dy, T* dx,
               float* part, float* dscale, unsigned* count, long long N, int D,
               int G, int vpt, int R, float eps, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = (G > 32 ? (G <= 512 && G % 32 == 0)
                          : (G >= 1 && (G & (G - 1)) == 0)) && R >= 1;
  if (!ok) return cudaErrorInvalidValue;
#define K6B_VPT(n)                                                         \
  if (vpt <= n)                                                            \
    return vec ? launch_bwd_kernel<T, n, true>(x, scale, dy, dx, part,     \
                                               dscale, count, N, D, G, R,  \
                                               eps, s)                     \
               : launch_bwd_kernel<T, n, false>(x, scale, dy, dx, part,    \
                                                dscale, count, N, D, G, R, \
                                                eps, s);
  K6B_VPT(1) K6B_VPT(2) K6B_VPT(4) K6B_VPT(8)
#undef K6B_VPT
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rmsnorm_f32(const float* x, const float* scale, float* y,
                           long long N, int D, int G, int vpt, float eps,
                           int vec, int pre, void* stream) {
  return launch(x, scale, y, N, D, G, vpt, eps, vec, pre, stream);
}

extern "C" int rmsnorm_bf16(const __nv_bfloat16* x, const float* scale,
                            __nv_bfloat16* y, long long N, int D, int G,
                            int vpt, float eps, int vec, int pre,
                            void* stream) {
  return launch(x, scale, y, N, D, G, vpt, eps, vec, pre, stream);
}

extern "C" int rmsnorm_bwd_f32(const float* x, const float* scale,
                               const float* dy, float* dx, float* part,
                               float* dscale, unsigned* count, long long N,
                               int D, int G, int vpt, int R, float eps,
                               int vec, void* stream) {
  return launch_bwd(x, scale, dy, dx, part, dscale, count, N, D, G, vpt, R,
                    eps, vec, stream);
}

extern "C" int rmsnorm_bwd_bf16(const __nv_bfloat16* x, const float* scale,
                                const __nv_bfloat16* dy, __nv_bfloat16* dx,
                                float* part, float* dscale, unsigned* count,
                                long long N, int D, int G, int vpt, int R,
                                float eps, int vec, void* stream) {
  return launch_bwd(x, scale, dy, dx, part, dscale, count, N, D, G, vpt, R,
                    eps, vec, stream);
}
