// Blockwise (flash) attention forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas kernel flash_attention (_kernel) of
// src/repro/kernels/flash_attention.py: q [B, H, T, D], k/v [B, KV, S, D]
// (query head h reads kv head h / (H / KV)), out [B, H, T, D] in q's
// dtype; causal attention puts the queries at the last T of the S
// positions (off = S - T: query t sees keys j <= t + off, and with a
// window w > 0 only keys j > t + off - w); without causal every key is
// seen. Scores s = (q . k) * scale, an online softmax with a float32
// running max m, denominator l and accumulator, finalized as
// acc / max(l, 1e-30) with masked probabilities zeroed, so a row whose
// every key is masked gives 0 (as the TPU kernel does). Head dims 16 and
// the multiples of 32 up to 256 are built. Inputs float32 or
// bfloat16 (widened to float32 on load); every tensor may be strided
// except along D (the wrapper passes element strides), so the model's
// [B, T, H, D] activations and its [B, S, KV, D] cache are read in place.
//
// Two forms, chosen by the wrapper's T:
//
// * tiled (prefill, T > kSplitMaxT): one block of kBQ = 16 warps per
//   (b, h, tile of 16 query rows), one warp per query row. Key tiles of
//   kBK = 32 keys are staged in shared memory as float32 (K rows padded
//   to D + 1 floats so that lane j reading key j's row hits 32 banks);
//   lane j scores key j against the warp's query row, the warp takes the
//   tile's max and sum by a fixed xor butterfly, and each lane then owns
//   D / 32 columns of the accumulator, adding p_j * v_j over j = 0..31 in
//   order (p_j broadcast by a shuffle). Only the key tiles some row of the
//   block can see are loaded (causal and window skip), and a warp skips a
//   loaded tile its own row cannot see.
// * split (decode, T <= kSplitMaxT): one block of kSplitWarps = 8 warps
//   per (b, h, query row). The visible keys go in chunks of 32 to the
//   warps in turn; lane l owns columns l, l + 32, ... of q, k and v, so a
//   warp reads each key row with consecutive addresses. A warp scores its
//   chunk one key at a time (partial dot, butterfly sum) and then updates
//   its own m, l and accumulator as the tiled form does; the warps' states
//   are merged in warp order at the end.
//
// Every sum runs in a fixed order, so the result is the same from run to
// run. No tensor cores, TMA or wgmma: this form is meant to be right and
// simple. Bound: bytes at the serving shapes. The prefill (T = S = 512,
// head_dim 128) does 4 * D flops per visible query-key pair, about 214
// flops per byte of q, k, v and output, below the ~295 at which the bf16
// tensor cores rather than the memory would limit; the decode reads the
// visible part of the cache once for 4 * D * S flops per head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The launch's arguments, passed by pointer from the wrapper (a ctypes
// structure of the same layout). Outside the unnamed namespace so that
// the extern "C" entry points taking it keep external linkage.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_st;    // element strides (the D stride is 1)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_st;
  int B, H, KV, T, S, D;
  int causal, window;
  float scale;
};

namespace {

using Args = FlashArgs;

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 16;          // query rows (warps) per tiled block
constexpr int kBK = 32;          // keys per tile
constexpr int kSplitWarps = 8;   // warps per split block
constexpr int kSplitMaxT = 4;    // the split form serves T <= this

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Whether lane owns column lane + 32 i (every lane does when 32 | D).
template <int D>
__device__ __forceinline__ bool has_col(int lane, int i) {
  return D % 32 == 0 || lane + 32 * i < D;
}

// The keys [lo, hi) that query row t may see.
__device__ __forceinline__ void visible(const Args& a, int t, int* lo,
                                        int* hi) {
  *lo = 0;
  *hi = a.S;
  if (a.causal) {
    const int pos = t + (a.S - a.T);
    *hi = min(a.S, pos + 1);
    if (a.window > 0) *lo = max(0, pos - a.window + 1);
  }
}

// One online-softmax step of a warp over a chunk of 32 keys: lane j holds
// the score s of key `base + j` (already masked to kNegInf where it is
// not visible). Updates m, l and the lane's columns of acc with p_j * v_j
// summed over the chunk in key order.
template <typename Tin, int D>
__device__ __forceinline__ void online_step(float s, bool valid, float* m,
                                            float* l, float* acc,
                                            const float* vs, int vstride,
                                            const Tin* vg, long long v_ss,
                                            int base, int nkeys, int lane) {
  constexpr int DPL = (D + 31) / 32;
  const float m_new = fmaxf(*m, warp_max(s));
  const float p = valid ? expf(s - m_new) : 0.0f;
  const float alpha = expf(*m - m_new);
  *l = *l * alpha + warp_sum(p);
  float pv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) pv[i] = 0.0f;
  for (int j = 0; j < nkeys; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    if (vs != nullptr) {
      const float* vr = vs + j * vstride + lane;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        if (has_col<D>(lane, i)) pv[i] += pj * vr[32 * i];
      }
    } else {
      const Tin* vr = vg + static_cast<long long>(base + j) * v_ss + lane;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        if (has_col<D>(lane, i)) pv[i] += pj * to_f32(vr[32 * i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = acc[i] * alpha + pv[i];
  *m = m_new;
}

template <typename Tin, int D>
__global__ void __launch_bounds__(kBQ * 32)
    flash_tiled(const Args a) {
  constexpr int DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* ks = smem;                         // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);           // [kBK][D]
  float* qs = vs + kBK * D;                 // [kBQ][D]
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / (a.H / a.KV);
  const Tin* qg = static_cast<const Tin*>(a.q) + b * a.q_sb + h * a.q_sh;
  const Tin* kg = static_cast<const Tin*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const Tin* vg = static_cast<const Tin*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    qs[idx] = (q0 + r < a.T)
                  ? to_f32(qg[static_cast<long long>(q0 + r) * a.q_st + c])
                  : 0.0f;
  }
  // the keys some row of this block sees: from the first row's first
  // visible key to the last row's last
  int blo, bhi, lo, hi;
  visible(a, q0, &blo, &hi);
  visible(a, min(q0 + kBQ, a.T) - 1, &lo, &bhi);
  const int t = q0 + w;
  const bool row = t < a.T;
  visible(a, t, &lo, &hi);

  float m = kNegInf, l = 0.0f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.0f;
  for (int k0 = (blo / kBK) * kBK; k0 < bhi; k0 += kBK) {
    __syncthreads();    // the previous tile is consumed (and q is staged)
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D;
      const int key = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (key < a.S) {
        kx = to_f32(kg[static_cast<long long>(key) * a.k_ss + c]);
        vx = to_f32(vg[static_cast<long long>(key) * a.v_ss + c]);
      }
      ks[r * (D + 1) + c] = kx;
      vs[r * D + c] = vx;
    }
    __syncthreads();
    if (!row || k0 >= hi || k0 + kBK <= lo) continue;   // warp-uniform
    const float* qr = qs + w * D;
    const float* kr = ks + lane * (D + 1);
    float s = 0.0f;
    for (int c = 0; c < D; ++c) s += qr[c] * kr[c];
    const int key = k0 + lane;
    const bool valid = key >= lo && key < hi;
    s = valid ? s * a.scale : kNegInf;
    online_step<Tin, D>(s, valid, &m, &l, acc, vs, D, nullptr, 0, k0, kBK,
                        lane);
  }
  if (!row) return;
  const float denom = fmaxf(l, 1e-30f);
  Tin* og = static_cast<Tin*>(a.o) + b * a.o_sb + h * a.o_sh +
            static_cast<long long>(t) * a.o_st;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    if (has_col<D>(lane, i)) store(og + lane + 32 * i, acc[i] / denom);
  }
}

template <typename Tin, int D>
__global__ void __launch_bounds__(kSplitWarps * 32)
    flash_split(const Args a) {
  constexpr int DPL = (D + 31) / 32;
  __shared__ float red_m[kSplitWarps];
  __shared__ float red_l[kSplitWarps];
  __shared__ float red_acc[kSplitWarps][D];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const Tin* qg = static_cast<const Tin*>(a.q) + b * a.q_sb + h * a.q_sh +
                  static_cast<long long>(t) * a.q_st;
  const Tin* kg = static_cast<const Tin*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const Tin* vg = static_cast<const Tin*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qv[i] = has_col<D>(lane, i) ? to_f32(qg[lane + 32 * i]) : 0.0f;
  }
  int lo, hi;
  visible(a, t, &lo, &hi);

  float m = kNegInf, l = 0.0f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.0f;
  for (int base = (lo / 32) * 32 + w * 32; base < hi;
       base += kSplitWarps * 32) {
    const int nkeys = min(32, hi - base);
    float s_mine = kNegInf;
    for (int j = 0; j < nkeys; ++j) {
      const Tin* kr = kg + static_cast<long long>(base + j) * a.k_ss + lane;
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        if (has_col<D>(lane, i)) part += qv[i] * to_f32(kr[32 * i]);
      }
      part = warp_sum(part);
      if (lane == j) s_mine = part;
    }
    const int key = base + lane;
    const bool valid = key >= lo && key < hi;
    const float s = valid ? s_mine * a.scale : kNegInf;
    online_step<Tin, D>(s, valid, &m, &l, acc, nullptr, 0, vg, a.v_ss,
                        base, nkeys, lane);
  }
  if (lane == 0) {
    red_m[w] = m;
    red_l[w] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    if (has_col<D>(lane, i)) red_acc[w][lane + 32 * i] = acc[i];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int u = 0; u < kSplitWarps; ++u) mx = fmaxf(mx, red_m[u]);
  Tin* og = static_cast<Tin*>(a.o) + b * a.o_sb + h * a.o_sh +
            static_cast<long long>(t) * a.o_st;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float lsum = 0.0f, num = 0.0f;
    for (int u = 0; u < kSplitWarps; ++u) {
      const float f = expf(red_m[u] - mx);
      lsum += red_l[u] * f;
      num += red_acc[u][d] * f;
    }
    store(og + d, num / fmaxf(lsum, 1e-30f));
  }
}

template <typename Tin, int D>
int launch_d(const Args& a, cudaStream_t stream) {
  if (a.T <= kSplitMaxT) {
    flash_split<Tin, D><<<dim3(a.T, a.H, a.B), kSplitWarps * 32, 0,
                          stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = (kBK * (D + 1) + kBK * D + kBQ * D) *
                   static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tiled<Tin, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_tiled<Tin, D><<<dim3((a.T + kBQ - 1) / kBQ, a.H, a.B), kBQ * 32,
                        smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch(const Args* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 16: return launch_d<Tin, 16>(*a, s);
    case 32: return launch_d<Tin, 32>(*a, s);
    case 64: return launch_d<Tin, 64>(*a, s);
    case 96: return launch_d<Tin, 96>(*a, s);
    case 128: return launch_d<Tin, 128>(*a, s);
    case 160: return launch_d<Tin, 160>(*a, s);
    case 192: return launch_d<Tin, 192>(*a, s);
    case 224: return launch_d<Tin, 224>(*a, s);
    case 256: return launch_d<Tin, 256>(*a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const FlashArgs* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int flash_attention_bf16(const FlashArgs* a, void* stream) {
  return launch<__nv_bfloat16>(a, stream);
}
