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
// every key is masked gives 0 (as the TPU kernel does). Head dims 16, 80
// and the multiples of 32 up to 256 are built. Every tensor may be strided
// except along D (the wrapper passes element strides), so the model's
// [B, T, H, D] activations and its [B, S, KV, D] cache are read in place.
//
// Bound: bytes at the serving shapes. The prefill (T = S = 512, head_dim
// 128) does 4 * D flops per visible query-key pair, about 214 flops per
// byte of q, k, v and output, below the ~295 at which the bf16 tensor
// cores rather than the memory would limit; the decode reads the visible
// part of the cache once for 4 * D * S flops per kv head group.
//
// bfloat16 inputs (the serve path) run on the tensor cores, in two forms
// chosen by the wrapper's T:
//
// * tiled_mma (prefill, T > kSplitMaxT), the FlashAttention-2 pattern on
//   mma.sync m16n8k16 (bf16 in, float32 accumulate): a block of 4 warps
//   takes 64 query rows, 16 a warp; its Q tile stays in shared memory and
//   each tile reads its A fragments by ldmatrix. Tiles of 32 keys of K
//   and V are staged as bf16 by 16-byte cp.async copies, double
//   buffered, so the next tile's load overlaps this tile's products; each
//   shared row is padded by 16 bytes (an odd number of 16-byte units), so
//   ldmatrix reads 8 rows on 8 distinct bank groups. S = Q K^T comes from
//   ldmatrix'd K; the products of bf16 values are exact in float32, so
//   only the sum order differs from the plain version. The online softmax
//   runs on the accumulator fragments (2^x by ex2.approx): a row's max and
//   sum are reduced over its 4-thread quad with two shuffles each. P V
//   takes P from registers as the A operand and V through ldmatrix.trans;
//   P is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and two
//   mma's add p_hi V + p_lo V, so P keeps ~16 bits of its float32
//   precision. Only the key tiles some row of the block sees are loaded,
//   a warp skips a tile its 16 rows do not see, the element mask runs
//   only on tiles that straddle a row's visible-range edge, and the query
//   tiles with the most keys are launched first, so causal imbalance
//   leaves no tail. At the serve shape the tensor cores (with the second
//   P V product) and the exp2 of the scores, not the bytes, set the time:
//   32-key tiles (52 KB of shared memory) and at most 170 registers (Q
//   read from shared memory, not held in registers) let three blocks
//   share an SM, which measured faster on the H100 than 64-key tiles or
//   Q fragments in registers with two.
// * split_mma (decode, T <= kSplitMaxT), split-KV over the whole GQA
//   group: one block per (b, kv head, split of kSplitKeys = 64 keys)
//   serves all G * T query rows of the group (padded to 16-row mma
//   tiles), so each cached key is read once per group, not once per
//   query head; at the serve shape (543 positions) that is 9 splits and
//   288 blocks. It stages its keys by cp.async, each warp scores 16 keys
//   against all rows at once on the tensor cores (no per-key dependent
//   chain), takes their softmax and p_hi/p_lo P V, the block merges its
//   4 warps in warp order and writes a partial (m, l, acc) per row to a
//   scratch buffer. The last block of each (b, kv head) to finish,
//   elected by a counter taken with atomicAdd after __threadfence (the
//   block resets it to 0, so launches and CUDA graph replays find it
//   zeroed), merges the splits in split order and writes the output;
//   its loads are spread over eight elements a thread so that many are
//   in flight, since this combine is a chain of L2 round trips at the
//   end of the launch (PERF.md).
//
// float32 inputs keep the first port's scalar forms, tiled and split
// below, held to the plain version at 2e-5. This is a dispatch on dtype,
// not a fallback: the serve path is bf16 and never reaches them, and
// float32 on the tensor cores would mean TF32, which would break that
// bar.
//   - tiled: one block of kBQ = 16 warps per (b, h, tile of 16 query
//     rows), one warp per query row; key tiles of kBK = 32 keys staged as
//     float32, lane j scores key j, each lane then owns D / 32 columns
//     of the accumulator (p_j broadcast by a shuffle).
//   - split: one block of kSplitWarps = 8 warps per (b, h, query row);
//     the visible keys go in chunks of 32 to the warps in turn, each warp
//     keeps its own m, l and accumulator, merged in warp order.
//
// Every sum runs in a fixed order and the only atomic elects a block, so
// the result is the same from run to run.
//
// Training: with FlashArgs::lse set, the tiled forms (which then serve
// every T) also write each query row's float32 log-sum-exp, and the
// backward kernels below (FlashBwdArgs) recompute P from it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

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
  float* part;            // split_mma's partials: [rows, D] then [rows, 2]
  unsigned int* count;    // split_mma's B * KV zeroed election counters
  float* lse;             // null, or [B, H, T] float32: each row's
                          // log-sum-exp of its scaled scores (the tiled
                          // forms then serve every T)
};

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------
//
// Stands for jax.grad through the attention (the Pallas kernel has no
// backward; src/repro/models/layers.py:200, _sdpa, is what repro
// differentiates). Given the forward's output o, its float32 log-sum-exp
// lse [B, H, T] and the output's gradient do:
//   p = exp(s - lse) (0 where masked), delta = rowsum(do * o),
//   ds = p * (dp - delta) with dp = do . v,
//   dq = scale * ds K,  dk = scale * ds^T Q,  dv = p^T dO,
// dk and dv summed over the G query heads of a kv head. The forward's
// masks: causal, causal with a sliding window w > 0 (query t sees keys
// t + off - w < j <= t + off, off = S - T), or none. Two kernels,
// launched in this order on the stream, neither with a float atomic,
// each sum in a fixed order (the same bits run to run):
// * dq: one block per (b, head, query tile); it first takes delta for its
//   rows (written to a [B, H, T] buffer for the second kernel), then walks
//   in order the key tiles some row of the block sees (with a window,
//   those of [t0 + off - w + 1, t1 + off] for its rows t0..t1), adding
//   ds K into registers;
// * dk/dv: one block per (b, kv head, key tile, chunk of the group's query
//   heads); it walks its chunk's heads in ascending order and, for each,
//   in order the query tiles that see some key of the tile (with a window,
//   those of [j0 - off, j1 - off + w - 1] for its keys j0..j1), adding
//   ds^T Q and p^T dO into registers; the chunks' float32 partials are
//   added in chunk order by the last of the tile's blocks to finish.
// Both mask element by element only a tile that straddles an edge of a
// row's (key's) visible range.
// Bound at the training shape (T = S = 1 024, D = 128, causal): about
// 10 D flops per visible pair (five products) over the bytes of q, k, v,
// o, do and the three gradients, ~1 300 flops a byte: the tensor cores.
// bfloat16 runs on Hopper's wgmma (below: 64-row tiles a warpgroup,
// operands by TMA, the group's heads spread over the SMs in chunks so
// that every GQA ratio fills the card, P and dS rounded once to bf16, dq
// recomputing S and dP: seven products per pair for the bound's five);
// float32 runs scalar CUDA-core forms, a warp a query row (dq) or a key
// row (dk/dv), lane j taking key (query) j of a 32-wide tile.

struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;     // [B, H, T]
  float* delta;         // [B, H, T], written by the dq kernel
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_st;   // element strides (the D stride is 1)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_st;
  long long do_sb, do_sh, do_st;
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int B, H, KV, T, S, D;
  int causal, window;
  float scale;
  // bf16 dk/dv: the query heads of a chunk, and where G / hpc > 1 the
  // chunks' float32 partials ([chunks][units][2][64][min(D, 128)], units =
  // B * KV * ceil(S / 64) * max(1, D / 128)) and `units` zeroed counters
  int hpc;
  float* part;
  unsigned int* count;
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
  if (a.lse != nullptr && lane == 0) {
    a.lse[(static_cast<long long>(b) * a.H + h) * a.T + t] = m + logf(l);
  }
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
  if (a.T <= kSplitMaxT && a.lse == nullptr) {
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

// ---------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTileQ = 64;        // query rows per tiled_mma block
constexpr int kTiledWarps = kTileQ / 16;       // 16 query rows a warp
constexpr int kSplitKeys = 64;    // keys per split_mma block
constexpr int kSplitMmaWarps = kSplitKeys / 16;   // 16 keys a warp
constexpr int kCombine = 8;       // elements a combining thread sums at once
constexpr int kLanesPerRow = 8;   // lanes a row in the combine's (M, L)
constexpr int kRowsPerWarp = 32 / kLanesPerRow;

// 2^x by the MUFU unit (relative error ~2^-22; results below 2^-126 flush
// to 0, which only the probabilities of keys far below the row's max
// reach).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes where !ok (src is then
// not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// p_hi = bf16(p) and p_lo = bf16(p - p_hi) of two neighbouring p's.
__device__ __forceinline__ void split_pair(float x, float y, unsigned* hi,
                                           unsigned* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  *hi = bits(h);
  *lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments p_hi and p_lo of a 16 x 16 block of P held as two
// 16 x 8 accumulator fragments (keys 0-7 and 8-15).
__device__ __forceinline__ void split_p(const float (&s0)[4],
                                        const float (&s1)[4], unsigned* hi,
                                        unsigned* lo) {
  split_pair(s0[0], s0[1], hi + 0, lo + 0);
  split_pair(s0[2], s0[3], hi + 1, lo + 1);
  split_pair(s1[0], s1[1], hi + 2, lo + 2);
  split_pair(s1[2], s1[3], hi + 3, lo + 3);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The A fragment of rows 0-15, columns 16 kk .. 16 kk + 15 of a bf16 tile
// in shared memory with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(unsigned* a, const bf16* tile,
                                       int kk, int lane) {
  ldsm_x4(a, tile + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + 16 * kk +
                 ((lane >> 4) & 1) * 8);
}

// s[0..1] += A (16 x 16) * K^T for keys key0 .. key0 + 15 of a K tile,
// columns 16 kk .. 16 kk + 15.
template <int LD>
__device__ __forceinline__ void mma_qk(float (*s)[4], const unsigned* a,
                                       const bf16* ks, int key0, int kk,
                                       int lane) {
  unsigned b[4];
  ldsm_x4(b, ks + (key0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LD +
                 16 * kk + ((lane >> 3) & 1) * 8);
  mma16816(s[0], a, b[0], b[1]);
  mma16816(s[1], a, b[2], b[3]);
}

// o += (p_hi + p_lo) (16 x 16) * V for keys key0 .. key0 + 15 of a V
// tile, every column.
template <int D, int LD>
__device__ __forceinline__ void mma_pv(float (*o)[4], const unsigned* hi,
                                       const unsigned* lo, const bf16* vs,
                                       int key0, int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    unsigned b[4];
    ldsm_x4_trans(b, vs + (key0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                         16 * np + ((lane >> 4) & 1) * 8);
    mma16816(o[2 * np], hi, b[0], b[1]);
    mma16816(o[2 * np + 1], hi, b[2], b[3]);
    mma16816(o[2 * np], lo, b[0], b[1]);
    mma16816(o[2 * np + 1], lo, b[2], b[3]);
  }
}

template <int D>
struct TiledMma {
  static constexpr int BK = 32;                  // keys per tile
  static constexpr int LD = D + 8;               // shared row stride
  static constexpr int kSmem = (kTileQ + 4 * BK) * LD * 2;
};

template <int D>
__global__ void __launch_bounds__(kTiledWarps * 32, 3)
    flash_tiled_mma(const Args a) {
  using C = TiledMma<D>;
  constexpr int BK = C::BK, LD = C::LD, NS = BK / 8, ND = D / 8;
  constexpr int KD = D / 16, CH = D / 8;      // k steps, 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // [kTileQ][LD]
  bf16* ks = qs + kTileQ * LD;                      // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                      // [2][BK][LD]
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTileQ;   // heaviest first
  const int kvh = h / (a.H / a.KV);
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb +
                   kvh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb +
                   kvh * a.v_sh;
  const float sc = a.scale * kLog2e;

  // the keys some row of the block sees, and those of this warp's rows
  int blo, bhi, lo, hi;
  visible(a, q0, &blo, &hi);
  visible(a, min(q0 + kTileQ, a.T) - 1, &lo, &bhi);
  const int r0 = q0 + 16 * w;
  const bool active = r0 < a.T;
  int lo_min, hi_min, lo_max, hi_max;
  visible(a, min(r0, a.T - 1), &lo_min, &hi_min);
  visible(a, min(r0 + 15, a.T - 1), &lo_max, &hi_max);
  int rlo[2], rhi[2];
  visible(a, r0 + g, &rlo[0], &rhi[0]);
  visible(a, r0 + g + 8, &rlo[1], &rhi[1]);

  for (int i = tid; i < kTileQ * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH, t = q0 + r;
    const bool ok = t < a.T;
    cp_async16(qs + r * LD + c * 8,
               ok ? qg + static_cast<long long>(t) * a.q_st + c * 8 : qg,
               ok);
  }
  auto load_kv = [&](int k0, int buf) {
    bf16* kd = ks + buf * BK * LD;
    bf16* vd = vs + buf * BK * LD;
    for (int i = tid; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const bool ok = key < a.S;
      const long long kk = static_cast<long long>(key);
      cp_async16(kd + r * LD + c * 8, ok ? kg + kk * a.k_ss + c * 8 : kg,
                 ok);
      cp_async16(vd + r * LD + c * 8, ok ? vg + kk * a.v_ss + c * 8 : vg,
                 ok);
    }
  };
  // the first group holds Q and the first tile, then one group a tile
  const int kbeg = (blo / BK) * BK;
  load_kv(kbeg, 0);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  int buf = 0;
  for (int k0 = kbeg; k0 < bhi; k0 += BK, buf ^= 1) {
    if (k0 + BK < bhi) load_kv(k0 + BK, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();        // this tile (and, at the first, Q) is staged
    if (active && k0 < hi_max && k0 + BK > lo_min) {
      const bf16* kt = ks + buf * BK * LD;
      const bf16* vt = vs + buf * BK * LD;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned qa[4];
        load_a<LD>(qa, qs + 16 * w * LD, kk, lane);
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          mma_qk<LD>(s + j, qa, kt, 8 * j, kk, lane);
        }
      }
      // scale; the element mask only where the tile crosses an edge of
      // some row's visible range
      const bool full = k0 >= lo_max && k0 + BK <= hi_min;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tig + (e & 1);
          const int r = e >> 1;
          const bool ok = full || (key >= rlo[r] && key < rhi[r]);
          s[j][e] = ok ? s[j][e] * sc : kNegInf;
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        }
        mx = quad_max(mx);
        alpha[r] = exp2_approx(m[r] - mx);
        m[r] = mx;
      }
      float ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float p = x == kNegInf ? 0.0f : exp2_approx(x - m[e >> 1]);
          s[j][e] = p;
          ps[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned phi[4], plo[4];
        split_p(s[2 * kk], s[2 * kk + 1], phi, plo);
        mma_pv<D, LD>(o, phi, plo, vt, 16 * kk, lane);
      }
    }
    __syncthreads();        // the tile is consumed before it is refilled
  }
  cp_async_wait<0>();
  if (!active) return;
  bf16* og = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + g + 8 * r;
    const float lsum = quad_sum(l[r]);
    const float denom = fmaxf(lsum, 1e-30f);
    if (t >= a.T) continue;
    if (a.lse != nullptr && tig == 0) {   // m is in log2 units
      a.lse[(static_cast<long long>(b) * a.H + h) * a.T + t] =
          (m[r] + log2f(lsum)) * kLn2;
    }
    bf16* orow = og + static_cast<long long>(t) * a.o_st + 2 * tig;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    }
  }
}

template <int D>
struct SplitMma {
  static constexpr int LD = D + 8;
  // Q, K and V tiles; the warps' partials, their (m, l) and the block's
  // (the launch adds the combine's (M, L) per row)
  static constexpr int kSmem =
      (16 + 2 * kSplitKeys) * LD * 2 +
      (kSplitMmaWarps * 16 * (D + 2) + 2 * 16) * 4;
};

template <int D>
__global__ void __launch_bounds__(kSplitMmaWarps * 32)
    flash_split_mma(const Args a) {
  constexpr int LD = SplitMma<D>::LD, ND = D / 8, KD = D / 16, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);     // [16][LD]
  bf16* ks = qs + 16 * LD;                           // [kSplitKeys][LD]
  bf16* vs = ks + kSplitKeys * LD;                   // [kSplitKeys][LD]
  float* red_acc = reinterpret_cast<float*>(vs + kSplitKeys * LD);
  float* red_m = red_acc + kSplitMmaWarps * 16 * D;  // [warp][16]
  float* red_l = red_m + kSplitMmaWarps * 16;        // [warp][16]
  float* row_m = red_l + kSplitMmaWarps * 16;        // [16]: block max
  float* row_l = row_m + 16;                         // [16]: block sum
  float* comb_m = row_l + 16;                        // [R]: combine's M
  float* comb_l = comb_m + a.H / a.KV * a.T;         // [R]: combine's L
  __shared__ bool last_s;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int G = a.H / a.KV, R = G * a.T;
  const int k0 = split * kSplitKeys;
  const int bk = b * a.KV + kvh;
  float* part_acc = a.part;                               // [rows][D]
  float* part_ml = a.part + static_cast<long long>(a.B) * a.KV * nsplit *
                                R * D;                    // [rows][2]
  const long long prow = (static_cast<long long>(bk) * nsplit + split) * R;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb +
                   kvh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb +
                   kvh * a.v_sh;
  const float sc = a.scale * kLog2e;

  // the keys some row sees: from query 0's first to query T-1's last
  int ulo, uhi, lo, hi;
  visible(a, 0, &ulo, &hi);
  visible(a, a.T - 1, &lo, &uhi);
  if (k0 < uhi && k0 + kSplitKeys > ulo) {
    for (int i = tid; i < kSplitKeys * CH; i += blockDim.x) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const bool ok = key < a.S;
      const long long kk = static_cast<long long>(key);
      cp_async16(ks + r * LD + c * 8, ok ? kg + kk * a.k_ss + c * 8 : kg,
                 ok);
      cp_async16(vs + r * LD + c * 8, ok ? vg + kk * a.v_ss + c * 8 : vg,
                 ok);
    }
    for (int rg = 0; rg < R; rg += 16) {
      // rows rg .. rg + 15 of the group: row r is (head kvh * G + r / T,
      // query r % T); rows past R are zeros
      for (int i = tid; i < 16 * CH; i += blockDim.x) {
        const int r = rg + i / CH, c = i % CH;
        const bool ok = r < R;
        const bf16* src = static_cast<const bf16*>(a.q) + b * a.q_sb;
        if (ok) {
          src += (kvh * G + r / a.T) * a.q_sh +
                 static_cast<long long>(r % a.T) * a.q_st + c * 8;
        }
        cp_async16(qs + (i / CH) * LD + c * 8, src, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // warp w: keys k0 + 16 w .. k0 + 16 w + 15 against the 16 rows
      float s[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned qa[4];
        load_a<LD>(qa, qs, kk, lane);
        mma_qk<LD>(s, qa, ks, 16 * w, kk, lane);
      }
      int rlo[2], rhi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg + g + 8 * r;
        if (row < R) {
          visible(a, row % a.T, &rlo[r], &rhi[r]);
        } else {
          rlo[r] = rhi[r] = 0;
        }
      }
      float mw[2], lw[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const int key = k0 + 16 * w + 8 * j + 2 * tig + (e & 1);
            const bool ok = key >= rlo[r] && key < rhi[r];
            s[j][e] = ok ? s[j][e] * sc : kNegInf;
            mx = fmaxf(mx, s[j][e]);
          }
        }
        mw[r] = quad_max(mx);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float x = s[j][e];
            s[j][e] = x == kNegInf ? 0.0f : exp2_approx(x - mw[r]);
            lw[r] += s[j][e];
          }
        }
        lw[r] = quad_sum(lw[r]);
      }
      float o[ND][4];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
      }
      unsigned phi[4], plo[4];
      split_p(s[0], s[1], phi, plo);
      mma_pv<D, LD>(o, phi, plo, vs, 16 * w, lane);

      // the block's 4 warps merged in warp order
      if (tig == 0) {
        red_m[w * 16 + g] = mw[0];
        red_m[w * 16 + g + 8] = mw[1];
        red_l[w * 16 + g] = lw[0];
        red_l[w * 16 + g + 8] = lw[1];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float* dst = red_acc + (w * 16 + g) * D + 8 * n + 2 * tig;
        dst[0] = o[n][0];
        dst[1] = o[n][1];
        dst[8 * D] = o[n][2];
        dst[8 * D + 1] = o[n][3];
      }
      __syncthreads();
      if (tid < 16) {
        float mx = kNegInf;
        for (int u = 0; u < kSplitMmaWarps; ++u) {
          mx = fmaxf(mx, red_m[u * 16 + tid]);
        }
        float ls = 0.0f;
        for (int u = 0; u < kSplitMmaWarps; ++u) {
          const float f = exp2_approx(red_m[u * 16 + tid] - mx);
          red_m[u * 16 + tid] = f;         // now the warp's factor
          ls += red_l[u * 16 + tid] * f;
        }
        row_m[tid] = mx;
        row_l[tid] = ls;
      }
      __syncthreads();
      for (int i = tid; i < 16 * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        if (rg + r >= R) break;
        float acc = 0.0f;
        for (int u = 0; u < kSplitMmaWarps; ++u) {
          acc += red_acc[(u * 16 + r) * D + d] * red_m[u * 16 + r];
        }
        part_acc[(prow + rg + r) * D + d] = acc;
        if (d == 0) {
          part_ml[(prow + rg + r) * 2] = row_m[r];
          part_ml[(prow + rg + r) * 2 + 1] = row_l[r];
        }
      }
      __syncthreads();      // qs and the merge buffers are reused
    }
  } else {                  // no row sees this split: an empty partial
    for (int i = tid; i < R * D; i += blockDim.x) {
      part_acc[prow * D + i] = 0.0f;
      if (i % D == 0) {
        part_ml[(prow + i / D) * 2] = kNegInf;
        part_ml[(prow + i / D) * 2 + 1] = 0.0f;
      }
    }
  }

  // the last block of (b, kv head) to finish merges the splits: eight
  // lanes a row take the row's max M and sum L over the splits (then a
  // fixed butterfly), then each thread adds its elements' partials
  // weighted by 2^(m - M) in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(a.count + bk, 1u) == static_cast<unsigned>(nsplit - 1);
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const long long base = static_cast<long long>(bk) * nsplit * R;
  for (int r0 = w * kRowsPerWarp; r0 < R;
       r0 += kSplitMmaWarps * kRowsPerWarp) {
    // kLanesPerRow lanes a row: each folds its splits' (m, l) into a
    // running (max, sum), one load of each, and the lanes' pairs are
    // merged by a butterfly
    const int r = r0 + lane / kLanesPerRow, sub = lane % kLanesPerRow;
    float mx = kNegInf, ls = 0.0f;
    for (int sp = sub; r < R && sp < nsplit; sp += kLanesPerRow) {
      const float* ml = part_ml + (base + sp * R + r) * 2;
      const float m = __ldcg(ml), l = __ldcg(ml + 1);
      const float top = fmaxf(mx, m);
      ls = ls * exp2_approx(mx - top) + l * exp2_approx(m - top);
      mx = top;
    }
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mx, off);
      const float lo = __shfl_xor_sync(0xffffffffu, ls, off);
      const float top = fmaxf(mx, mo);
      ls = ls * exp2_approx(mx - top) + lo * exp2_approx(mo - top);
      mx = top;
    }
    if (sub == 0 && r < R) {
      comb_m[r] = mx;
      comb_l[r] = fmaxf(ls, 1e-30f);
    }
  }
  __syncthreads();
  // kCombine elements a thread at once, four splits' loads in flight
  for (int i0 = tid; i0 < R * D; i0 += kCombine * blockDim.x) {
    float acc[kCombine];
    int row[kCombine], col[kCombine];
#pragma unroll
    for (int j = 0; j < kCombine; ++j) {
      const int i = min(i0 + j * static_cast<int>(blockDim.x), R * D - 1);
      row[j] = i / D;
      col[j] = i % D;
      acc[j] = 0.0f;
    }
#pragma unroll 4
    for (int sp = 0; sp < nsplit; ++sp) {
#pragma unroll
      for (int j = 0; j < kCombine; ++j) {
        const long long pr = base + sp * R + row[j];
        acc[j] += __ldcg(part_acc + pr * D + col[j]) *
                  exp2_approx(__ldcg(part_ml + pr * 2) - comb_m[row[j]]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCombine; ++j) {
      if (i0 + j * static_cast<int>(blockDim.x) >= R * D) break;
      const int r = row[j];
      bf16* og = static_cast<bf16*>(a.o) + b * a.o_sb +
                 (kvh * G + r / a.T) * a.o_sh +
                 static_cast<long long>(r % a.T) * a.o_st;
      og[col[j]] = __float2bfloat16_rn(acc[j] / comb_l[r]);
    }
  }
  if (tid == 0) a.count[bk] = 0u;
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

int splits(int S) { return S > 0 ? (S + kSplitKeys - 1) / kSplitKeys : 1; }

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  if (a.T <= kSplitMaxT && a.lse == nullptr) {
    const int smem = SplitMma<D>::kSmem + 2 * (a.H / a.KV) * a.T * 4;
    const int e = set_smem(flash_split_mma<D>, smem);
    if (e != 0) return e;
    flash_split_mma<D><<<dim3(splits(a.S), a.KV, a.B), kSplitMmaWarps * 32,
                         smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = TiledMma<D>::kSmem;
  const int e = set_smem(flash_tiled_mma<D>, smem);
  if (e != 0) return e;
  flash_tiled_mma<D><<<dim3(a.H, a.B, (a.T + kTileQ - 1) / kTileQ),
                       kTiledWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(const Args& a, cudaStream_t stream, bool bf) {
  return bf ? launch_mma<D>(a, stream) : launch_d<float, D>(a, stream);
}

int launch(const Args* a, void* stream, bool bf) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 16: return launch_dtype<16>(*a, s, bf);
    case 32: return launch_dtype<32>(*a, s, bf);
    case 64: return launch_dtype<64>(*a, s, bf);
    case 80: return launch_dtype<80>(*a, s, bf);
    case 96: return launch_dtype<96>(*a, s, bf);
    case 128: return launch_dtype<128>(*a, s, bf);
    case 160: return launch_dtype<160>(*a, s, bf);
    case 192: return launch_dtype<192>(*a, s, bf);
    case 224: return launch_dtype<224>(*a, s, bf);
    case 256: return launch_dtype<256>(*a, s, bf);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------
// backward (FlashBwdArgs; see the note at its definition)
// ---------------------------------------------------------------------

using BArgs = FlashBwdArgs;

// Whether the mask has a sliding window.
__device__ __forceinline__ bool windowed(const BArgs& a) {
  return a.causal && a.window > 0;
}

// Query t (a row of T, at position t + S - T) sees key j.
__device__ __forceinline__ bool sees(const BArgs& a, int t, int j) {
  if (t >= a.T || j >= a.S) return false;
  if (!a.causal) return true;
  const int pos = t + (a.S - a.T);
  return j <= pos && (a.window <= 0 || j > pos - a.window);
}

// The keys [seen_beg, seen_end) that query t sees (t < T).
__device__ __forceinline__ int seen_end(const BArgs& a, int t) {
  return a.causal ? max(0, min(a.S, t + (a.S - a.T) + 1)) : a.S;
}
__device__ __forceinline__ int seen_beg(const BArgs& a, int t) {
  return windowed(a) ? max(0, t + (a.S - a.T) - a.window + 1) : 0;
}

// One past the last query that sees key j (j < S): with a window, the
// queries from it on no longer reach back to j; without one, T.
__device__ __forceinline__ int seeing_end(const BArgs& a, int j) {
  return windowed(a) ? max(0, min(a.T, j - (a.S - a.T) + a.window)) : a.T;
}

// float32, dq: a block of kBQ warps per (b, head, kBQ query rows), a warp
// a row; key tiles of kBK keys (K and V float32 in shared memory), lane j
// scoring key j, then ds_j broadcast by a shuffle into the lane's columns.
template <int D>
__global__ void __launch_bounds__(kBQ * 32)
    flash_bwd_dq_f32(const BArgs a) {
  constexpr int DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* ks = smem;                         // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);           // [kBK][D + 1]
  float* qs = vs + kBK * (D + 1);           // [kBQ][D]
  float* dos = qs + kBQ * D;                // [kBQ][D]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int kvh = h / (a.H / a.KV);
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb +
                    kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb +
                    kvh * a.v_sh;
  const float* og = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* dog = static_cast<const float*>(a.dout) + b * a.do_sb +
                     h * a.do_sh;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.T;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    const bool ok = q0 + r < a.T;
    const long long t = q0 + r;
    qs[idx] = ok ? qg[t * a.q_st + c] : 0.0f;
    dos[idx] = ok ? dog[t * a.do_st + c] : 0.0f;
  }
  const int t = q0 + w;
  const bool row = t < a.T;
  float dl = 0.0f, lse = 0.0f;
  if (row) {
    float part = 0.0f;
    for (int c = lane; c < D; c += 32) {
      part += dog[static_cast<long long>(t) * a.do_st + c] *
              og[static_cast<long long>(t) * a.o_st + c];
    }
    dl = warp_sum(part);
    lse = a.lse[row0 + t];
    if (lane == 0) a.delta[row0 + t] = dl;
  }
  const int bhi = seen_end(a, min(q0 + kBQ, a.T) - 1);
  const int hi = row ? seen_end(a, t) : 0;
  const int lo = row ? seen_beg(a, t) : 0;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.0f;
  for (int k0 = (seen_beg(a, q0) / kBK) * kBK; k0 < bhi; k0 += kBK) {
    __syncthreads();    // the previous tile is consumed (and q is staged)
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D;
      const long long key = k0 + r;
      const bool ok = key < a.S;
      ks[r * (D + 1) + c] = ok ? kg[key * a.k_ss + c] : 0.0f;
      vs[r * (D + 1) + c] = ok ? vg[key * a.v_ss + c] : 0.0f;
    }
    __syncthreads();
    if (!row || k0 >= hi || k0 + kBK <= lo) continue;  // warp-uniform
    const float* qr = qs + w * D;
    const float* dr = dos + w * D;
    const float* kr = ks + lane * (D + 1);
    const float* vr = vs + lane * (D + 1);
    float s = 0.0f, dp = 0.0f;
    for (int c = 0; c < D; ++c) {
      s += qr[c] * kr[c];
      dp += dr[c] * vr[c];
    }
    const float p = sees(a, t, k0 + lane) ? expf(s * a.scale - lse) : 0.0f;
    const float ds = p * (dp - dl);
    for (int j = 0; j < kBK; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
      const float* kj = ks + j * (D + 1) + lane;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        if (has_col<D>(lane, i)) acc[i] += dsj * kj[32 * i];
      }
    }
  }
  if (!row) return;
  float* dqg = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh +
               static_cast<long long>(t) * a.dq_st;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    if (has_col<D>(lane, i)) dqg[lane + 32 * i] = acc[i] * a.scale;
  }
}

// float32, dk/dv: a block of kBQ warps per (b, kv head, kBQ keys), a warp
// a key; query tiles of kBK queries of each of the group's heads in turn,
// lane i scoring query i.
template <int D>
__global__ void __launch_bounds__(kBQ * 32)
    flash_bwd_dkv_f32(const BArgs a) {
  constexpr int DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* qs = smem;                         // [kBK][D + 1]
  float* dos = qs + kBK * (D + 1);          // [kBK][D + 1]
  float* kr_s = dos + kBK * (D + 1);        // [kBQ][D]
  float* vr_s = kr_s + kBQ * D;             // [kBQ][D]
  float* ls = vr_s + kBQ * D;               // [kBK]
  float* dls = ls + kBK;                    // [kBK]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kBQ;
  const int G = a.H / a.KV;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb +
                    kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb +
                    kvh * a.v_sh;
  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    const long long key = k0 + r;
    const bool ok = key < a.S;
    kr_s[idx] = ok ? kg[key * a.k_ss + c] : 0.0f;
    vr_s[idx] = ok ? vg[key * a.v_ss + c] : 0.0f;
  }
  const int j = k0 + w;
  const bool key_ok = j < a.S;
  // the first query tile with a query that sees key k0
  const int tbeg = a.causal ? (max(0, k0 - (a.S - a.T)) / kBK) * kBK : 0;
  // the queries after the last that sees the block's last key
  const int tend = seeing_end(a, min(k0 + kBQ, a.S) - 1);
  const int jend = key_ok ? seeing_end(a, j) : 0;
  float dk[DPL], dv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) dk[i] = dv[i] = 0.0f;
  for (int hq = 0; hq < G; ++hq) {
    const int h = kvh * G + hq;
    const float* qg = static_cast<const float*>(a.q) + b * a.q_sb +
                      h * a.q_sh;
    const float* dog = static_cast<const float*>(a.dout) + b * a.do_sb +
                       h * a.do_sh;
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.T;
    for (int t0 = tbeg; t0 < tend; t0 += kBK) {
      __syncthreads();  // the previous tile is consumed (and k/v staged)
      for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
        const int r = idx / D, c = idx % D;
        const long long t = t0 + r;
        const bool ok = t < a.T;
        qs[r * (D + 1) + c] = ok ? qg[t * a.q_st + c] : 0.0f;
        dos[r * (D + 1) + c] = ok ? dog[t * a.do_st + c] : 0.0f;
      }
      for (int i = threadIdx.x; i < kBK; i += blockDim.x) {
        const bool ok = t0 + i < a.T;
        ls[i] = ok ? a.lse[row0 + t0 + i] : 0.0f;
        dls[i] = ok ? a.delta[row0 + t0 + i] : 0.0f;
      }
      __syncthreads();
      if (!key_ok || t0 >= jend) continue;              // warp-uniform
      const float* kr = kr_s + w * D;
      const float* vr = vr_s + w * D;
      const float* qr = qs + lane * (D + 1);
      const float* dr = dos + lane * (D + 1);
      float s = 0.0f, dp = 0.0f;
      for (int c = 0; c < D; ++c) {
        s += qr[c] * kr[c];
        dp += dr[c] * vr[c];
      }
      const float p =
          sees(a, t0 + lane, j) ? expf(s * a.scale - ls[lane]) : 0.0f;
      const float ds = p * (dp - dls[lane]);
      for (int i2 = 0; i2 < kBK; ++i2) {
        const float pj = __shfl_sync(0xffffffffu, p, i2);
        const float dsj = __shfl_sync(0xffffffffu, ds, i2);
        const float* dq2 = dos + i2 * (D + 1) + lane;
        const float* q2 = qs + i2 * (D + 1) + lane;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          if (has_col<D>(lane, i)) {
            dv[i] += pj * dq2[32 * i];
            dk[i] += dsj * q2[32 * i];
          }
        }
      }
    }
  }
  if (!key_ok) return;
  float* dkg = static_cast<float*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh +
               static_cast<long long>(j) * a.dk_ss;
  float* dvg = static_cast<float*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh +
               static_cast<long long>(j) * a.dv_ss;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    if (has_col<D>(lane, i)) {
      dkg[lane + 32 * i] = dk[i] * a.scale;
      dvg[lane + 32 * i] = dv[i];
    }
  }
}

// ---------------------------------------------------------------------
// bfloat16 backward on wgmma (Hopper's warpgroup products), operands by
// TMA
// ---------------------------------------------------------------------
//
// A block is one warpgroup (4 warps, 128 threads) that owns 64 rows of
// every product (the wgmma's M): 64 query rows (dq) or 64 keys (dk/dv).
// Its own tiles (Q and dO, or K and V) come in once; the tiles it walks
// (K and V, or Q and dO) come in by TMA into a
// ring of two stages, each completed by an mbarrier: thread 0 starts the
// next tile's loads before the block computes on this one, and a block
// barrier at the end of each tile hands the stage back. Every operand
// tile sits in shared memory as 64-column chunks of 128-byte rows in
// TMA's 128-byte swizzle (rows and columns past the tensor read 0), which
// serves both as a K-major operand (S = Q K^T: the k steps walk D, 32
// bytes at a time) and as an MN-major one (dq = dS K: the k steps walk
// the rows, 2 048 bytes at a time; the chunks are LBO apart).
// The score products S and dP run on wgmma with both operands in shared
// memory, float32 accumulators in registers; P and dS are rounded once to
// bf16 in the registers (the accumulator's fragment is the A fragment of
// the next product) and the gradient products take them as A from
// registers: seven products per visible pair in all (S and dP twice,
// dq, dk, dv).
template <int D>
struct BwdWg {
  static constexpr int CH = (D + 63) / 64;      // 64-column chunks a tile
  static constexpr int KS = (D + 15) / 16;      // k steps of S and dP
  static constexpr int DS = D > 128 ? 128 : D;  // dk/dv columns a block
  static constexpr int NSPLIT = D / DS;         // blocks a key tile
  static constexpr int NKV = (DS + 63) / 64 * 64;   // N of dk's and dv's
  static constexpr int NQ = CH * 64;                // N of dq's
  static constexpr int BK = D > 128 ? 32 : 64;      // keys a dq tile
  static constexpr int TILE = 64 * 64 * 2;      // bytes of a 64-row chunk
  // dq: Q, dO; two stages of K, V (BK rows); dk/dv: K, V; two stages of
  // Q, dO; each + 3 mbarriers, and 1 024 bytes to align the base for the
  // swizzle
  static constexpr int kStageDq = 2 * CH * BK * 128;
  static constexpr int kStageDkv = 2 * CH * TILE;
  static constexpr int kSmemDq = 2 * CH * TILE + 2 * kStageDq + 1024 + 64;
  static constexpr int kSmemDkv = 2 * CH * TILE + 2 * kStageDkv + 1024 + 64;
  static_assert(D % DS == 0, "the column split must cover every column");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The barrier's phase completes when its bytes have landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Descriptors of a 128-byte-swizzled operand in shared memory: K-major
// (8-row groups 1 024 bytes apart) and MN-major (the same, with the
// 64-column chunks lbo bytes apart).
__device__ __forceinline__ uint64_t desc_k(const bf16* p) {
  return ((smem_addr(p) & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn(const bf16* p, unsigned lbo) {
  return ((smem_addr(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

// k step kk (16 columns of D) of a tile of `rows` rows, K-major.
__device__ __forceinline__ uint64_t desc_kstep(const bf16* tile, int rows,
                                               int kk) {
  return desc_k(tile + (kk >> 2) * rows * 64 + (kk & 3) * 16);
}

// k step kk (rows 16 kk .. 16 kk + 15) of a tile of `rows` rows from its
// chunk c, MN-major.
__device__ __forceinline__ uint64_t desc_rstep(const bf16* tile, int rows,
                                               int c, int kk) {
  return desc_mn(tile + c * rows * 64 + kk * 16 * 64, rows * 128);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::
          : "memory");
}

// Orders the compiler's use of accumulators after the products' wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// The A fragment of k step kk of a 64-row accumulator, rounded to bf16:
// columns 16 kk .. 16 kk + 15 of rows g and g + 8 of each warp's 16.
template <int N>
__device__ __forceinline__ void a_frag(const float (&d)[N], int kk,
                                       unsigned (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = bits(__floats2bfloat162_rn(d[8 * kk + 2 * j],
                                      d[8 * kk + 2 * j + 1]));
  }
}

// D += A B, m64nNk16, bf16 in, float32 accumulate in d (N / 2 a thread):
// wgmma_ss with A and B K-major in shared memory, wgmma_rs with A from
// registers and B MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The tensor maps of a launch (built by the host): q, do [B, T, H, D] and
// k, v [B, S, KV, D] read in place as 4-d maps (D, rows, heads, B) with a
// box of 64 columns by 64 rows (k and v: by BwdWg::BK rows for dq), 128-
// byte swizzled.
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// bfloat16, dq: a block per (b, head, 64 query rows), the heaviest tiles
// first. Q and dO stay; K and V come in tiles of BK keys, in order over
// the keys some row of the block sees. Per tile: S = Q K^T, dP = dO V^T,
// p = 2^(s scale log2e - lse log2e) (0 where masked), ds = p (dp - delta),
// dq += bf16(ds) K. Before its first tile the block takes delta =
// rowsum(do * o) of its rows (each lane a quarter of a row in column
// order, then the quad's butterfly) and writes it for the dk/dv kernel.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_wgmma(const __grid_constant__ BwdMaps m, const BArgs a) {
  using C = BwdWg<D>;
  constexpr int CH = C::CH, KS = C::KS, BK = C::BK, NQ = C::NQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(base);           // [CH][64][64]
  bf16* dos = qs + CH * 64 * 64;                      // [CH][64][64]
  unsigned char* stages = base + 2 * CH * C::TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + 2 * C::kStageDq);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;     // heaviest first
  const int kvh = h / (a.H / a.KV);
  const int kbeg = (seen_beg(a, q0) / BK) * BK;
  const int kend = seen_end(a, min(q0 + 64, a.T) - 1);
  const int total = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  auto ks = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * C::kStageDq);
  };
  auto vs = [&](int s) { return ks(s) + CH * BK * 64; };
  auto load_kv = [&](int n) {
    const int s = n & 1, k0 = kbeg + n * BK;
    mbar_expect(bars + 1 + s, C::kStageDq);
    for (int c = 0; c < CH; ++c) {
      tma_4d(ks(s) + c * BK * 64, &m.k, bars + 1 + s, 64 * c, k0, kvh, b);
      tma_4d(vs(s) + c * BK * 64, &m.v, bars + 1 + s, 64 * c, k0, kvh, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bars, 2 * CH * C::TILE);
    for (int c = 0; c < CH; ++c) {
      tma_4d(qs + c * 64 * 64, &m.q, bars, 64 * c, q0, h, b);
      tma_4d(dos + c * 64 * 64, &m.dout, bars, 64 * c, q0, h, b);
    }
    if (total > 0) load_kv(0);
  }

  // rows g and g + 8 of the warp: delta, the log-sum-exp in log2 units,
  // and the keys each sees
  const bf16* og = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_sb +
                    h * a.do_sh;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.T;
  const int r0 = q0 + 16 * w;
  float dl[2], ls2[2];
  int rlo[2], rhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + g + 8 * r;
    float part = 0.0f;
    if (t < a.T) {
      const long long tt = static_cast<long long>(t);
      for (int c = tig; c < D; c += 4) {
        part += __bfloat162float(dog[tt * a.do_st + c]) *
                __bfloat162float(og[tt * a.o_st + c]);
      }
    }
    dl[r] = quad_sum(part);
    ls2[r] = t < a.T ? a.lse[row0 + t] * kLog2e : 0.0f;
    rhi[r] = t < a.T ? seen_end(a, t) : 0;
    rlo[r] = t < a.T ? seen_beg(a, t) : 0;
    if (tig == 0 && t < a.T) a.delta[row0 + t] = dl[r];
  }
  const bool rows_full = r0 + 16 <= a.T;
  const int last = min(r0 + 15, a.T - 1);
  const int hi_min = rows_full ? seen_end(a, r0) : 0;
  const int lo_max = rows_full ? seen_beg(a, last) : 0;
  const float sc = a.scale * kLog2e;

  float dq[NQ / 2];
  zero(dq);
  mbar_wait(bars, 0);
  for (int n = 0; n < total; ++n) {
    const int s = n & 1, k0 = kbeg + n * BK;
    if (tid == 0 && n + 1 < total) load_kv(n + 1);
    mbar_wait(bars + 1 + s, (n >> 1) & 1);
    float sa[BK / 2], dp[BK / 2];
    zero(sa);
    zero(dp);
    reg_fence(sa);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss(sa, desc_kstep(qs, 64, kk), desc_kstep(ks(s), BK, kk));
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss(dp, desc_kstep(dos, 64, kk), desc_kstep(vs(s), BK, kk));
    }
    wg_commit_wait();
    reg_fence(sa);
    reg_fence(dp);
    // the element mask only where the tile crosses an edge of some row's
    // visible range
    const bool full = rows_full && k0 + BK <= hi_min && k0 >= lo_max;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + 2 * tig + (e & 1);
        const int r = e >> 1;
        const bool ok = full || (key >= rlo[r] && key < rhi[r]);
        const float p = ok ? exp2_approx(sa[4 * i + e] * sc - ls2[r]) : 0.0f;
        sa[4 * i + e] = ok ? p * (dp[4 * i + e] - dl[r]) : 0.0f;
      }
    }
    unsigned da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) a_frag(sa, kk, da[kk]);
    reg_fence(dq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs(dq, da[kk], desc_rstep(ks(s), BK, 0, kk));
    }
    wg_commit_wait();
    reg_fence(dq);
    __syncthreads();        // the stage is consumed before it is refilled
  }
  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + g + 8 * r;
    if (t >= a.T) continue;
    bf16* row = dqg + static_cast<long long>(t) * a.dq_st + 2 * tig;
#pragma unroll
    for (int i = 0; i < NQ / 8; ++i) {
      if (8 * i + 2 * tig < D) {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
            __floats2bfloat162_rn(dq[4 * i + 2 * r] * a.scale,
                                  dq[4 * i + 2 * r + 1] * a.scale);
      }
    }
  }
}

// bfloat16, dk/dv: a block per (b, kv head, column split, chunk of the
// group's heads, 64 keys), the first keys (the most queries) first. K and
// V stay; for each head of its chunk in ascending order, the query tiles
// that see its keys come in in order (64 queries; each thread loads the
// lse and delta of its 16 while they land). Per tile: S^T = K Q^T and
// dP^T = V dO^T, p and ds on the accumulators, dv += bf16(p)^T dO and
// dk += bf16(ds)^T Q over the block's columns. With one chunk the block writes dk (times scale) and
// dv; with several, each writes its float32 partial sums, and the last
// block of the key tile to finish (elected by a counter taken after
// __threadfence; it resets the counter) adds the chunks in ascending
// order and writes them, so the head sum runs in a fixed order.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_wgmma(const __grid_constant__ BwdMaps m, const BArgs a) {
  using C = BwdWg<D>;
  constexpr int CH = C::CH, KS = C::KS, NKV = C::NKV, DS = C::DS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ unsigned elected;
  unsigned char* base = align1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(base);            // [CH][64][64]
  bf16* vs = ks + CH * 64 * 64;                        // [CH][64][64]
  unsigned char* stages = base + 2 * CH * C::TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + 2 * C::kStageDkv);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int G = a.H / a.KV, NC = (G + a.hpc - 1) / a.hpc;
  const int chunk = blockIdx.x % NC;
  const int kvh = blockIdx.x / NC / C::NSPLIT;
  const int split = blockIdx.x / NC % C::NSPLIT;
  const int b = blockIdx.y, tile = blockIdx.z, k0 = 64 * tile;
  const int c0 = split * DS;                     // the block's columns
  const int h0 = kvh * G + chunk * a.hpc;
  const int nh = min(a.hpc, G - chunk * a.hpc);
  const int off = a.S - a.T;
  // the query tiles: from the first that holds a query seeing key k0 to
  // the last query that sees the block's last key
  const int tbeg = a.causal ? (max(0, k0 - off) / 64) * 64 : 0;
  const int tend = seeing_end(a, min(k0 + 64, a.S) - 1);
  const int ntile = tend > tbeg ? (tend - tbeg + 63) / 64 : 0;
  const int total = nh * ntile;
  auto qs = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * C::kStageDkv);
  };
  auto dos = [&](int s) { return qs(s) + CH * 64 * 64; };
  auto load_q = [&](int n) {
    const int s = n & 1, h = h0 + n / ntile, t0 = tbeg + (n % ntile) * 64;
    uint64_t* bar = bars + 1 + s;
    mbar_expect(bar, C::kStageDkv);
    for (int c = 0; c < CH; ++c) {
      tma_4d(qs(s) + c * 64 * 64, &m.q, bar, 64 * c, t0, h, b);
      tma_4d(dos(s) + c * 64 * 64, &m.dout, bar, 64 * c, t0, h, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bars, 2 * CH * C::TILE);
    for (int c = 0; c < CH; ++c) {
      tma_4d(ks + c * 64 * 64, &m.k, bars, 64 * c, k0, kvh, b);
      tma_4d(vs + c * 64 * 64, &m.v, bars, 64 * c, k0, kvh, b);
    }
    if (total > 0) load_q(0);
  }

  const int kw = k0 + 16 * w;                 // the warp's first key
  const float sc = a.scale * kLog2e;
  float dk[NKV / 2], dv[NKV / 2];
  zero(dk);
  zero(dv);
  mbar_wait(bars, 0);
  for (int n = 0; n < total; ++n) {
    const int s = n & 1, t0 = tbeg + (n % ntile) * 64;
    if (tid == 0 && n + 1 < total) load_q(n + 1);
    // the lse (log2 units) and delta of this thread's queries 8 i + 2 tig
    // + j, as L[2 i + j]
    const long long row0 =
        (static_cast<long long>(b) * a.H + h0 + n / ntile) * a.T;
    float L[16], Dl[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = t0 + 8 * (j >> 1) + 2 * tig + (j & 1);
      L[j] = t < a.T ? a.lse[row0 + t] * kLog2e : 0.0f;
      Dl[j] = t < a.T ? a.delta[row0 + t] : 0.0f;
    }
    mbar_wait(bars + 1 + s, (n >> 1) & 1);
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    reg_fence(st);
    reg_fence(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss(st, desc_kstep(ks, 64, kk), desc_kstep(qs(s), 64, kk));
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss(dpt, desc_kstep(vs, 64, kk), desc_kstep(dos(s), 64, kk));
    }
    wg_commit_wait();
    reg_fence(st);
    reg_fence(dpt);
    // every query of the tile sees every key of the warp
    const bool full = kw + 16 <= a.S && t0 + 64 <= a.T &&
                      (!a.causal || t0 + off >= kw + 15) &&
                      (!windowed(a) || t0 + 63 + off - a.window < kw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * i + 2 * tig + (e & 1), j = 2 * i + (e & 1);
        const int key = kw + g + 8 * (e >> 1);
        const bool ok = full || sees(a, t0 + qi, key);
        const float p = ok ? exp2_approx(st[4 * i + e] * sc - L[j]) : 0.0f;
        st[4 * i + e] = p;
        dpt[4 * i + e] = ok ? p * (dpt[4 * i + e] - Dl[j]) : 0.0f;
      }
    }
    unsigned pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_frag(st, kk, pa[kk]);
      a_frag(dpt, kk, da[kk]);
    }
    reg_fence(dv);
    reg_fence(dk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(dv, pa[kk], desc_rstep(dos(s), 64, c0 / 64, kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(dk, da[kk], desc_rstep(qs(s), 64, c0 / 64, kk));
    }
    wg_commit_wait();
    reg_fence(dv);
    reg_fence(dk);
    __syncthreads();        // the stage is consumed before it is refilled
  }

  const long long unit =
      ((static_cast<long long>(b) * a.KV + kvh) * C::NSPLIT + split) *
          gridDim.z + tile;
  if (NC > 1) {
    // this chunk's partials, [NC][units][2][64][DS] floats
    const long long units =
        static_cast<long long>(gridDim.y) * a.KV * C::NSPLIT * gridDim.z;
    auto part = [&](int c) { return a.part + (c * units + unit) * 2 * 64 * DS; };
    float* pk = part(chunk);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * w + g + 8 * r;
#pragma unroll
      for (int i = 0; i < NKV / 8; ++i) {
        const int col = 8 * i + 2 * tig;
        if (col < DS) {
          *reinterpret_cast<float2*>(pk + row * DS + col) =
              make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
          *reinterpret_cast<float2*>(pk + (64 + row) * DS + col) =
              make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) elected = atomicAdd(a.count + unit, 1u) == NC - 1u;
    __syncthreads();
    if (!elected) return;
    __threadfence();
    // the chunks in ascending order, this block's own from its registers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * w + g + 8 * r;
#pragma unroll
      for (int i = 0; i < NKV / 8; ++i) {
        const int col = 8 * i + 2 * tig;
        if (col >= DS) continue;
        float2 sk = make_float2(0.0f, 0.0f), sv = sk;
        for (int c = 0; c < NC; ++c) {
          float2 vk = make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
          float2 vv = make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
          if (c != chunk) {
            const float* pc = part(c);
            vk = __ldcg(reinterpret_cast<const float2*>(pc + row * DS + col));
            vv = __ldcg(
                reinterpret_cast<const float2*>(pc + (64 + row) * DS + col));
          }
          sk = c == 0 ? vk : make_float2(sk.x + vk.x, sk.y + vk.y);
          sv = c == 0 ? vv : make_float2(sv.x + vv.x, sv.y + vv.y);
        }
        dk[4 * i + 2 * r] = sk.x;
        dk[4 * i + 2 * r + 1] = sk.y;
        dv[4 * i + 2 * r] = sv.x;
        dv[4 * i + 2 * r + 1] = sv.y;
      }
    }
    if (tid == 0) a.count[unit] = 0u;
  }
  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh + c0;
  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh + c0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= a.S) continue;
    bf16* krow = dkg + static_cast<long long>(key) * a.dk_ss + 2 * tig;
    bf16* vrow = dvg + static_cast<long long>(key) * a.dv_ss + 2 * tig;
#pragma unroll
    for (int i = 0; i < NKV / 8; ++i) {
      if (8 * i + 2 * tig >= DS) continue;
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * i) = __floats2bfloat162_rn(
          dk[4 * i + 2 * r] * a.scale, dk[4 * i + 2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * i) =
          __floats2bfloat162_rn(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, looked up at run time so that the
// library links against the CUDA runtime alone.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A bf16 [B, rows, heads, D] tensor (element strides sb, sr, sh; the D
// stride 1) as a 4-d map with a box of 64 columns by box_rows rows.
bool map_rows(CUtensorMap* map, const void* p, int B, int rows, int heads,
              int D, long long sb, long long sr, long long sh, int box_rows) {
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(D),
                             static_cast<cuuint64_t>(rows),
                             static_cast<cuuint64_t>(heads),
                             static_cast<cuuint64_t>(B)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(sr) * 2,
                                static_cast<cuuint64_t>(sh) * 2,
                                static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(p), dim, stride, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 launches: dq (which writes delta), then dk/dv.
template <int D>
int launch_bwd_wgmma(const BArgs& a, cudaStream_t stream) {
  using C = BwdWg<D>;
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  BwdMaps mq, mkv;
  bool ok = map_rows(&mq.q, a.q, a.B, a.T, a.H, D, a.q_sb, a.q_st, a.q_sh, 64) &&
            map_rows(&mq.dout, a.dout, a.B, a.T, a.H, D, a.do_sb, a.do_st,
                     a.do_sh, 64) &&
            map_rows(&mq.k, a.k, a.B, a.S, a.KV, D, a.k_sb, a.k_ss, a.k_sh,
                     C::BK) &&
            map_rows(&mq.v, a.v, a.B, a.S, a.KV, D, a.v_sb, a.v_ss, a.v_sh,
                     C::BK);
  mkv = mq;
  ok = ok &&
       map_rows(&mkv.k, a.k, a.B, a.S, a.KV, D, a.k_sb, a.k_ss, a.k_sh, 64) &&
       map_rows(&mkv.v, a.v, a.B, a.S, a.KV, D, a.v_sb, a.v_ss, a.v_sh, 64);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int e = set_smem(flash_bwd_dq_wgmma<D>, C::kSmemDq);
  if (e != 0) return e;
  e = set_smem(flash_bwd_dkv_wgmma<D>, C::kSmemDkv);
  if (e != 0) return e;
  flash_bwd_dq_wgmma<D><<<dim3(a.H, a.B, (a.T + 63) / 64), 128, C::kSmemDq,
                          stream>>>(mq, a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.H / a.KV, NC = (G + a.hpc - 1) / a.hpc;
  flash_bwd_dkv_wgmma<D><<<dim3(a.KV * C::NSPLIT * NC, a.B, (a.S + 63) / 64),
                           128, C::kSmemDkv, stream>>>(mkv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_d(const BArgs& a, cudaStream_t stream, bool bf) {
  if (bf) return launch_bwd_wgmma<D>(a, stream);
  const int smem_dq = (2 * kBK * (D + 1) + 2 * kBQ * D) *
                      static_cast<int>(sizeof(float));
  const int smem_dkv = smem_dq + 2 * kBK * static_cast<int>(sizeof(float));
  int e = set_smem(flash_bwd_dq_f32<D>, smem_dq);
  if (e != 0) return e;
  e = set_smem(flash_bwd_dkv_f32<D>, smem_dkv);
  if (e != 0) return e;
  flash_bwd_dq_f32<D><<<dim3((a.T + kBQ - 1) / kBQ, a.H, a.B), kBQ * 32,
                        smem_dq, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_f32<D><<<dim3((a.S + kBQ - 1) / kBQ, a.KV, a.B), kBQ * 32,
                         smem_dkv, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const BArgs* a, void* stream, bool bf) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 16: return launch_bwd_d<16>(*a, s, bf);
    case 32: return launch_bwd_d<32>(*a, s, bf);
    case 64: return launch_bwd_d<64>(*a, s, bf);
    case 80: return launch_bwd_d<80>(*a, s, bf);
    case 96: return launch_bwd_d<96>(*a, s, bf);
    case 128: return launch_bwd_d<128>(*a, s, bf);
    case 256: return launch_bwd_d<256>(*a, s, bf);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const FlashArgs* a, void* stream) {
  return launch(a, stream, false);
}

// bf16: where T <= flash_attention_split_max_t(), a->part holds
// B * KV * max(1, ceil(S / flash_attention_split_keys())) * H / KV * T *
// (D + 2)
// floats of scratch (a partial m, l, acc[D] per query row of each split)
// and a->count B * KV zeroed counters.
extern "C" int flash_attention_bf16(const FlashArgs* a, void* stream) {
  return launch(a, stream, true);
}

extern "C" int flash_attention_split_max_t() { return kSplitMaxT; }

extern "C" int flash_attention_split_keys() { return kSplitKeys; }

// The backward: dq, dk, dv, delta written; lse from the forward (a
// launch with a non-null FlashArgs::lse).
extern "C" int flash_attention_bwd_f32(const FlashBwdArgs* a, void* stream) {
  return launch_bwd(a, stream, false);
}

extern "C" int flash_attention_bwd_bf16(const FlashBwdArgs* a,
                                        void* stream) {
  return launch_bwd(a, stream, true);
}
