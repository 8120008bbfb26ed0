// K4: the whole-tick megakernel of the flow-slot engine, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel fused_tick_block of
// src/repro/kernels/fused_tick.py, which runs K ticks of
// src/repro/core/megakernel.py::make_tick in one pallas_call with the
// whole carry resident in VMEM. Here the tick is written out by hand
// (PowerTCP and theta-PowerTCP, chosen by a template parameter), in the
// order of the port's plain tick (repro_torch/core/megakernel.py):
//   1. t_sec and the ring pointer;
//   2. the gate: an arrival due and not admitted, or a freeable slot;
//   3. on gated ticks: flush the freeable slots' pending FCTs, retire them,
//      admit due arrivals fresh-first in slot order (block-wide integer
//      prefix sums), gather the admitted slots' schedule rows, re-init
//      their law state, window and timers, and rebuild the per-queue
//      contributor lists when the cursor moved;
//   4. theta_now and the send rates, written to the rings; the delayed
//      per-hop rates (masked before admission) and the delayed queue
//      observations, read from the rings together;
//   5. per switch: its occupancy, its ports added in port order;
//   6. per queue: the in-order arrival sum from +0.0, the Dynamic-
//      Thresholds cap, the integration and the packed [q | out | qdot]
//      ring row;
//   7. on updating slots: theta_obs, the w_old delay and w_old;
//   8. on updating slots: the law update and the update timers; on every
//      slot: the window clamp;
//   9. progress, completions into the pending buffer, free_at;
//  10. the record row, when recording.
//
// Bound: not bytes. One tick touches ~1 150 hop entries, 384 slots and 289
// queues at the paper's scale (a few tens of kB), but its phases depend on
// each other: rates before arrivals, queues before the observation, the
// observation before the law. What bounds a tick is that chain of
// dependent phases and the block barriers between them.
//
// Design: one persistent thread block runs the whole block of K ticks,
// with __syncthreads() between phases (a grid-wide sync would cost
// microseconds a tick for work narrower than one SM). The launch stages
// its working set in shared memory (98 KB at the paper's scale): every
// per-slot and per-hop field of the carry, the queues, the read-only
// topology the tick indexes (bw, buf, the switch tables), each slot's law
// config, the tick's temporaries and the contributor lists. The ticks run
// on it, and the carry is written back once at the end. The rings
// (hist_lam, hist_w [D, S], hist_q [D, 3(Q+1)]) stay in device memory,
// L2-resident: a tick reads them in two round trips, the delayed rates
// with the delayed observations (their rows are all from earlier ticks),
// then w_old, whose delay depends on the observation. Only a slot whose
// law updates this tick reads its observation and w_old, and a hop's
// delayed rate is read only where it counts (a real queue, after the
// slot's admission): every other read would be masked. Each queue's
// q / bw is computed once, where q is written. FCTs and record rows
// go straight to device memory. The wrapper plans the layout
// (kernels/fused_tick.py::layout); where it does not fit in shared
// memory (large S or Q), the same kernel runs on it in a global scratch
// buffer. Loops stride over blockDim.x, so any S, Q and H work.
//
// Contributor lists: each queue's contributors are the hop entries i
// (flat slot-major index over all S*H entries of the pool, retired slots'
// kept paths included) with path[i] == queue, in ascending i. They are
// kept as a CSR in shared memory (offsets [Q+2], entries [S*H]), which
// holds every entry, so no queue outgrows it. It is built at the start of
// the launch and rebuilt on each tick that admits a flow, by a block-wide
// stable counting sort: per-warp counts of each queue over contiguous
// ranges of entries (shared-memory integer atomics, whose result does not
// depend on order), their prefix over warps and queues, then each warp
// places its range in order, ranking equal queues within 32 entries by
// __match_any_sync. Each hop entry writes its delayed rate to its place in
// that order, and the arrival sum adds each queue's contiguous run from
// +0.0 in order: the order of the plain tick's gather table and of its
// in-order walk when the table overflows. The carry's gather table
// (inv [Q+1, maxdeg], truncated, padded with the sentinel S*H) and its
// overflow flag are written from the CSR at the end of a launch that
// rebuilt it, as build_csr_gather builds them.
//
// Numerics: built with -fmad=false (no contraction) and without fast
// math, so every division is IEEE round-to-nearest; max/min propagate NaN
// as torch.maximum/clamp do; rintf rounds half to even as torch.round;
// every float constant arrives as the float32 value PyTorch rounds it to;
// no float atomics. The carry then equals the plain tick's bit for bit.
// The per-tick record sums (w_sum, lam) add in this kernel's fixed order,
// not torch.sum's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kInt32Max = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDueChunk = 256;  // due counts staged in shared memory at once

// The staged fields, in the order of kernels/fused_tick.py::_fields; the
// wrapper passes each one's byte offset in the layout.
enum Field {
  // tick temporaries and the contributor lists
  F_CONTRIB, F_OBS, F_THETA_NOW, F_LAM, F_ACT, F_FREEF, F_SW_USED,
  F_CSR_OFF, F_CSR_LIST, F_CSR_POS, F_CSR_HIST,
  // queues and the read-only topology
  F_Q, F_OUT_RATE, F_QB, F_BW, F_BUF, F_SWITCH_OF_QUEUE, F_SW_TABLE,
  F_SWITCH_BUFFER,
  // hops
  F_PATH, F_TF_STEPS,
  // slots
  F_SLOT_FLOW, F_ADMIT_T, F_FREE_AT, F_RTT_STEPS, F_HOLD, F_PEND_FLOW,
  F_TAU, F_NIC, F_START, F_STOP, F_W, F_RATE_CAP, F_REMAINING,
  F_NEXT_UPDATE, F_LAST_UPDATE, F_GAMMA_SMOOTH, F_PREV_THETA, F_PEND_VAL,
  F_BETA, F_CTAU,
  kFields
};

}  // namespace

struct FusedTickArgs {
  // carry, updated in place
  int* cursor;
  int* hw;
  int* slot_flow;
  int* admit_t;
  int* free_at;
  int* path;
  int* tf_steps;
  int* rtt_steps;
  float* tau;
  float* nic;
  float* start;
  float* stop;
  float* w;
  float* rate_cap;
  float* q;
  float* out_rate;
  float* hist_lam;
  float* hist_q;
  float* hist_w;
  float* remaining;
  float* next_update;
  float* last_update;
  float* gamma_smooth;
  float* prev_theta;
  float* fct;
  int* pend_flow;
  float* pend_val;
  int* hold;
  int* inv;
  uint8_t* ovf;
  // schedule and law config, read only
  const int* s_path;
  const int* s_tf;
  const int* s_rtt;
  const float* s_tau;
  const float* s_nic;
  const float* s_start;
  const float* s_stop;
  const float* s_size;
  const float* c_beta;
  const float* c_tau;
  // topology, read only
  const float* bw;
  const float* buf;
  const int* sw_table;
  const float* switch_buffer;
  const int* switch_of_queue;
  // this block
  const int* due;
  float* rec_t;
  float* rec_q;
  float* rec_w_sum;
  float* rec_thru;
  float* rec_lam;
  float* rec_lam_f;
  int* rec_n_active;
  void* scratch;
  int S, N, Q, H, D, nsw, swdeg, nswb, maxdeg, K, t0, record_every, record,
      law, has_period, use_smem, layout_bytes;
  float dt, inv_dt, dt_alpha, gamma, one_minus_gamma, update_period;
  int off[kFields];
};

namespace {

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// a mod d in [0, d), as torch.remainder; a ring index is at most one
// ring length off, so the division is rarely needed
__device__ __forceinline__ int imod(int a, int d) {
  if (a >= 0 && a < d) return a;
  if (a < 0 && a >= -d) return a + d;
  return ((a % d) + d) % d;
}

__device__ __forceinline__ int iclamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// Block-wide sum of one int per thread; every thread gets the total.
__device__ int block_sum_int(int v, int* wbuf) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) wbuf[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  for (int i = 0; i < kWarps; ++i) tot += wbuf[i];
  return tot;
}

// Block-wide sum of one float per thread, in a fixed order (a shuffle
// tree in each warp, then the warps in order).
__device__ float block_sum_float(float v, float* wbuf) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) wbuf[threadIdx.x >> 5] = v;
  __syncthreads();
  float tot = 0.0f;
  for (int i = 0; i < kWarps; ++i) tot += wbuf[i];
  return tot;
}

// Inclusive prefix sum of one int per thread over the block; *total gets
// the block's sum.
__device__ int block_scan_int(int v, int* wbuf, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) wbuf[wid] = x;
  __syncthreads();
  int off = 0, tot = 0;
  for (int i = 0; i < kWarps; ++i) {
    const int s = wbuf[i];
    if (i < wid) off += s;
    tot += s;
  }
  *total = tot;
  return x + off;
}

// The contributor lists of the Q real queues over the hop entries of
// ``path`` ([SH]; entries >= Q, the sentinel, are left out): off[c] ..
// off[c+1] index list[], which holds each queue's entries in ascending
// order, and pos[i] is entry i's place in list[] (SH, a spare cell, for a
// sentinel entry). ``hist`` is [kWarps, Q1] scratch. Returns
// (block-uniform) whether some queue has more than maxdeg contributors.
// Called by the whole block.
__device__ int build_csr(const int* path, int SH, int Q, int maxdeg,
                         int* off, int* list, int* pos, int* hist,
                         int* wbuf) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int Q1 = Q + 1;
  const int R = (SH + kWarps - 1) / kWarps;
  const int lo = min(wid * R, SH), hi = min(lo + R, SH);
  for (int i = tid; i < kWarps * Q1; i += kThreads) hist[i] = 0;
  __syncthreads();
  // per-warp counts over the warp's contiguous range of entries
  for (int i = lo + lane; i < hi; i += 32) {
    const int c = path[i];
    if (c < Q) atomicAdd(&hist[wid * Q1 + c], 1);
  }
  __syncthreads();
  // each queue: the warps' exclusive prefix, and its total
  int over = 0;
  for (int c = tid; c < Q1; c += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int h = hist[w * Q1 + c];
      hist[w * Q1 + c] = run;
      run += h;
    }
    off[c] = run;
    over |= c < Q && run > maxdeg;
  }
  // exclusive prefix over the queues (each thread rescans its own queues)
  int carry = 0;
  for (int b = 0; b < Q1; b += kThreads) {
    const int c = b + tid;
    const int v = c < Q1 ? off[c] : 0;
    int tot;
    const int inc = block_scan_int(v, wbuf, &tot);
    if (c < Q1) off[c] = carry + inc - v;
    carry += tot;
  }
  if (tid == 0) off[Q1] = carry;
  const int ovf = __syncthreads_or(over);
  // each warp places its range in order, 32 entries at a time; equal
  // queues within the 32 rank by lane
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const int c = i < hi ? path[i] : Q;
    const unsigned grp = __match_any_sync(kFull, c);
    const int rank = __popc(grp & ((1u << lane) - 1u));
    int at = SH;
    if (c < Q) at = off[c] + hist[wid * Q1 + c] + rank;
    __syncwarp();
    if (i < hi) pos[i] = at;
    if (c < Q) {
      list[at] = i;
      if (rank == 0) hist[wid * Q1 + c] += __popc(grp);
    }
    __syncwarp();
  }
  __syncthreads();
  return ovf;
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* base, int off) {
  return reinterpret_cast<T*>(base + off);
}

template <int LAW, bool SMEM>  // LAW 0: PowerTCP (Algorithm 1), 1: theta
__global__ void __launch_bounds__(kThreads)
fused_tick_kernel(const FusedTickArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wbuf_i[kWarps];
  __shared__ float wbuf_f[kWarps];
  __shared__ int sh_cursor, sh_hw;
  __shared__ int sh_due[kDueChunk];

  const int tid = threadIdx.x;
  const int S = a.S, N = a.N, Q = a.Q, Q1 = Q + 1, H = a.H, D = a.D;
  const int SH = S * H, maxdeg = a.maxdeg;
  const float dt = a.dt;

  unsigned char* base =
      SMEM ? smem_raw : static_cast<unsigned char*>(a.scratch);
  float* contrib = at<float>(base, a.off[F_CONTRIB]);  // [SH + 1], CSR order
  float* obs = at<float>(base, a.off[F_OBS]);  // [NOBS, SH]: q, out, qdot
  float* theta_now = at<float>(base, a.off[F_THETA_NOW]);  // [S]
  float* lam_s = at<float>(base, a.off[F_LAM]);            // [S]
  int* act = at<int>(base, a.off[F_ACT]);                  // [S]
  int* freef = at<int>(base, a.off[F_FREEF]);              // [S]
  float* sw_used = at<float>(base, a.off[F_SW_USED]);      // [nsw]
  int* csr_off = at<int>(base, a.off[F_CSR_OFF]);          // [Q1 + 1]
  int* csr_list = at<int>(base, a.off[F_CSR_LIST]);        // [SH]
  int* csr_pos = at<int>(base, a.off[F_CSR_POS]);          // [SH]
  int* csr_hist = at<int>(base, a.off[F_CSR_HIST]);        // [kWarps, Q1]
  float* q = at<float>(base, a.off[F_Q]);
  float* out_rate = at<float>(base, a.off[F_OUT_RATE]);
  float* qb = at<float>(base, a.off[F_QB]);  // q / bw, each queue's delay
  float* bw = at<float>(base, a.off[F_BW]);
  float* buf = at<float>(base, a.off[F_BUF]);
  int* sw_of_q = at<int>(base, a.off[F_SWITCH_OF_QUEUE]);
  int* sw_table = at<int>(base, a.off[F_SW_TABLE]);
  float* sw_buffer = at<float>(base, a.off[F_SWITCH_BUFFER]);
  int* spath = at<int>(base, a.off[F_PATH]);
  int* tf_steps = at<int>(base, a.off[F_TF_STEPS]);
  int* slot_flow = at<int>(base, a.off[F_SLOT_FLOW]);
  int* admit_t = at<int>(base, a.off[F_ADMIT_T]);
  int* free_at = at<int>(base, a.off[F_FREE_AT]);
  int* rtt_steps = at<int>(base, a.off[F_RTT_STEPS]);
  int* hold = at<int>(base, a.off[F_HOLD]);
  int* pend_flow = at<int>(base, a.off[F_PEND_FLOW]);
  float* taus = at<float>(base, a.off[F_TAU]);
  float* nics = at<float>(base, a.off[F_NIC]);
  float* start = at<float>(base, a.off[F_START]);
  float* stop = at<float>(base, a.off[F_STOP]);
  float* ws = at<float>(base, a.off[F_W]);
  float* rate_cap = at<float>(base, a.off[F_RATE_CAP]);
  float* remaining = at<float>(base, a.off[F_REMAINING]);
  float* next_update = at<float>(base, a.off[F_NEXT_UPDATE]);
  float* last_update = at<float>(base, a.off[F_LAST_UPDATE]);
  float* gamma_smooth = at<float>(base, a.off[F_GAMMA_SMOOTH]);
  float* prev_theta = at<float>(base, a.off[F_PREV_THETA]);
  float* pend_val = at<float>(base, a.off[F_PEND_VAL]);
  float* betas = at<float>(base, a.off[F_BETA]);
  float* ctaus = at<float>(base, a.off[F_CTAU]);

  // -- stage the carry, the topology and each slot's law config --------
  for (int s = tid; s < S; s += kThreads) {
    const int sf = a.slot_flow[s];
    const int g = min(max(sf, 0), N - 1);
    const int i0 = a.admit_t[s], i1 = a.free_at[s], i2 = a.rtt_steps[s],
              i3 = a.hold[s], i4 = a.pend_flow[s];
    const float f0 = a.tau[s], f1 = a.nic[s], f2 = a.start[s],
                f3 = a.stop[s], f4 = a.w[s], f5 = a.rate_cap[s],
                f6 = a.remaining[s], f7 = a.next_update[s],
                f8 = a.last_update[s], f9 = a.gamma_smooth[s],
                f10 = a.pend_val[s], f11 = LAW == 1 ? a.prev_theta[s] : 0.0f;
    const float be = a.c_beta[g], ct = a.c_tau[g];
    slot_flow[s] = sf;
    admit_t[s] = i0;
    free_at[s] = i1;
    rtt_steps[s] = i2;
    hold[s] = i3;
    pend_flow[s] = i4;
    taus[s] = f0;
    nics[s] = f1;
    start[s] = f2;
    stop[s] = f3;
    ws[s] = f4;
    rate_cap[s] = f5;
    remaining[s] = f6;
    next_update[s] = f7;
    last_update[s] = f8;
    gamma_smooth[s] = f9;
    pend_val[s] = f10;
    if (LAW == 1) prev_theta[s] = f11;
    betas[s] = be;
    ctaus[s] = ct;
  }
  const int nsw_all = a.nsw * a.swdeg;
  const int nstage = max(max(SH, Q1), max(nsw_all, a.nswb));
  for (int i = tid; i < nstage; i += kThreads) {
    int p = 0, tf = 0, so = 0, st = 0;
    float qv = 0.0f, ov = 0.0f, bv = 0.0f, fv = 0.0f, sb = 0.0f;
    if (i < SH) {
      p = a.path[i];
      tf = a.tf_steps[i];
    }
    if (i < Q1) {
      qv = a.q[i];
      ov = a.out_rate[i];
      bv = a.bw[i];
      fv = a.buf[i];
    }
    if (i < Q) so = a.switch_of_queue[i];
    if (i < nsw_all) st = a.sw_table[i];
    if (i < a.nswb) sb = a.switch_buffer[i];
    if (i < SH) {
      spath[i] = p;
      tf_steps[i] = tf;
    }
    if (i < Q1) {
      q[i] = qv;
      out_rate[i] = ov;
      qb[i] = qv / bv;
      bw[i] = bv;
      buf[i] = fv;
    }
    if (i < Q) sw_of_q[i] = so;
    if (i < nsw_all) sw_table[i] = st;
    if (i < a.nswb) sw_buffer[i] = sb;
  }
  if (tid == 0) {
    sh_cursor = *a.cursor;
    sh_hw = *a.hw;
  }
  __syncthreads();
  int ovf = build_csr(spath, SH, Q, maxdeg, csr_off, csr_list, csr_pos,
                      csr_hist, wbuf_i);
  int rebuilt = 0;

  for (int k = 0; k < a.K; ++k) {
    const int t = a.t0 + k;
    const float t_sec = static_cast<float>(t) * dt;
    const int ptr = t % D;
    if (k % kDueChunk == 0) {
      for (int i = tid; i < kDueChunk && k + i < a.K; i += kThreads)
        sh_due[i] = a.due[k + i];
      __syncthreads();
    }
    const int due_t = sh_due[k % kDueChunk];
    const int cursor = sh_cursor;
    const bool rec_row = a.record && ((k + 1) % a.record_every == 0);
    const int r = (k + 1) / a.record_every - 1;

    // -- 2. gate --------------------------------------------------------
    int local = (tid == 0 && due_t > cursor);
    for (int s = tid; s < S; s += kThreads)
      local |= (slot_flow[s] < N && t >= free_at[s]);
    const int need = __syncthreads_or(local);

    // -- 3. admit / retire ----------------------------------------------
    if (need) {
      const int hw = sh_hw;
      int n_occ = 0, n_fresh_free = 0;
      for (int s = tid; s < S; s += kThreads) {
        int sf = slot_flow[s];
        if (sf < N && t >= free_at[s]) {
          const int pf = pend_flow[s];
          if (pf < N) {
            a.fct[pf] = pend_val[s];
            pend_flow[s] = N;
            pend_val[s] = qnan();
          }
          sf = N;
          slot_flow[s] = N;
        }
        const int fr = sf >= N;
        freef[s] = fr;
        n_occ += !fr;
        n_fresh_free += fr && s >= hw;
      }
      n_occ = block_sum_int(n_occ, wbuf_i);
      n_fresh_free = block_sum_int(n_fresh_free, wbuf_i);
      const int n_admit = min(due_t - cursor, S - n_occ);
      const int n_fresh = min(n_admit, n_fresh_free);
      const int n_rec = n_admit - n_fresh;
      // fresh (never used, s >= hw) slots first in slot order, then
      // recycled ones (s < hw); the admitted slots take the next flows in
      // slot order
      int c_fresh = 0, c_rec = 0, c_adm = 0;
      for (int b = 0; b < S; b += kThreads) {
        const int s = b + tid;
        const int fr = s < S && freef[s] && s >= hw;
        const int rc = s < S && freef[s] && s < hw;
        int tot_f, tot_r, tot_a;
        const int inc_f = block_scan_int(fr, wbuf_i, &tot_f);
        const int inc_r = block_scan_int(rc, wbuf_i, &tot_r);
        const int adm = (fr && c_fresh + inc_f - 1 < n_fresh) ||
                        (rc && c_rec + inc_r - 1 < n_rec);
        const int inc_a = block_scan_int(adm, wbuf_i, &tot_a);
        if (adm) {
          const int f = cursor + c_adm + inc_a - 1;
          const int g = min(max(f, 0), N - 1);
          slot_flow[s] = f;
          admit_t[s] = t;
          free_at[s] = kInt32Max;
          int hmax = 0;
          for (int h = 0; h < H; ++h) {
            const int p = a.s_path[g * H + h];
            const int tf = a.s_tf[g * H + h];
            spath[s * H + h] = p;
            tf_steps[s * H + h] = tf;
            if (p < Q) hmax = max(hmax, tf);
          }
          hold[s] = hmax;
          rtt_steps[s] = a.s_rtt[g];
          const float tau = a.s_tau[g], nic = a.s_nic[g], st = a.s_start[g];
          taus[s] = tau;
          nics[s] = nic;
          start[s] = st;
          stop[s] = a.s_stop[g];
          ws[s] = nic * tau;
          rate_cap[s] = __int_as_float(0x7f800000);
          remaining[s] = a.s_size[g];
          next_update[s] = st + tau;
          last_update[s] = st;
          gamma_smooth[s] = 1.0f;
          const float ctau = a.c_tau[g];
          betas[s] = a.c_beta[g];
          ctaus[s] = ctau;
          if (LAW == 1) prev_theta[s] = ctau * 1.0f;
        }
        c_fresh += tot_f;
        c_rec += tot_r;
        c_adm += tot_a;
      }
      __syncthreads();
      if (tid == 0) {
        sh_cursor = cursor + n_admit;
        sh_hw = hw + n_fresh;
      }
      if (n_admit > 0) {
        ovf = build_csr(spath, SH, Q, maxdeg, csr_off, csr_list, csr_pos,
                        csr_hist, wbuf_i);
        rebuilt = 1;
      }
    }

    // -- 4. rates and rings; delayed rates and observations --------------
    // Only an updating slot's law reads the delayed observation and w_old
    // (every other slot keeps its law state and window before the clamp),
    // and a hop's delayed rate only counts on a real queue after the
    // slot's admission: the ring reads skip the rest.
    for (int s = tid; s < S; s += kThreads) {
      const bool occ = slot_flow[s] < N;
      const float tau = taus[s], nic = nics[s], w = ws[s];
      const bool active = occ && t_sec >= start[s] && remaining[s] > 0.0f &&
                          t_sec < stop[s];
      const bool upd = active && t_sec >= next_update[s];
      float acc = 0.0f;
      for (int h = 0; h < H; ++h) {
        const int p = spath[s * H + h];
        const float x = p < Q ? qb[p] : 0.0f;
        acc = h ? acc + x : x;
      }
      const float th = tau + acc;
      float lam = 0.0f;
      if (active) lam = pmin(pmin(w / th, rate_cap[s]), nic);
      a.hist_lam[ptr * S + s] = lam;
      a.hist_w[ptr * S + s] = w;
      theta_now[s] = th;
      lam_s[s] = lam;
      act[s] = active | (upd << 1);
      const int adm = admit_t[s], rtt = rtt_steps[s];
#pragma unroll 4
      for (int h = 0; h < H; ++h) {
        const int e = s * H + h;
        const int p = spath[e];
        const int tf = tf_steps[e];
        float ld = 0.0f;
        if (p < Q && t - tf >= adm)
          ld = a.hist_lam[imod(ptr - tf, D) * S + s];
        contrib[csr_pos[e]] = ld;
        if (upd && p < Q) {
          const int oh = imod(ptr - iclamp(rtt - tf, 1, D - 2), D);
          const float* orow = a.hist_q + static_cast<long long>(oh) * 3 * Q1;
          obs[e] = orow[p];
          if (LAW == 0) {
            obs[SH + e] = orow[Q1 + p];
            obs[2 * SH + e] = orow[2 * Q1 + p];
          }
        }
      }
    }
    // -- 5. switch occupancy (the last threads, which hold no slot) ------
    for (int sw = kThreads - 1 - tid; sw < a.nsw; sw += kThreads) {
      float used = 0.0f;
#pragma unroll 8
      for (int j = 0; j < a.swdeg; ++j)
        used = used + q[sw_table[sw * a.swdeg + j]];
      sw_used[sw] = used;
    }
    __syncthreads();

    // -- 6. queues: arrivals, caps, integration, packed ring row --------
    float* hrow = a.hist_q + static_cast<long long>(ptr) * 3 * Q1;
    for (int c = tid; c < Q1; c += kThreads) {
      float arr = 0.0f;
      const int hi = csr_off[c + 1];
#pragma unroll 8
      for (int j = csr_off[c]; j < hi; ++j) arr = arr + contrib[j];
      float cap = buf[c];
      if (a.nsw > 0 && c < Q) {
        const int sw = sw_of_q[c];
        const float fr = pmax(sw_buffer[sw] - sw_used[sw], 0.0f);
        cap = pmin(a.dt_alpha * fr, cap);
      }
      const float qc = q[c], bwc = bw[c];
      float qn = pmin(pmax(qc + (arr - bwc) * dt, 0.0f), cap);
      if (c == Q) qn = 0.0f;
      const float out = qc > 0.0f ? bwc : pmin(arr, bwc);
      q[c] = qn;
      qb[c] = qn / bwc;
      out_rate[c] = out;
      hrow[c] = qn;
      hrow[Q1 + c] = out;
      hrow[2 * Q1 + c] = (qn - qc) * a.inv_dt;
      if (rec_row) {
        a.rec_q[r * Q1 + c] = qn;
        a.rec_thru[r * Q1 + c] = out;
      }
    }
    __syncthreads();

    // -- 7.-9. observation, law, progress --------------------------------
    float w_sum = 0.0f, lam_sum = 0.0f;
    int n_act = 0;
    for (int s = tid; s < S; s += kThreads) {
      const int sf = slot_flow[s];
      const bool occ = sf < N;
      const bool active = (act[s] & 1) != 0, upd = (act[s] & 2) != 0;
      const float tau = taus[s], nic = nics[s], w = ws[s];
      const float th_now = theta_now[s], lam = lam_s[s];
      float wl = w;
      if (upd) {
        const float beta = betas[s], ctau = ctaus[s];
        float acc = 0.0f, gmax = 0.0f;
        for (int h = 0; h < H; ++h) {
          const int e = s * H + h;
          const int p = spath[e];
          float x = 0.0f, gh = 0.0f;
          if (p < Q) {
            const float q_obs = obs[e];
            const float b = bw[p];
            x = q_obs / b;
            if (LAW == 0) {
              // NORMPOWER: (qdot + mu)(q + b tau) * (1 / max(b^2 tau, 1))
              const float current = obs[2 * SH + e] + obs[SH + e];
              const float bdp = b * ctau;
              const float voltage = q_obs + bdp;
              const float base_ = bdp * b;
              const float power = current * voltage;
              gh = power * (1.0f / pmax(base_, 1.0f));
            }
          }
          acc = h ? acc + x : x;
          if (LAW == 0) gmax = h ? pmax(gmax, gh) : gh;
        }
        const float theta_obs = tau + acc;
        const int wd =
            iclamp(static_cast<int>(rintf(theta_obs / dt)), 1, D - 2);
        float w_old = a.hist_w[imod(ptr - wd, D) * S + s];
        if (!(t - wd >= admit_t[s])) w_old = nic * tau;
        const float dt_obs = pmax(t_sec - last_update[s], dt);

        // law: smoothing of the normalized power, then UPDATEWINDOW
        float gnorm = gmax;
        if (LAW == 1) {
          const float prev = prev_theta[s];
          const float thetadot = (theta_obs - prev) / pmax(dt_obs, 1e-12f);
          gnorm = (thetadot + 1.0f) * theta_obs / pmax(ctau, 1e-12f);
          prev_theta[s] = theta_obs;
        }
        const float gs_prev = gamma_smooth[s];
        const float d = pmin(pmax(dt_obs, 0.0f), ctau);
        const float blend = gs_prev * (ctau - d) + gnorm * d;
        const float gs = blend / pmax(ctau, 1e-12f);
        const float target = w_old / pmax(gs, 1e-9f) + beta;
        const float w_new = a.gamma * target + a.one_minus_gamma * w;
        wl = pmax(w_new, 1000.0f);
        gamma_smooth[s] = gs;
        next_update[s] = t_sec + (a.has_period ? a.update_period : th_now);
        last_update[s] = t_sec;
      }
      wl = pmin(pmax(wl, 1000.0f), 8.0f * nic * tau + 8.0f * nic * th_now);
      ws[s] = wl;

      // progress; a completion parks in the pending buffer
      float rem = remaining[s];
      if (active) rem = rem - lam * dt;
      remaining[s] = rem;
      const bool done = active && rem <= 0.0f;
      if (done) {
        pend_flow[s] = sf;
        pend_val[s] = t_sec + tau / 2.0f - start[s];
      }
      const bool expire = occ && t_sec >= stop[s] &&
                          free_at[s] == kInt32Max && !done;
      if (done || expire) free_at[s] = t + hold[s] + 1;

      if (rec_row) a.rec_lam_f[r * S + s] = lam;
      w_sum += active ? wl : 0.0f;
      lam_sum += lam;
      n_act += active;
    }

    // -- 10. record row ---------------------------------------------------
    if (rec_row) {
      w_sum = block_sum_float(w_sum, wbuf_f);
      lam_sum = block_sum_float(lam_sum, wbuf_f);
      n_act = block_sum_int(n_act, wbuf_i);
      if (tid == 0) {
        a.rec_t[r] = t_sec;
        a.rec_w_sum[r] = w_sum;
        a.rec_lam[r] = lam_sum;
        a.rec_n_active[r] = n_act;
      }
    }
    __syncthreads();
  }

  // -- write the carry back ----------------------------------------------
  for (int s = tid; s < S; s += kThreads) {
    a.slot_flow[s] = slot_flow[s];
    a.admit_t[s] = admit_t[s];
    a.free_at[s] = free_at[s];
    a.rtt_steps[s] = rtt_steps[s];
    a.hold[s] = hold[s];
    a.pend_flow[s] = pend_flow[s];
    a.tau[s] = taus[s];
    a.nic[s] = nics[s];
    a.start[s] = start[s];
    a.stop[s] = stop[s];
    a.w[s] = ws[s];
    a.rate_cap[s] = rate_cap[s];
    a.remaining[s] = remaining[s];
    a.next_update[s] = next_update[s];
    a.last_update[s] = last_update[s];
    a.gamma_smooth[s] = gamma_smooth[s];
    a.pend_val[s] = pend_val[s];
    if (LAW == 1) a.prev_theta[s] = prev_theta[s];
  }
  for (int i = tid; i < SH; i += kThreads) {
    a.path[i] = spath[i];
    a.tf_steps[i] = tf_steps[i];
  }
  for (int c = tid; c < Q1; c += kThreads) {
    a.q[c] = q[c];
    a.out_rate[c] = out_rate[c];
  }
  if (rebuilt) {
    // the carry's gather table, as build_csr_gather builds it: each real
    // queue's first maxdeg contributors, padded with the sentinel SH
    for (int i = tid; i < Q1 * maxdeg; i += kThreads) {
      const int c = i / maxdeg, j = i - c * maxdeg;
      const int lo = csr_off[c];
      a.inv[i] = j < csr_off[c + 1] - lo ? csr_list[lo + j] : SH;
    }
    if (tid == 0) *a.ovf = static_cast<uint8_t>(ovf);
  }
  if (tid == 0) {
    *a.cursor = sh_cursor;
    *a.hw = sh_hw;
  }
}

template <int LAW>
int launch(const FusedTickArgs& a, cudaStream_t stream) {
  if (a.use_smem) {
    void (*kern)(const FusedTickArgs) = fused_tick_kernel<LAW, true>;
    const size_t smem = static_cast<size_t>(a.layout_bytes);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<1, kThreads, smem, stream>>>(a);
  } else {
    fused_tick_kernel<LAW, false><<<1, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of K ticks. The wrapper fills the layout offsets (and, when
// the layout is not in shared memory, a global scratch buffer of
// layout_bytes) from kernels/fused_tick.py::layout.
extern "C" int fused_tick_block_f32(const FusedTickArgs* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return args->law == 1 ? launch<1>(*args, s) : launch<0>(*args, s);
}

// sizeof(FusedTickArgs) and kFields, which the wrapper checks against its
// own struct before the first launch.
extern "C" int fused_tick_abi(int* fields) {
  *fields = kFields;
  return static_cast<int>(sizeof(FusedTickArgs));
}
