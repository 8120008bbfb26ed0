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
//      contributor table (ascending flat order) when the cursor moved;
//   4. theta_now and the send rates, written to the rings;
//   5. the delayed per-hop rates, masked before admission;
//   6. per queue: the in-order arrival sum from +0.0, the Dynamic-
//      Thresholds caps (per-switch ascending fold), the integration and
//      the packed [q | out | qdot] ring row;
//   7. the delayed observation, theta_obs, the w_old delay and w_old;
//   8. the law update, the window clamp and the update timers;
//   9. progress, completions into the pending buffer, free_at;
//  10. the record row, when recording.
//
// Bound: not bytes. One tick touches ~1 150 hop entries, 384 slots and 289
// queues at the paper's scale (a few tens of kB, all resident in the 50 MB
// L2), but its phases depend on each other: rates before arrivals, queues
// before the observation, the observation before the law. What bounds a
// tick is that chain of dependent phases, each a round trip to L2 or
// shared memory, plus the block barriers between them.
//
// Design: one persistent thread block runs the whole block of K ticks,
// with __syncthreads() between phases. A block barrier costs tens of ns;
// a grid-wide sync would cost microseconds a tick for work that is
// narrower than one SM. The carry (~3.5 MB at the paper's scale: rings
// [D, S] and [D, 3(Q+1)], the FCT table, the gather table) stays in device
// memory, where it is L2-resident; the flat hop list, the per-hop
// contributions and the per-slot temporaries live in shared memory (in a
// global scratch buffer when they do not fit). Loops stride over
// blockDim.x, so any S, Q and H work. No atomics: every sum runs in a
// fixed order.
//
// Numerics: built with -fmad=false (no contraction) and without fast
// math, so every division is IEEE round-to-nearest; max/min propagate NaN
// as torch.maximum/clamp do; rintf rounds half to even as torch.round;
// every float constant arrives as the float32 value PyTorch rounds it to.
// The carry then equals the plain tick's bit for bit. The per-tick record
// sums (w_sum, lam) add in this kernel's fixed order, not torch.sum's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kInt32Max = 2147483647;
constexpr unsigned kFull = 0xffffffffu;

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
  int S, N, Q, H, D, nsw, swdeg, maxdeg, K, t0, record_every, record, law,
      has_period, use_smem;
  float dt, inv_dt, dt_alpha, gamma, one_minus_gamma, update_period;
};

namespace {

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ int imod(int a, int d) { return ((a % d) + d) % d; }

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

template <int LAW>  // 0: PowerTCP (Algorithm 1), 1: theta-PowerTCP (Alg. 2)
__global__ void __launch_bounds__(kThreads)
fused_tick_kernel(const FusedTickArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wbuf_i[kWarps];
  __shared__ float wbuf_f[kWarps];

  const int tid = threadIdx.x;
  const int S = a.S, N = a.N, Q = a.Q, Q1 = Q + 1, H = a.H, D = a.D;
  const int SH = S * H, maxdeg = a.maxdeg;
  const float dt = a.dt;

  unsigned char* base =
      a.use_smem ? smem_raw : static_cast<unsigned char*>(a.scratch);
  float* contrib = reinterpret_cast<float*>(base);  // [S*H]
  float* theta_now = contrib + SH;                  // [S]
  float* lam_s = theta_now + S;                     // [S]
  float* sw_used = lam_s + S;                       // [nsw]
  int* spath = reinterpret_cast<int*>(sw_used + a.nsw);  // [S*H]
  int* act = spath + SH;                            // [S]
  int* freef = act + S;                             // [S]

  for (int i = tid; i < SH; i += kThreads) spath[i] = a.path[i];
  int ovf = *a.ovf;
  __syncthreads();

  for (int k = 0; k < a.K; ++k) {
    const int t = a.t0 + k;
    const float t_sec = static_cast<float>(t) * dt;
    const int ptr = t % D;
    const int due_t = a.due[k];
    const int cursor = *a.cursor;
    const bool rec_row = a.record && ((k + 1) % a.record_every == 0);
    const int r = (k + 1) / a.record_every - 1;

    // -- 2. gate --------------------------------------------------------
    int local = (tid == 0 && due_t > cursor);
    for (int s = tid; s < S; s += kThreads)
      local |= (a.slot_flow[s] < N && t >= a.free_at[s]);
    const int need = __syncthreads_or(local);

    // -- 3. admit / retire ----------------------------------------------
    if (need) {
      const int hw = *a.hw;
      int n_occ = 0, n_fresh_free = 0;
      for (int s = tid; s < S; s += kThreads) {
        int sf = a.slot_flow[s];
        if (sf < N && t >= a.free_at[s]) {
          const int pf = a.pend_flow[s];
          if (pf < N) {
            a.fct[pf] = a.pend_val[s];
            a.pend_flow[s] = N;
            a.pend_val[s] = qnan();
          }
          sf = N;
          a.slot_flow[s] = N;
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
          a.slot_flow[s] = f;
          a.admit_t[s] = t;
          a.free_at[s] = kInt32Max;
          int hold = 0;
          for (int h = 0; h < H; ++h) {
            const int p = a.s_path[g * H + h];
            const int tf = a.s_tf[g * H + h];
            a.path[s * H + h] = p;
            spath[s * H + h] = p;
            a.tf_steps[s * H + h] = tf;
            if (p < Q) hold = max(hold, tf);
          }
          a.hold[s] = hold;
          a.rtt_steps[s] = a.s_rtt[g];
          const float tau = a.s_tau[g], nic = a.s_nic[g], st = a.s_start[g];
          a.tau[s] = tau;
          a.nic[s] = nic;
          a.start[s] = st;
          a.stop[s] = a.s_stop[g];
          a.w[s] = nic * tau;
          a.rate_cap[s] = __int_as_float(0x7f800000);
          a.remaining[s] = a.s_size[g];
          a.next_update[s] = st + tau;
          a.last_update[s] = st;
          a.gamma_smooth[s] = 1.0f;
          if (LAW == 1) a.prev_theta[s] = a.c_tau[g] * 1.0f;
        }
        c_fresh += tot_f;
        c_rec += tot_r;
        c_adm += tot_a;
      }
      __syncthreads();
      if (tid == 0) {
        *a.cursor = cursor + n_admit;
        *a.hw = hw + n_fresh;
      }
      if (n_admit > 0) {
        // per-queue contributors in ascending flat (slot-major) order,
        // padded with the sentinel index S*H; the sentinel queue has none
        int over = 0;
        for (int c = tid; c < Q1; c += kThreads) {
          int* row = a.inv + c * maxdeg;
          int cnt = 0;
          if (c < Q) {
            for (int i = 0; i < SH; ++i) {
              if (spath[i] == c) {
                if (cnt < maxdeg) row[cnt] = i;
                ++cnt;
              }
            }
          }
          for (int j = cnt; j < maxdeg; ++j) row[j] = SH;
          over |= cnt > maxdeg;
        }
        ovf = __syncthreads_or(over);
        if (tid == 0) *a.ovf = static_cast<uint8_t>(ovf);
      }
    }

    // -- 4./5. rates, rings, delayed per-hop rates; switch occupancy -----
    for (int s = tid; s < S; s += kThreads) {
      const bool occ = a.slot_flow[s] < N;
      const float tau = a.tau[s], nic = a.nic[s], w = a.w[s];
      const bool active = occ && t_sec >= a.start[s] &&
                          a.remaining[s] > 0.0f && t_sec < a.stop[s];
      float acc = 0.0f;
      for (int h = 0; h < H; ++h) {
        const int p = spath[s * H + h];
        const float x = p < Q ? a.q[p] / a.bw[p] : 0.0f;
        acc = h ? acc + x : x;
      }
      const float th = tau + acc;
      const float lam = active ? pmin(pmin(w / th, a.rate_cap[s]), nic) : 0.0f;
      a.hist_lam[ptr * S + s] = lam;
      a.hist_w[ptr * S + s] = w;
      theta_now[s] = th;
      lam_s[s] = lam;
      act[s] = active;
      const int adm = a.admit_t[s];
      for (int h = 0; h < H; ++h) {
        const int tf = a.tf_steps[s * H + h];
        float ld = a.hist_lam[imod(ptr - tf, D) * S + s];
        if (!(t - tf >= adm)) ld = 0.0f;
        contrib[s * H + h] = spath[s * H + h] < Q ? ld : 0.0f;
      }
    }
    for (int sw = tid; sw < a.nsw; sw += kThreads) {
      float used = 0.0f;
      for (int j = 0; j < a.swdeg; ++j) used = used + a.q[a.sw_table[sw * a.swdeg + j]];
      sw_used[sw] = used;
    }
    __syncthreads();

    // -- 6. queues: arrivals, caps, integration, packed ring row --------
    float* hrow = a.hist_q + static_cast<long long>(ptr) * 3 * Q1;
    for (int c = tid; c < Q1; c += kThreads) {
      const int* row = a.inv + c * maxdeg;
      float arr = 0.0f;
      if (ovf && row[maxdeg - 1] != SH) {
        // the table may be truncated for this queue: walk the hop list
        for (int i = 0; i < SH; ++i)
          if (spath[i] == c) arr = arr + contrib[i];
      } else {
        for (int j = 0; j < maxdeg; ++j) {
          const int idx = row[j];
          if (idx == SH) break;
          arr = arr + contrib[idx];
        }
      }
      float cap = a.buf[c];
      if (a.nsw > 0 && c < Q) {
        const int sw = a.switch_of_queue[c];
        const float fr = pmax(a.switch_buffer[sw] - sw_used[sw], 0.0f);
        cap = pmin(a.dt_alpha * fr, cap);
      }
      const float qc = a.q[c], bwc = a.bw[c];
      float qn = pmin(pmax(qc + (arr - bwc) * dt, 0.0f), cap);
      if (c == Q) qn = 0.0f;
      const float out = qc > 0.0f ? bwc : pmin(arr, bwc);
      a.q[c] = qn;
      a.out_rate[c] = out;
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
      const int sf = a.slot_flow[s];
      const bool occ = sf < N;
      const bool active = act[s] != 0;
      const float tau = a.tau[s], nic = a.nic[s], w = a.w[s];
      const float th_now = theta_now[s], lam = lam_s[s];
      const int g = min(max(sf, 0), N - 1);
      const float beta = a.c_beta[g], ctau = a.c_tau[g];
      const int rtt = a.rtt_steps[s];
      float acc = 0.0f, gmax = 0.0f;
      for (int h = 0; h < H; ++h) {
        const int p = spath[s * H + h];
        const int tf = a.tf_steps[s * H + h];
        const bool valid = p < Q;
        const int oh = imod(ptr - iclamp(rtt - tf, 1, D - 2), D);
        const float* orow = a.hist_q + static_cast<long long>(oh) * 3 * Q1;
        const float q_obs = orow[p];
        const float b = a.bw[p];
        const float x = valid ? q_obs / b : 0.0f;
        acc = h ? acc + x : x;
        if (LAW == 0) {
          // NORMPOWER: (qdot + mu)(q + b tau) * (1 / max(b^2 tau, 1))
          const float current = orow[2 * Q1 + p] + orow[Q1 + p];
          const float bdp = b * ctau;
          const float voltage = q_obs + bdp;
          const float base_ = bdp * b;
          const float power = current * voltage;
          const float gh = valid ? power * (1.0f / pmax(base_, 1.0f)) : 0.0f;
          gmax = h ? pmax(gmax, gh) : gh;
        }
      }
      const float theta_obs = tau + acc;
      const int wd = iclamp(static_cast<int>(rintf(theta_obs / dt)), 1, D - 2);
      float w_old = a.hist_w[imod(ptr - wd, D) * S + s];
      if (!(t - wd >= a.admit_t[s])) w_old = nic * tau;
      const bool upd = active && t_sec >= a.next_update[s];
      const float dt_obs = pmax(t_sec - a.last_update[s], dt);

      // law: smoothing of the normalized power, then UPDATEWINDOW
      float gnorm = gmax;
      const float prev = LAW == 1 ? a.prev_theta[s] : 0.0f;
      if (LAW == 1) {
        const float thetadot = (theta_obs - prev) / pmax(dt_obs, 1e-12f);
        gnorm = (thetadot + 1.0f) * theta_obs / pmax(ctau, 1e-12f);
      }
      const float gs_prev = a.gamma_smooth[s];
      const float d = pmin(pmax(dt_obs, 0.0f), ctau);
      const float blend = gs_prev * (ctau - d) + gnorm * d;
      const float gs = upd ? blend / pmax(ctau, 1e-12f) : gs_prev;
      const float target = w_old / pmax(gs, 1e-9f) + beta;
      const float w_new = a.gamma * target + a.one_minus_gamma * w;
      float wl = upd ? pmax(w_new, 1000.0f) : w;
      wl = pmin(pmax(wl, 1000.0f), 8.0f * nic * tau + 8.0f * nic * th_now);
      a.w[s] = wl;
      a.gamma_smooth[s] = gs;
      if (LAW == 1) a.prev_theta[s] = upd ? theta_obs : prev;
      if (upd) {
        a.next_update[s] = t_sec + (a.has_period ? a.update_period : th_now);
        a.last_update[s] = t_sec;
      }

      // progress; a completion parks in the pending buffer
      float rem = a.remaining[s];
      if (active) rem = rem - lam * dt;
      a.remaining[s] = rem;
      const bool done = active && rem <= 0.0f;
      if (done) {
        a.pend_flow[s] = sf;
        a.pend_val[s] = t_sec + tau / 2.0f - a.start[s];
      }
      const bool expire = occ && t_sec >= a.stop[s] &&
                          a.free_at[s] == kInt32Max && !done;
      if (done || expire) a.free_at[s] = t + a.hold[s] + 1;

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
}

size_t scratch_bytes(int S, int H, int nsw) {
  return sizeof(float) * (static_cast<size_t>(S) * H + 2 * S + nsw) +
         sizeof(int) * (static_cast<size_t>(S) * H + 2 * S);
}

constexpr size_t kMaxSmem = 200 * 1024;

}  // namespace

// Bytes of global scratch K4 needs at these sizes: 0 when its temporaries
// fit in shared memory.
extern "C" long long fused_tick_scratch_bytes(int S, int H, int nsw) {
  const size_t b = scratch_bytes(S, H, nsw);
  return b <= kMaxSmem ? 0 : static_cast<long long>(b);
}

extern "C" int fused_tick_block_f32(const FusedTickArgs* args, void* stream) {
  FusedTickArgs a = *args;
  const size_t bytes = scratch_bytes(a.S, a.H, a.nsw);
  a.use_smem = bytes <= kMaxSmem;
  const size_t smem = a.use_smem ? bytes : 0;
  void (*kern)(const FusedTickArgs) =
      a.law == 1 ? fused_tick_kernel<1> : fused_tick_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
