// K4: the whole-tick megakernel of the flow-slot engine, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel fused_tick_block of
// src/repro/kernels/fused_tick.py, which runs K ticks of
// src/repro/core/megakernel.py::make_tick in one pallas_call with the
// whole carry resident in VMEM, for whatever law it is given. Here the
// tick is written out by hand, with a routine for each of the 13 laws of
// repro_torch/core/laws.py, core/rdcn.py and core/feedback.py (powertcp,
// theta_powertcp, hpcc, swift, gradient_mimd, timely, dcqcn, reno, retcp,
// fncc, pulser, backpressure, pcc; the law is a
// template parameter, so each instantiation holds one law's code, and the
// source is built once per law, -DVARIANT=<law id> (kernels/_build.py),
// into a library of that law's instantiations, so that the laws compile
// in parallel), in the order of the port's plain tick
// (repro_torch/core/megakernel.py):
//   1. t_sec and the ring pointer; under a circuit schedule (the Pallas
//      kernel traces the bw_fn into its body), the tick's rate of the
//      VOQ and each queue's q / bw at that rate; under an impairment
//      regime, each queue's rate, survival fraction and jitter, and its
//      q / bw + jitter;
//   2. the gate: an arrival due and not admitted, or a freeable slot
//      (gate = 0 opens it on every tick);
//   3. on gated ticks: flush the freeable slots' pending FCTs, retire them,
//      admit due arrivals fresh-first in slot order (block-wide integer
//      prefix sums), gather the admitted slots' schedule rows, re-init
//      their law state, window and timers, and rebuild the per-queue
//      contributor lists when the cursor moved;
//   4. theta_now and the send rates, written to the rings; the delayed
//      per-hop rates (masked before admission) and the delayed queue
//      observations, read from the rings together;
//   5. per switch: its occupancy, its ports added in port order;
//   6. per queue: the in-order arrival sum from +0.0 (times the queue's
//      survival fraction under a regime), the Dynamic-
//      Thresholds cap, the integration and the packed [q | out | qdot]
//      ring row, with the law's feedback channel appended (backpressure:
//      the queue's XON/XOFF state; pulser: its count of sending hops);
//   7. on updating slots: theta_obs, the w_old delay and w_old, and the
//      law's per-hop telemetry (PowerTCP's normalized power, HPCC's and
//      FNCC's link utilization, the ECN marking of DCQCN and Reno, the
//      pause state of backpressure, pulser's sender count and fair
//      share), maxed (the share: min'd) over hops;
//   8. on updating slots: the law update and the update timers; on every
//      slot: DCQCN's rate clamp, the rate-based laws' rate cap, reTCP's
//      circuit multiplier, and the window clamp;
//   9. progress (under a regime, of the goodput: the rate times the
//      survival fractions of the slot's hops, multiplied in hop order),
//      completions into the pending buffer, free_at;
//  10. the record row, when recording, its sums w_sum and lam in the
//      plain tick's order (XLA:CPU's, core/fluid.py::_xla_sum).
//
// Bound: not bytes. One tick touches ~1 150 hop entries, 384 slots and 289
// queues at the paper's scale (a few tens of kB), but its phases depend on
// each other: rates before arrivals, queues before the observation, the
// observation before the law. What bounds a tick is that chain of
// dependent phases, the block barriers between them and its two dependent
// L2 round trips (below), all on one SM.
//
// Grid: one block per scenario. A batch of B scenarios (the batched
// engine, every carry leaf, the schedule, the law config, the due table
// and the records with a leading scenario axis; the topology shared) is
// one launch of B blocks. Each block offsets its pointers by its
// scenario's strides (a launch of one scenario takes the kernel variant
// without offsets, the code of a single-scenario kernel) and stages its
// own working set in its own shared memory; blocks share nothing (no atomics, no order between blocks), so
// each scenario's result is that of a launch of its own. At ~98 KB of
// shared memory a block, two blocks fit on an SM: up to 264 scenarios run
// at once, on B SMs instead of 1, each still bound by its own chain.
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
// Law state and config: each law's state fields and the per-flow config it
// reads (beta, tau, gamma and 1 - gamma, host_bw, TIMELY's thresholds and
// step) are slot fields, staged where the law has them (the masks smask
// and cmask) and re-initialized at admission to the law's init; the
// config is read through slot_flow (a retired slot's from flow N - 1, as
// the plain tick's clamped gather reads it). The law's scalars (HPCC's
// eta and stage limit, TIMELY's beta and HAI count, DCQCN's marking and
// timers, Reno's decrease) come per scenario in lawp.
//
// Feedback channels (core/feedback.py): whether a law reads its
// telemetry over the hop clock (tf_h ticks old, congestion-point
// feedback, instead of rtt - tf_h), carries each queue's pause state or
// counts each queue's sending hops is a property of the instantiation
// (kHop, kPause, kInc below), so a law without a channel pays nothing for
// it. The pause state (one float a queue, staged; the sentinel's stays 0)
// goes through core/fluid.py::_pause_step's hysteresis after the
// integration; the count is taken over the queue's contributor list, the
// walk of the arrival sum: a hop entry counts 1.0 where its delayed rate
// is positive. Each is written to its column of the ring, appended after
// [q | out | qdot], and the observation reads it at ptr - tb.
//
// Circuit schedule: with a schedule (a.sched, six floats per scenario, the
// fields of core/rdcn.py::ScheduleParams; a block-uniform flag, one branch
// a tick) each block classifies its tick as rdcn.circuit_up does: the
// phase (t - t0) + 1e-7 taken mod week by jnp.mod's rule on fmodf (exact),
// up on [0, day). reTCP reads its own schedule and prebuffer from lawp;
// the two need not be the same.
//
// Impairments: with a regime (a.imp, the fields of
// core/impair.py::ImpairmentParams as int32 rows [10, Q], the floats as
// their bits; one per scenario, or shared with a stride of 0; null
// without one) the launch takes the instantiation with IMP (a clean run
// holds none of this code: a runtime branch on the pointer cost clean
// PowerTCP 5% a tick at the paper's shape), and each queue's processes are
// evaluated at the start of every tick as core/impair.py evaluates them:
// the epoch floor(((t - t0) + 1e-7) / max(period, 1e-6)) converted to
// int32 as XLA converts (saturating, NaN to 0: cvt.rmi), the lowbias32
// hash in native uint32 over (seed ^ salt, queue id, epoch), its top 24
// bits the draw; all four capacity kinds computed, then selected. The
// queue's rate, survival fraction 1 - loss and jitter go to shared
// memory; q / bw + jitter is each queue's delay (exact: the jitter is
// added per queue before the hop sums, as the slot tick adds it per hop).
//
// Numerics: built with -fmad=false (no contraction) and without fast
// math, so every division is IEEE round-to-nearest; max/min propagate NaN
// as torch.maximum/clamp do; rintf rounds half to even as torch.round;
// every float constant arrives as the float32 value PyTorch rounds it to;
// a law-config divisor divides, or multiplies by its float32 reciprocal,
// as core/laws.py::div_config does; DCQCN's powf is CUDA's, as
// torch.pow's on the card; no float atomics; the record sums add in
// XLA:CPU's order. The carry and the records then equal the plain tick's
// bit for bit.

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
  // queues (the regime's survival fractions and jitter) and the read-only
  // topology
  F_Q, F_OUT_RATE, F_QB, F_BW, F_KEEP, F_JIT, F_BUF, F_PAUSE,
  F_SWITCH_OF_QUEUE,
  F_SW_TABLE, F_SWITCH_BUFFER,
  // hops
  F_PATH, F_TF_STEPS,
  // slots
  F_SLOT_FLOW, F_ADMIT_T, F_FREE_AT, F_RTT_STEPS, F_HOLD, F_PEND_FLOW,
  F_TAU, F_NIC, F_START, F_STOP, F_W, F_RATE_CAP, F_REMAINING,
  F_NEXT_UPDATE, F_LAST_UPDATE,
  // law state (kernels/fused_tick.py::STATE_FIELDS)
  F_GAMMA_SMOOTH, F_PREV_THETA, F_U, F_WC, F_INC_STAGE, F_LAST_REF, F_RATE,
  F_NEG_COUNT, F_RC, F_RT, F_ALPHA, F_T_LAST_CUT, F_T_LAST_INC, F_LAST_CUT,
  F_W_BASE, F_PEND_VAL,
  // per-flow law config (CONFIG_FIELDS)
  F_BETA, F_CTAU, F_GAMMA, F_OMG, F_HBW, F_T_LOW, F_T_HIGH, F_TADD,
  kFields
};
constexpr int kStateFields = F_W_BASE - F_GAMMA_SMOOTH + 1;
constexpr int kConfigFields = F_TADD - F_BETA + 1;

// law ids (kernels/fused_tick.py::LAW_NAMES)
enum Law {
  kPowerTCP, kThetaPowerTCP, kHPCC, kSwift, kGradient, kTimely, kDCQCN,
  kReno, kReTCP, kFNCC, kPulser, kBackpressure, kPCC
};

// the per-scenario law constants (LAW_PARAMS)
enum LawParam {
  P_HPCC_ETA, P_HPCC_INV_ETA, P_HPCC_MAX_STAGE, P_TIMELY_BETA,
  P_TIMELY_HAI_N, P_DCQCN_KMIN, P_DCQCN_SPAN, P_DCQCN_INV_SPAN,
  P_DCQCN_PMAX, P_DCQCN_G, P_DCQCN_OMG, P_DCQCN_RAI, P_DCQCN_RAI_HYPER,
  P_DCQCN_TIMER, P_DCQCN_CNP_TIMER, P_DCQCN_F, P_RENO_MD, P_RETCP_DAY,
  P_RETCP_NIGHT, P_RETCP_WEEK, P_RETCP_T0, P_RETCP_CIRCUIT_BW,
  P_RETCP_PACKET_BW, P_RETCP_PREBUFFER, P_FNCC_ETA, P_FNCC_INV_ETA,
  P_PULSER_N, P_BP_XOFF, P_BP_XON, P_BP_MD, P_PCC_EPS, P_PCC_B,
  kLawParams
};

// a bandwidth schedule's fields (kernels/fused_tick.py::SCHED_FIELDS)
enum Sched { S_DAY, S_NIGHT, S_WEEK, S_T0, S_CIRCUIT_BW, S_PACKET_BW,
             kSchedFields };

// an impairment regime's rows (core/impair.py::ImpairmentParams' fields)
enum Imp { I_KIND, I_BW_HI, I_BW_LO, I_PERIOD, I_UP, I_T0, I_LOSS,
           I_LOSS_KIND, I_JITTER, I_SEED, kImpFields };
// process and loss kinds, and the hash salts (core/impair.py)
constexpr int kKindSchedule = 1, kKindOscillate = 2, kKindFading = 3;
constexpr int kLossRandom = 1;
constexpr unsigned kSaltBw = 0x9c83a5d1u, kSaltLoss = 0x2c1b3c6du,
                   kSaltJit = 0x66e9d5a7u;

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
  void* law_state[kStateFields];  // [S] each, null where the law lacks it
  float* pause;  // [Q+1] XON/XOFF state (backpressure), else null
  float* fct;
  int* pend_flow;
  float* pend_val;
  int* hold;
  int* inv;
  uint8_t* ovf;
  // schedule (C rows from the global index win_off) and law config ([N]),
  // read only
  const int* s_path;
  const int* s_tf;
  const int* s_rtt;
  const float* s_tau;
  const float* s_nic;
  const float* s_start;
  const float* s_stop;
  const float* s_size;
  const float* law_cfg[kConfigFields];  // [N] each, null where unread
  const float* lawp;                    // [kLawParams] per scenario
  const float* sched;  // [kSchedFields] per scenario; null: static rates
  const int* imp;      // [kImpFields, Q] regime; null: none
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
  int B;           // scenarios: the grid has one block each
  int gate;        // 0: the admit/retire pass on every tick
  int due_stride;  // ints from one scenario's due row to the next
  int div_eta;     // 1: divide by hpcc_eta, 0: multiply by its reciprocal
  int div_span;    // the same for DCQCN's marking span
  int div_fncc;    // the same for fncc_eta
  int smask;       // bit i: law state field i staged
  int cmask;       // bit j: law config field j staged
  int nlawp;       // kLawParams
  int imp_stride;  // ints from one scenario's regime to the next (0: shared)
  int C;           // schedule rows per scenario (N, or a chunk window's)
  int win_off;     // global index of the first schedule row (window base)
  float dt, inv_dt, dt_alpha, update_period;
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

// Gamma_smooth's update (core/laws.py::_smooth), with dt clipped to tau.
__device__ __forceinline__ float smooth(float prev, float nw, float dt_obs,
                                        float tau) {
  const float d = pmin(pmax(dt_obs, 0.0f), tau);
  const float blend = prev * (tau - d) + nw * d;
  return blend / pmax(tau, 1e-12f);
}

// x / d for a law-config divisor: divided, or multiplied by its float32
// reciprocal (core/laws.py::div_config).
__device__ __forceinline__ float div_config(float x, float d, float inv_d,
                                            int divide) {
  return divide ? x / d : x * inv_d;
}

// Is the circuit up at t (core/rdcn.py::circuit_up)? The phase
// (t - t0) + 1e-7 mod week by jnp.mod's rule: fmodf, then + week where the
// remainder is nonzero and its sign differs from week's.
__device__ __forceinline__ bool circuit_up(float t, float day, float week,
                                           float t0) {
  float ph = fmodf((t - t0) + 1e-7f, week);
  if (ph != 0.0f && ((week < 0.0f) != (ph < 0.0f))) ph = ph + week;
  return ph >= 0.0f && ph < day;
}

// lowbias32 (core/impair.py::_mix32)
__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// a uniform draw in [0, 1) of the stream (seed ^ salt, queue qid, epoch)
__device__ __forceinline__ float u01(unsigned seed, unsigned salt,
                                     unsigned qid, unsigned epoch) {
  unsigned h = mix32(seed ^ salt);
  h = mix32(h ^ (qid * 0x9E3779B9u));
  h = mix32(h ^ epoch);
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
}

// Queue c's rate, survival fraction and jitter at t under the regime r
// ([kImpFields, Q]; core/impair.py's link_bw_at, 1 - link_loss_at and
// link_jitter_at, with queue id c).
__device__ void impair_at(const int* r, int Q, int c, float t, float* bw,
                          float* keep, float* jit) {
  const int kind = r[I_KIND * Q + c], lkind = r[I_LOSS_KIND * Q + c];
  const float hi = __int_as_float(r[I_BW_HI * Q + c]);
  const float lo = __int_as_float(r[I_BW_LO * Q + c]);
  const float period = __int_as_float(r[I_PERIOD * Q + c]);
  const float up = __int_as_float(r[I_UP * Q + c]);
  const float t0 = __int_as_float(r[I_T0 * Q + c]);
  const float loss = __int_as_float(r[I_LOSS * Q + c]);
  const float jitter = __int_as_float(r[I_JITTER * Q + c]);
  const unsigned seed = static_cast<unsigned>(r[I_SEED * Q + c]);
  const float x = (t - t0) + 1e-7f;
  // the epoch: floor, then int32 (saturating, NaN to 0), then uint32
  const unsigned e = static_cast<unsigned>(__float2int_rd(x / pmax(period,
                                                                   1e-6f)));
  const unsigned qid = static_cast<unsigned>(c);
  // every kind, then the select (an untaken one may be NaN)
  float ph = fmodf(x, period);
  if (ph != 0.0f && ((period < 0.0f) != (ph < 0.0f))) ph = ph + period;
  const float sched = (ph >= 0.0f && ph < up) ? hi : lo;
  const float frac = ph / period;
  const float tri = 1.0f - fabsf(2.0f * frac - 1.0f);
  const float osc = lo + (hi - lo) * tri;
  const float fad = lo + (hi - lo) * u01(seed, kSaltBw, qid, e);
  *bw = kind == kKindSchedule   ? sched
        : kind == kKindOscillate ? osc
        : kind == kKindFading    ? fad
                                 : hi;
  const float l = lkind == kLossRandom ? loss * u01(seed, kSaltLoss, qid, e)
                                       : loss;
  *keep = 1.0f - pmin(pmax(l, 0.0f), 0.999f);
  *jit = pmax(jitter * u01(seed, kSaltJit, qid, e), 0.0f);
}

// The sums of a[0..n) and b[0..n) in XLA:CPU's order for jnp.sum
// (core/fluid.py::_xla_sum): while more than 32 values are left, pad them
// to a multiple of 32 with pad / 2 zeros in front and sum each window of
// 32 left to right (a window's zeros add nothing); then the rest left to
// right. a and b are overwritten; thread 0 gets the sums. Called by the
// whole block.
__device__ void xla_sum2(float* a, float* b, int n, float* sa, float* sb) {
  const int tid = threadIdx.x;
  while (n > 32) {
    const int m = (n + 31) / 32 * 32, nw = m / 32;
    const int lo = 32 * tid - (m - n) / 2;
    float x = 0.0f, y = 0.0f;
    if (tid < nw) {
      const int i0 = max(lo, 0), i1 = min(lo + 32, n);
      x = a[i0];
      y = b[i0];
      for (int i = i0 + 1; i < i1; ++i) {
        x = x + a[i];
        y = y + b[i];
      }
    }
    __syncthreads();
    if (tid < nw) {
      a[tid] = x;
      b[tid] = y;
    }
    __syncthreads();
    n = nw;
  }
  if (tid == 0) {
    float x = a[0], y = b[0];
    for (int i = 1; i < n; ++i) {
      x = x + a[i];
      y = y + b[i];
    }
    *sa = x;
    *sb = y;
  }
}

// 1 + x for an int32 counter, wrapping as torch's int32 add does.
__device__ __forceinline__ int inc_wrap(int x) {
  return static_cast<int>(static_cast<unsigned>(x) + 1u);
}

// LAW: the law (enum Law), so that each instantiation holds one law's
// routines. SMEM: the working set in shared memory (else in the global
// scratch buffer). GRID: a launch of several scenarios, one block each
// (without it the pointers are used as given, and the offsets below fold
// away). IMP: an impairment regime (a.imp non-null); a clean run takes
// the instantiation without its code.
template <int LAW, bool SMEM, bool GRID, bool IMP>
__global__ void __launch_bounds__(kThreads)
fused_tick_kernel(const FusedTickArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wbuf_i[kWarps];
  __shared__ int sh_cursor, sh_hw;
  __shared__ int sh_due[kDueChunk];

  // this block's scenario: each per-scenario pointer advanced by its
  // stride (the topology is shared)
  const long long sb = GRID ? static_cast<long long>(blockIdx.x) : 0;
  const long long sS = sb * a.S, sSH = sS * a.H, sN = sb * a.N;
  const long long sC = sb * a.C, sCH = sC * a.H, sQ1 = sb * (a.Q + 1);
  const long long nrec = a.record ? a.K / a.record_every : 0;
  int* const g_cursor = a.cursor + sb;
  int* const g_hw = a.hw + sb;
  int* const g_slot_flow = a.slot_flow + sS;
  int* const g_admit_t = a.admit_t + sS;
  int* const g_free_at = a.free_at + sS;
  int* const g_path = a.path + sSH;
  int* const g_tf_steps = a.tf_steps + sSH;
  int* const g_rtt_steps = a.rtt_steps + sS;
  float* const g_tau = a.tau + sS;
  float* const g_nic = a.nic + sS;
  float* const g_start = a.start + sS;
  float* const g_stop = a.stop + sS;
  float* const g_w = a.w + sS;
  float* const g_rate_cap = a.rate_cap + sS;
  float* const g_q = a.q + sQ1;
  float* const g_out_rate = a.out_rate + sQ1;
  float* const g_hist_lam = a.hist_lam + sS * a.D;
  // the law's feedback channels and the ring's width (in Q+1 columns)
  constexpr bool kHop =
      LAW == kFNCC || LAW == kPulser || LAW == kBackpressure;
  constexpr bool kPause = LAW == kBackpressure;
  constexpr bool kInc = LAW == kPulser;
  constexpr int kChan = 3 + (kPause ? 1 : 0) + (kInc ? 1 : 0);
  float* const g_hist_q = a.hist_q + sQ1 * kChan * a.D;
  float* const g_pause = kPause ? a.pause + sQ1 : nullptr;
  float* const g_hist_w = a.hist_w + sS * a.D;
  float* const g_remaining = a.remaining + sS;
  float* const g_next_update = a.next_update + sS;
  float* const g_last_update = a.last_update + sS;
  float* const g_fct = a.fct + sN + sb;
  int* const g_pend_flow = a.pend_flow + sS;
  float* const g_pend_val = a.pend_val + sS;
  int* const g_hold = a.hold + sS;
  int* const g_inv = a.inv + sQ1 * a.maxdeg;
  uint8_t* const g_ovf = a.ovf + sb;
  const int* const g_s_path = a.s_path + sCH;
  const int* const g_s_tf = a.s_tf + sCH;
  const int* const g_s_rtt = a.s_rtt + sC;
  const float* const g_s_tau = a.s_tau + sC;
  const float* const g_s_nic = a.s_nic + sC;
  const float* const g_s_start = a.s_start + sC;
  const float* const g_s_stop = a.s_stop + sC;
  const float* const g_s_size = a.s_size + sC;
  const float* const lawp = a.lawp + sb * a.nlawp;
  const int* const g_due = a.due + sb * a.due_stride;
  float* const g_rec_t = a.rec_t + sb * nrec;
  float* const g_rec_q = a.rec_q + sb * nrec * (a.Q + 1);
  float* const g_rec_w_sum = a.rec_w_sum + sb * nrec;
  float* const g_rec_thru = a.rec_thru + sb * nrec * (a.Q + 1);
  float* const g_rec_lam = a.rec_lam + sb * nrec;
  float* const g_rec_lam_f = a.rec_lam_f + sS * nrec;
  int* const g_rec_n_active = a.rec_n_active + sb * nrec;

  const int tid = threadIdx.x;
  const int S = a.S, N = a.N, Q = a.Q, Q1 = Q + 1, H = a.H, D = a.D;
  const int SH = S * H, maxdeg = a.maxdeg;
  const float dt = a.dt;
  constexpr int law = LAW;
  const int smask = a.smask, cmask = a.cmask;

  unsigned char* base =
      SMEM ? smem_raw
           : static_cast<unsigned char*>(a.scratch) + sb * a.layout_bytes;
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
  float* keep = at<float>(base, a.off[F_KEEP]);  // [Q1] (a regime)
  float* jit = at<float>(base, a.off[F_JIT]);    // [Q1] (a regime)
  float* buf = at<float>(base, a.off[F_BUF]);
  float* pause = at<float>(base, a.off[F_PAUSE]);  // [Q1] (kPause)
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
  float* pend_val = at<float>(base, a.off[F_PEND_VAL]);
  // the law's state and per-slot config (fields it lacks take no words)
  float* gamma_smooth = at<float>(base, a.off[F_GAMMA_SMOOTH]);
  float* prev_theta = at<float>(base, a.off[F_PREV_THETA]);
  float* u_s = at<float>(base, a.off[F_U]);
  float* wc_s = at<float>(base, a.off[F_WC]);
  int* inc_stage = at<int>(base, a.off[F_INC_STAGE]);
  float* last_ref = at<float>(base, a.off[F_LAST_REF]);
  float* rate_s = at<float>(base, a.off[F_RATE]);
  int* neg_count = at<int>(base, a.off[F_NEG_COUNT]);
  float* rc_s = at<float>(base, a.off[F_RC]);
  float* rt_s = at<float>(base, a.off[F_RT]);
  float* alpha_s = at<float>(base, a.off[F_ALPHA]);
  float* t_last_cut = at<float>(base, a.off[F_T_LAST_CUT]);
  float* t_last_inc = at<float>(base, a.off[F_T_LAST_INC]);
  float* last_cut = at<float>(base, a.off[F_LAST_CUT]);
  float* w_base = at<float>(base, a.off[F_W_BASE]);
  float* betas = at<float>(base, a.off[F_BETA]);
  float* ctaus = at<float>(base, a.off[F_CTAU]);
  float* gammas = at<float>(base, a.off[F_GAMMA]);
  float* omgs = at<float>(base, a.off[F_OMG]);
  float* hbws = at<float>(base, a.off[F_HBW]);
  float* t_lows = at<float>(base, a.off[F_T_LOW]);
  float* t_highs = at<float>(base, a.off[F_T_HIGH]);
  float* tadds = at<float>(base, a.off[F_TADD]);
  // the law's scalars
  const float hpcc_eta = lawp[P_HPCC_ETA], hpcc_inv_eta = lawp[P_HPCC_INV_ETA];
  const int hpcc_max_stage = static_cast<int>(lawp[P_HPCC_MAX_STAGE]);
  const float timely_beta = lawp[P_TIMELY_BETA];
  const int timely_hai_n = static_cast<int>(lawp[P_TIMELY_HAI_N]);
  const float kmin = lawp[P_DCQCN_KMIN], span = lawp[P_DCQCN_SPAN],
              inv_span = lawp[P_DCQCN_INV_SPAN],
              mark_pmax = lawp[P_DCQCN_PMAX], dc_g = lawp[P_DCQCN_G],
              dc_omg = lawp[P_DCQCN_OMG], rai = lawp[P_DCQCN_RAI],
              rai_hyper = lawp[P_DCQCN_RAI_HYPER],
              dc_timer = lawp[P_DCQCN_TIMER],
              dc_cnp_timer = lawp[P_DCQCN_CNP_TIMER];
  const int dc_f = static_cast<int>(lawp[P_DCQCN_F]);
  const float reno_md = lawp[P_RENO_MD];
  const float rt_day = lawp[P_RETCP_DAY], rt_week = lawp[P_RETCP_WEEK],
              rt_t0 = lawp[P_RETCP_T0], rt_pre = lawp[P_RETCP_PREBUFFER];
  const float rt_ratio =
      law == kReTCP ? lawp[P_RETCP_CIRCUIT_BW] / lawp[P_RETCP_PACKET_BW]
                    : 1.0f;
  const float fncc_eta = lawp[P_FNCC_ETA],
              fncc_inv_eta = lawp[P_FNCC_INV_ETA],
              pulser_n = lawp[P_PULSER_N], bp_xoff = lawp[P_BP_XOFF],
              bp_xon = lawp[P_BP_XON], bp_md = lawp[P_BP_MD],
              pcc_eps = lawp[P_PCC_EPS], pcc_b = lawp[P_PCC_B];

  // the per-slot law config of flow g (clamped into [0, N)) into slot s
  auto load_config = [&](int s, int g) {
    for (int j = 0; j < kConfigFields; ++j)
      if ((cmask >> j) & 1)
        at<float>(base, a.off[F_BETA + j])[s] = a.law_cfg[j][sN + g];
  };

  // -- stage the carry, the topology and each slot's law config --------
  for (int s = tid; s < S; s += kThreads) {
    const int sf = g_slot_flow[s];
    const int g = min(max(sf, 0), N - 1);
    const int i0 = g_admit_t[s], i1 = g_free_at[s], i2 = g_rtt_steps[s],
              i3 = g_hold[s], i4 = g_pend_flow[s];
    const float f0 = g_tau[s], f1 = g_nic[s], f2 = g_start[s],
                f3 = g_stop[s], f4 = g_w[s], f5 = g_rate_cap[s],
                f6 = g_remaining[s], f7 = g_next_update[s],
                f8 = g_last_update[s], f10 = g_pend_val[s];
    for (int i = 0; i < kStateFields; ++i)
      if ((smask >> i) & 1)
        at<int>(base, a.off[F_GAMMA_SMOOTH + i])[s] =
            static_cast<const int*>(a.law_state[i])[sS + s];
    load_config(s, g);
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
    pend_val[s] = f10;
  }
  const int nsw_all = a.nsw * a.swdeg;
  const int nstage = max(max(SH, Q1), max(nsw_all, a.nswb));
  for (int i = tid; i < nstage; i += kThreads) {
    int p = 0, tf = 0, so = 0, st = 0;
    float qv = 0.0f, ov = 0.0f, bv = 0.0f, fv = 0.0f, sb = 0.0f;
    if (i < SH) {
      p = g_path[i];
      tf = g_tf_steps[i];
    }
    if (i < Q1) {
      qv = g_q[i];
      ov = g_out_rate[i];
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
      if (kPause) pause[i] = g_pause[i];
      if (IMP) {
        // the sentinel's identities; the queues' are set every tick
        keep[i] = 1.0f;
        jit[i] = 0.0f;
      }
    }
    if (i < Q) sw_of_q[i] = so;
    if (i < nsw_all) sw_table[i] = st;
    if (i < a.nswb) sw_buffer[i] = sb;
  }
  if (tid == 0) {
    sh_cursor = *g_cursor;
    sh_hw = *g_hw;
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
        sh_due[i] = g_due[k + i];
      __syncthreads();
    }
    const int due_t = sh_due[k % kDueChunk];
    const int cursor = sh_cursor;
    const bool rec_row = a.record && ((k + 1) % a.record_every == 0);
    const int r = (k + 1) / a.record_every - 1;

    // -- 1b. the tick's rate under a circuit schedule, and each queue's
    //    q / bw at it (theta_now reads it) ---------------------------------
    // (the schedule's address is taken here from the launch's arguments,
    // so that no register holds it across the tick: K4 is at its limit)
    if (a.sched) {
      const float* sp = a.sched + (GRID ? blockIdx.x : 0) * kSchedFields;
      const float bt = circuit_up(t_sec, sp[S_DAY], sp[S_WEEK], sp[S_T0])
                           ? sp[S_CIRCUIT_BW]
                           : sp[S_PACKET_BW];
      for (int c = tid; c < Q; c += kThreads) {
        bw[c] = bt;
        qb[c] = q[c] / bt;
      }
      __syncthreads();
    }
    // -- 1c. under an impairment regime, each queue's processes ----------
    if (IMP) {
      const int* r = a.imp + (GRID ? blockIdx.x : 0) * a.imp_stride;
      for (int c = tid; c < Q; c += kThreads) {
        float bc, kc, jc;
        impair_at(r, Q, c, t_sec, &bc, &kc, &jc);
        bw[c] = bc;
        keep[c] = kc;
        jit[c] = jc;
        qb[c] = q[c] / bc + jc;
      }
      __syncthreads();
    }
    // reTCP's circuit multiplier for this tick (up at t + prebuffer or t)
    float rt_mult = 1.0f;
    if (law == kReTCP &&
        (circuit_up(t_sec + rt_pre, rt_day, rt_week, rt_t0) ||
         circuit_up(t_sec, rt_day, rt_week, rt_t0)))
      rt_mult = rt_ratio;

    // -- 2. gate --------------------------------------------------------
    int need = 1;
    if (a.gate) {
      int local = (tid == 0 && due_t > cursor);
      for (int s = tid; s < S; s += kThreads)
        local |= (slot_flow[s] < N && t >= free_at[s]);
      need = __syncthreads_or(local);
    }

    // -- 3. admit / retire ----------------------------------------------
    if (need) {
      const int hw = sh_hw;
      int n_occ = 0, n_fresh_free = 0;
      for (int s = tid; s < S; s += kThreads) {
        int sf = slot_flow[s];
        if (sf < N && t >= free_at[s]) {
          const int pf = pend_flow[s];
          if (pf < N) {
            g_fct[pf] = pend_val[s];
            pend_flow[s] = N;
            pend_val[s] = qnan();
          }
          sf = N;
          slot_flow[s] = N;
          load_config(s, N - 1);
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
          // the law config at the global index, the schedule's rows at
          // the window's
          const int g = min(max(f, 0), N - 1);
          const int gw = min(max(f - a.win_off, 0), a.C - 1);
          slot_flow[s] = f;
          admit_t[s] = t;
          free_at[s] = kInt32Max;
          int hmax = 0;
          for (int h = 0; h < H; ++h) {
            const int p = g_s_path[gw * H + h];
            const int tf = g_s_tf[gw * H + h];
            spath[s * H + h] = p;
            tf_steps[s * H + h] = tf;
            if (p < Q) hmax = max(hmax, tf);
          }
          hold[s] = hmax;
          rtt_steps[s] = g_s_rtt[gw];
          const float tau = g_s_tau[gw], nic = g_s_nic[gw],
                      st = g_s_start[gw];
          taus[s] = tau;
          nics[s] = nic;
          start[s] = st;
          stop[s] = g_s_stop[gw];
          ws[s] = nic * tau;
          rate_cap[s] = __int_as_float(0x7f800000);
          remaining[s] = g_s_size[gw];
          next_update[s] = st + tau;
          last_update[s] = st;
          load_config(s, g);
          // the law's init, on the admitted flow's config
          const float ctau = (cmask >> (F_CTAU - F_BETA)) & 1 ? ctaus[s]
                                                               : 0.0f;
          const float hbw = (cmask >> (F_HBW - F_BETA)) & 1 ? hbws[s] : 0.0f;
          switch (law) {
            case kPowerTCP:
              gamma_smooth[s] = 1.0f;
              break;
            case kThetaPowerTCP:
              gamma_smooth[s] = 1.0f;
              prev_theta[s] = ctau * 1.0f;
              break;
            case kHPCC:
              u_s[s] = 1.0f;
              wc_s[s] = hbw * ctau * 1.0f;
              inc_stage[s] = 0;
              last_ref[s] = 0.0f;
              break;
            case kGradient:
              prev_theta[s] = ctau * 1.0f;
              break;
            case kTimely:
              rate_s[s] = hbw * 1.0f;
              prev_theta[s] = ctau * 1.0f;
              neg_count[s] = 0;
              break;
            case kDCQCN:
              rc_s[s] = hbw * 1.0f;
              rt_s[s] = hbw * 1.0f;
              alpha_s[s] = 1.0f;
              t_last_cut[s] = 0.0f;
              t_last_inc[s] = 0.0f;
              inc_stage[s] = 0;
              break;
            case kReno:
              last_cut[s] = 0.0f;
              break;
            case kReTCP:
              last_cut[s] = 0.0f;
              w_base[s] = hbw * ctau * 1.0f;
              break;
            case kFNCC:
              u_s[s] = 1.0f;
              break;
            case kBackpressure:
              last_cut[s] = 0.0f;
              break;
            case kPCC:
              rate_s[s] = hbw * 1.0f;
              break;
            default:  // kSwift, kPulser: no state
              break;
          }
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
      if (n_admit > 0 || !a.gate) {
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
      g_hist_lam[ptr * S + s] = lam;
      g_hist_w[ptr * S + s] = w;
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
          ld = g_hist_lam[imod(ptr - tf, D) * S + s];
        contrib[csr_pos[e]] = ld;
        if (upd && p < Q) {
          // the receiver echo is rtt - tf_h old, congestion-point
          // feedback tf_h
          const int tb = kHop ? tf : rtt - tf;
          const int oh = imod(ptr - iclamp(tb, 1, D - 2), D);
          const float* orow =
              g_hist_q + static_cast<long long>(oh) * kChan * Q1;
          obs[e] = orow[p];
          if (law == kPowerTCP || law == kHPCC || law == kFNCC)
            obs[SH + e] = orow[Q1 + p];
          // the feedback channel, the ring's fourth column
          if (kPause || kInc) obs[SH + e] = orow[3 * Q1 + p];
          if (law == kPowerTCP) obs[2 * SH + e] = orow[2 * Q1 + p];
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
    float* hrow = g_hist_q + static_cast<long long>(ptr) * kChan * Q1;
    for (int c = tid; c < Q1; c += kThreads) {
      // the arrivals, and (pulser) the hops sending into the queue
      float arr = 0.0f, cnt = 0.0f;
      const int hi = csr_off[c + 1];
#pragma unroll 8
      for (int j = csr_off[c]; j < hi; ++j) {
        const float x = contrib[j];
        arr = arr + x;
        if (kInc) cnt = x > 0.0f ? cnt + 1.0f : cnt;
      }
      // the loss folds into the accumulated arrivals
      if (IMP) arr = arr * keep[c];
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
      if (kPause) {
        // XON/XOFF hysteresis on the integrated level (_pause_step)
        const float pz = qn >= bp_xoff ? 1.0f
                         : (qn <= bp_xon ? 0.0f : pause[c]);
        pause[c] = pz;
        hrow[3 * Q1 + c] = pz;
      }
      if (kInc) hrow[3 * Q1 + c] = cnt;
      if (rec_row) {
        g_rec_q[r * Q1 + c] = qn;
        g_rec_thru[r * Q1 + c] = out;
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
        const float ctau = (cmask >> (F_CTAU - F_BETA)) & 1 ? ctaus[s] : 0.0f;
        // theta_obs, and the law's per-hop telemetry maxed over the hops
        // (a sentinel hop gives 0, as the plain tick's where(valid, ., 0))
        // (pulser: hmax the largest sender count, smin the tightest fair
        // rate b / max(n, 1) over hops with a sender)
        float acc = 0.0f, hmax = 0.0f, smin = __int_as_float(0x7f800000);
        for (int h = 0; h < H; ++h) {
          const int e = s * H + h;
          const int p = spath[e];
          float x = 0.0f, gh = 0.0f;
          if (p < Q) {
            const float q_obs = obs[e];
            const float b = bw[p];
            x = q_obs / b;
            if (IMP) x = x + jit[p];
            if (law == kPowerTCP) {
              // NORMPOWER: (qdot + mu)(q + b tau) * (1 / max(b^2 tau, 1))
              const float current = obs[2 * SH + e] + obs[SH + e];
              const float bdp = b * ctau;
              const float voltage = q_obs + bdp;
              const float base_ = bdp * b;
              const float power = current * voltage;
              gh = power * (1.0f / pmax(base_, 1.0f));
            } else if (law == kHPCC || law == kFNCC) {
              // the link's utilization: q / max(b tau, 1) + mu / max(b, 1)
              gh = q_obs / pmax(b * ctau, 1.0f) + obs[SH + e] / pmax(b, 1.0f);
            } else if (law == kPulser) {
              const float n = obs[SH + e];
              gh = n;
              if (n > 0.0f) smin = pmin(smin, b / pmax(n, 1.0f));
            } else if (law == kBackpressure) {
              gh = obs[SH + e];
            } else if (law == kDCQCN || law == kReno || law == kReTCP) {
              // ECN marking (core/fluid.py::_marking), a hard mark near
              // the buffer's end
              const float r = div_config(q_obs - kmin, span, inv_span,
                                         a.div_span);
              gh = q_obs >= 0.95f * buf[p]
                       ? 1.0f
                       : pmin(pmax(r, 0.0f), 1.0f) * mark_pmax;
            }
          }
          acc = h ? acc + x : x;
          hmax = h ? pmax(hmax, gh) : gh;
        }
        const float theta_obs = tau + acc;
        const int wd =
            iclamp(static_cast<int>(rintf(theta_obs / dt)), 1, D - 2);
        float w_old = g_hist_w[imod(ptr - wd, D) * S + s];
        if (!(t - wd >= admit_t[s])) w_old = nic * tau;
        const float dt_obs = pmax(t_sec - last_update[s], dt);

        switch (law) {
          case kPowerTCP:
          case kThetaPowerTCP: {
            // smoothing of the normalized power, then UPDATEWINDOW
            float gnorm = hmax;
            if (law == kThetaPowerTCP) {
              const float prev = prev_theta[s];
              const float thetadot =
                  (theta_obs - prev) / pmax(dt_obs, 1e-12f);
              gnorm = (thetadot + 1.0f) * theta_obs / pmax(ctau, 1e-12f);
              prev_theta[s] = theta_obs;
            }
            const float gs = smooth(gamma_smooth[s], gnorm, dt_obs, ctau);
            const float target = w_old / pmax(gs, 1e-9f) + betas[s];
            wl = pmax(gammas[s] * target + omgs[s] * w, 1000.0f);
            gamma_smooth[s] = gs;
            break;
          }
          case kHPCC: {
            // against the once-per-RTT reference window wc
            const float u = smooth(u_s[s], hmax, dt_obs, ctau);
            const int stage = inc_stage[s];
            const bool over = u >= hpcc_eta || stage >= hpcc_max_stage;
            const float wc = wc_s[s], beta = betas[s];
            const float w_mimd =
                wc / pmax(div_config(u, hpcc_eta, hpcc_inv_eta, a.div_eta),
                          1e-6f) +
                beta;
            wl = pmax(over ? w_mimd : wc + beta, 1000.0f);
            if (t_sec - last_ref[s] >= theta_obs) {
              wc_s[s] = wl;
              inc_stage[s] = over ? 0 : inc_wrap(stage);
              last_ref[s] = t_sec;
            }
            u_s[s] = u;
            break;
          }
          case kSwift: {
            const float f = pmax(theta_obs, 1e-12f);
            const float target = w_old * ctau / f + betas[s];
            wl = pmax(gammas[s] * target + omgs[s] * w, 1000.0f);
            break;
          }
          case kGradient: {
            const float thetadot =
                (theta_obs - prev_theta[s]) / pmax(dt_obs, 1e-12f);
            const float f = pmax(thetadot + 1.0f, 1e-2f);
            const float target = w_old / f + betas[s];
            wl = pmax(gammas[s] * target + omgs[s] * w, 1000.0f);
            prev_theta[s] = theta_obs;
            break;
          }
          case kTimely: {
            const float t_low = t_lows[s], t_high = t_highs[s],
                        add = tadds[s], hb = hbws[s];
            const float grad = (theta_obs - prev_theta[s]) /
                               pmax(ctau, 1e-12f);
            const int neg = grad <= 0.0f ? inc_wrap(neg_count[s]) : 0;
            const float r = rate_s[s];
            const float step =
                neg >= timely_hai_n ? static_cast<float>(timely_hai_n) * add
                                    : add;
            const float r_inc = r + step;
            const float r_high =
                r * (1.0f - timely_beta *
                                (1.0f - t_high / pmax(theta_obs, 1e-12f)));
            const float r_pos = r * pmax(1.0f - timely_beta * grad, 0.5f);
            const float r_mid = grad <= 0.0f ? r_inc : r_pos;
            float r_new = theta_obs < t_low
                              ? r_inc
                              : (theta_obs > t_high ? r_high : r_mid);
            r_new = pmin(pmax(r_new, 0.001f * hb), hb);
            rate_s[s] = r_new;
            wl = pmax(r_new * theta_obs, 1000.0f);
            prev_theta[s] = theta_obs;
            neg_count[s] = neg;
            break;
          }
          case kDCQCN: {
            // cut on marks (at most once per CNP interval), else increase
            // on the timer; the rate clamp below runs on every slot
            const float rc0 = rc_s[s];
            const float pkts = pmax((rc0 * dt_obs) * 0.001f, 1.0f);
            const float pe =
                1.0f - powf(pmin(pmax(1.0f - hmax, 0.0f), 1.0f), pkts);
            const bool cut = pe > 0.01f && t_sec - t_last_cut[s] >= dc_cnp_timer;
            float alpha = alpha_s[s], rt = rt_s[s], rc = rc0;
            int stage = inc_stage[s];
            if (cut) {
              alpha = dc_g * pe + dc_omg * alpha;
              rt = rc0;
              rc = rc0 * (1.0f - 0.5f * alpha * pmin(pe, 1.0f));
              t_last_cut[s] = t_sec;
              stage = 0;
            } else if (t_sec - t_last_inc[s] >= dc_timer) {
              const float rt_inc = stage < dc_f ? rt
                                   : rt + (stage >= 2 * dc_f ? rai_hyper
                                                              : rai);
              rc = 0.5f * (rc + rt_inc);
              rt = rt_inc;
              stage = inc_wrap(stage);
              t_last_inc[s] = t_sec;
              alpha = dc_omg * alpha;
            }
            const float hb = hbws[s];
            rc = pmin(pmax(rc, 0.001f * hb), hb);
            rc_s[s] = rc;
            rt_s[s] = rt;
            alpha_s[s] = alpha;
            inc_stage[s] = stage;
            rate_cap[s] = rc;
            wl = pmax(rc * pmax(theta_obs, ctau), 1000.0f);
            break;
          }
          case kReno: {
            const bool can_cut = hmax >= 1.0f && t_sec - last_cut[s] > theta_obs;
            wl = pmax(can_cut ? w * reno_md : w + 1000.0f, 1000.0f);
            if (can_cut) last_cut[s] = t_sec;
            break;
          }
          case kReTCP: {
            // NewReno on the base window
            const float wb = w_base[s];
            const bool can_cut = hmax >= 1.0f && t_sec - last_cut[s] > theta_obs;
            w_base[s] = pmax(can_cut ? wb * reno_md : wb + 1000.0f, 1000.0f);
            if (can_cut) last_cut[s] = t_sec;
            break;
          }
          case kFNCC: {
            // the direct fixed point w_old / (u / eta) + beta, smoothed
            const float u = smooth(u_s[s], hmax, dt_obs, ctau);
            const float target =
                w_old /
                    pmax(div_config(u, fncc_eta, fncc_inv_eta, a.div_fncc),
                         1e-6f) +
                betas[s];
            wl = pmax(gammas[s] * target + omgs[s] * w, 1000.0f);
            u_s[s] = u;
            break;
          }
          case kPulser: {
            // a hop at pulser_n senders or more: down to the fair share
            const float w_fair = pmax(smin * ctau, 1000.0f);
            const float w_new =
                hmax >= pulser_n ? pmin(w, w_fair) : w + betas[s];
            wl = pmax(w_new, 1000.0f);
            break;
          }
          case kBackpressure: {
            // a paused hop: cut at most once per RTT; else add beta
            const bool paused = hmax > 0.5f;
            const bool can_cut = paused && t_sec - last_cut[s] > theta_obs;
            const float w_new =
                can_cut ? w * bp_md : (paused ? w : w + betas[s]);
            wl = pmax(w_new, 1000.0f);
            if (can_cut) last_cut[s] = t_sec;
            break;
          }
          case kPCC: {
            // five probe rates scored; the first best wins (a NaN score
            // beats every number, as jnp.argmax takes it)
            const float hb = hbws[s];
            const float excess =
                pmax(theta_obs - ctau, 0.0f) / pmax(ctau, 1e-12f);
            const float penalty = pcc_b / pmax(hb, 1.0f);
            const float r0 = rate_s[s];
            float best_r = 0.0f, best_s = 0.0f;
#pragma unroll
            for (int j = 0; j < 5; ++j) {
              const float m = 1.0f + pcc_eps * static_cast<float>(j - 2);
              const float r = r0 * m;
              const float waste = hb / pmax(r, 1.0f);
              const float cost = (excess * r) * penalty;
              const float sc = -waste - cost;
              if (j == 0 || sc > best_s || (sc != sc && best_s == best_s)) {
                best_r = r;
                best_s = sc;
              }
            }
            const float r_new = pmin(pmax(best_r, 0.001f * hb), hb);
            rate_s[s] = r_new;
            wl = pmax(r_new * theta_obs, 1000.0f);
            break;
          }
        }
        next_update[s] = t_sec + (a.has_period ? a.update_period : th_now);
        last_update[s] = t_sec;
      }
      // the rate-based laws' rate is the rate cap on every slot; DCQCN
      // clamps it to [0.001, 1] x host_bw on every slot (an identity on
      // in-range rates)
      if (law == kTimely || law == kPCC) rate_cap[s] = rate_s[s];
      if (law == kDCQCN && !upd) {
        const float hb = hbws[s];
        const float rc = pmin(pmax(rc_s[s], 0.001f * hb), hb);
        rc_s[s] = rc;
        rate_cap[s] = rc;
      }
      // reTCP on every slot: NewReno's floor on the base window, then the
      // circuit multiplier on the output window
      if (law == kReTCP) {
        const float wb = pmax(w_base[s], 1000.0f);
        w_base[s] = wb;
        wl = wb * rt_mult;
      }
      wl = pmin(pmax(wl, 1000.0f), 8.0f * nic * tau + 8.0f * nic * th_now);
      ws[s] = wl;

      // progress (of the goodput under a regime: the rate times the
      // survival fractions of the slot's hops, in hop order); a
      // completion parks in the pending buffer
      float rem = remaining[s];
      if (active) {
        float good = lam;
        if (IMP) {
          float hk = 1.0f;
          for (int h = 0; h < H; ++h) {
            const int p = spath[s * H + h];
            const float kh = p < Q ? keep[p] : 1.0f;
            hk = h ? hk * kh : kh;
          }
          good = lam * hk;
        }
        rem = rem - good * dt;
      }
      remaining[s] = rem;
      const bool done = active && rem <= 0.0f;
      if (done) {
        pend_flow[s] = sf;
        pend_val[s] = t_sec + tau / 2.0f - start[s];
      }
      const bool expire = occ && t_sec >= stop[s] &&
                          free_at[s] == kInt32Max && !done;
      if (done || expire) free_at[s] = t + hold[s] + 1;

      if (rec_row) {
        g_rec_lam_f[r * S + s] = lam;
        // the record sums' terms: the active slots' windows (in the slot's
        // theta_now cell, read above) and the rates (lam_s)
        theta_now[s] = active ? wl : 0.0f;
      }
      n_act += active;
    }

    // -- 10. record row ---------------------------------------------------
    if (rec_row) {
      __syncthreads();
      xla_sum2(theta_now, lam_s, S, &w_sum, &lam_sum);
      n_act = block_sum_int(n_act, wbuf_i);
      if (tid == 0) {
        g_rec_t[r] = t_sec;
        g_rec_w_sum[r] = w_sum;
        g_rec_lam[r] = lam_sum;
        g_rec_n_active[r] = n_act;
      }
    }
    __syncthreads();
  }

  // -- write the carry back ----------------------------------------------
  for (int s = tid; s < S; s += kThreads) {
    g_slot_flow[s] = slot_flow[s];
    g_admit_t[s] = admit_t[s];
    g_free_at[s] = free_at[s];
    g_rtt_steps[s] = rtt_steps[s];
    g_hold[s] = hold[s];
    g_pend_flow[s] = pend_flow[s];
    g_tau[s] = taus[s];
    g_nic[s] = nics[s];
    g_start[s] = start[s];
    g_stop[s] = stop[s];
    g_w[s] = ws[s];
    g_rate_cap[s] = rate_cap[s];
    g_remaining[s] = remaining[s];
    g_next_update[s] = next_update[s];
    g_last_update[s] = last_update[s];
    g_pend_val[s] = pend_val[s];
    for (int i = 0; i < kStateFields; ++i)
      if ((smask >> i) & 1)
        static_cast<int*>(a.law_state[i])[sS + s] =
            at<int>(base, a.off[F_GAMMA_SMOOTH + i])[s];
  }
  for (int i = tid; i < SH; i += kThreads) {
    g_path[i] = spath[i];
    g_tf_steps[i] = tf_steps[i];
  }
  for (int c = tid; c < Q1; c += kThreads) {
    g_q[c] = q[c];
    g_out_rate[c] = out_rate[c];
    if (kPause) g_pause[c] = pause[c];
  }
  if (rebuilt) {
    // the carry's gather table, as build_csr_gather builds it: each real
    // queue's first maxdeg contributors, padded with the sentinel SH
    for (int i = tid; i < Q1 * maxdeg; i += kThreads) {
      const int c = i / maxdeg, j = i - c * maxdeg;
      const int lo = csr_off[c];
      g_inv[i] = j < csr_off[c + 1] - lo ? csr_list[lo + j] : SH;
    }
    if (tid == 0) *g_ovf = static_cast<uint8_t>(ovf);
  }
  if (tid == 0) {
    *g_cursor = sh_cursor;
    *g_hw = sh_hw;
  }
}

template <int LAW, bool GRID, bool IMP>
int launch(const FusedTickArgs& a, cudaStream_t stream) {
  if (a.use_smem) {
    void (*kern)(const FusedTickArgs) =
        fused_tick_kernel<LAW, true, GRID, IMP>;
    const size_t smem = static_cast<size_t>(a.layout_bytes);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<a.B, kThreads, smem, stream>>>(a);
  } else {
    fused_tick_kernel<LAW, false, GRID, IMP><<<a.B, kThreads, 0, stream>>>(
        a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int LAW, bool IMP>
int launch_grid(const FusedTickArgs& a, cudaStream_t stream) {
  return a.B > 1 ? launch<LAW, true, IMP>(a, stream)
                 : launch<LAW, false, IMP>(a, stream);
}

template <int LAW>
int launch_law(const FusedTickArgs& a, cudaStream_t stream) {
  return a.imp ? launch_grid<LAW, true>(a, stream)
               : launch_grid<LAW, false>(a, stream);
}

}  // namespace

// One launch of K ticks for B scenarios. The wrapper fills the layout
// offsets (and, when the layout is not in shared memory, a global scratch
// buffer of B * layout_bytes) from kernels/fused_tick.py::layout.
// This library's law (enum Law): the build passes -DVARIANT=<law id>.
#ifndef VARIANT
#error "build fused_tick.cu with -DVARIANT=<law id> (kernels/_build.py)"
#endif
static_assert(VARIANT >= kPowerTCP && VARIANT <= kPCC, "unknown law id");

extern "C" int fused_tick_block_f32(const FusedTickArgs* args, void* stream) {
  if (args->nlawp != kLawParams || args->law != VARIANT)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_law<VARIANT>(*args, static_cast<cudaStream_t>(stream));
}

namespace {

__global__ void powf_kernel(const float* x, const float* y, float* out,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = powf(x[i], y[i]);
}

}  // namespace

// out[i] = powf(x[i], y[i]) compiled with K4's flags: DCQCN's pow in K4,
// which chip_smoke.py holds against torch.pow on the card.
extern "C" int fused_tick_powf(const float* x, const float* y, float* out,
                               int n, void* stream) {
  if (n > 0)
    powf_kernel<<<(n + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, y, out, n);
  return static_cast<int>(cudaGetLastError());
}

namespace {

__global__ void schedule_kernel(const float* sched, const float* pre,
                                float* bw, uint8_t* on, int B, int t0, int T,
                                float dt) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * T) return;
  const int b = static_cast<int>(i / T), k = static_cast<int>(i - b * T);
  const float* sp = sched + b * kSchedFields;
  const float t_sec = static_cast<float>(t0 + k) * dt;
  bw[i] = circuit_up(t_sec, sp[S_DAY], sp[S_WEEK], sp[S_T0])
              ? sp[S_CIRCUIT_BW]
              : sp[S_PACKET_BW];
  on[i] = circuit_up(t_sec + pre[b], sp[S_DAY], sp[S_WEEK], sp[S_T0]) ||
          circuit_up(t_sec, sp[S_DAY], sp[S_WEEK], sp[S_T0]);
}

}  // namespace

// K4's schedule evaluation alone, over ticks t0 .. t0 + T - 1 of B
// schedules [B, kSchedFields]: the VOQ's rate [B, T] and reTCP's scaling
// flag [B, T] (prebuffer pre[b]); chip_smoke.py holds it against
// core/rdcn.py on the card.
extern "C" int fused_tick_schedule(const float* sched, const float* pre,
                                   float* bw, uint8_t* on, int B, int t0,
                                   int T, float dt, void* stream) {
  const long long n = static_cast<long long>(B) * T;
  if (n > 0)
    schedule_kernel<<<static_cast<int>((n + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(sched, pre, bw, on,
                                                           B, t0, T, dt);
  return static_cast<int>(cudaGetLastError());
}

namespace {

__global__ void impair_kernel(const int* imp, int stride, int B, int Q,
                              int t0, int T, float dt, float* bw,
                              float* keep, float* jit) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * T * Q) return;
  const int c = static_cast<int>(i % Q);
  const long long bk = i / Q;
  const int b = static_cast<int>(bk / T), k = static_cast<int>(bk % T);
  const float t_sec = static_cast<float>(t0 + k) * dt;
  impair_at(imp + static_cast<long long>(b) * stride, Q, c, t_sec, bw + i,
            keep + i, jit + i);
}

}  // namespace

// K4's evaluation of an impairment regime alone, over ticks t0 .. t0 + T
// - 1 of B scenarios (imp [kImpFields, Q] per scenario, stride ints
// apart; 0: shared): each queue's rate, survival fraction and jitter
// [B, T, Q]; chip_smoke.py holds it against core/impair.py on the card.
extern "C" int fused_tick_impair(const int* imp, int stride, int B, int Q,
                                 int t0, int T, float dt, float* bw,
                                 float* keep, float* jit, void* stream) {
  const long long n = static_cast<long long>(B) * T * Q;
  if (n > 0)
    impair_kernel<<<static_cast<int>((n + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        imp, stride, B, Q, t0, T, dt, bw, keep, jit);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(FusedTickArgs) and kFields, which the wrapper checks against its
// own struct before the first launch.
extern "C" int fused_tick_abi(int* fields) {
  *fields = kFields;
  return static_cast<int>(sizeof(FusedTickArgs));
}
