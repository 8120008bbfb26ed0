// PowerTCP control-law kernels for Hopper (sm_90a), plain C interface.
//
// Replace the Pallas kernels of src/repro/kernels/powertcp_step.py:
//   powertcp_step_f32        <- powertcp_step (_kernel), Algorithm 1
//   theta_powertcp_step_f32  <- theta_powertcp_step (_theta_kernel),
//                               Algorithm 2
// in two forms. The TPU kernels' own form (the two entry points above)
// takes telemetry that is already gathered ([F, H] q, qdot, mu, b, valid,
// plus w_old and dt_obs), as the TPU kernel does: under jax.jit, XLA fuses
// the gathers that build those inputs into a few fusions. The engines'
// form, the "observe" kernels
//   powertcp_observe_step_f32        (Algorithm 1)
//   theta_powertcp_observe_step_f32  (Algorithm 2)
// moves that boundary: in eager PyTorch each of those gathers and each
// op that finishes the window is a launch of its own (~50 a tick), so the
// kernel reads the rings and the path itself and returns the finished
// window. Per flow (or slot) it computes what core/fluid.py::_law_tick
// computes: the delayed INT observation of each hop (_observe), w_old
// from the window ring (on the slot engine the occupant's initial window
// where the ring row predates its admission), upd and dt_obs, the law,
// the window clamp, the padded engine's hold of flows not yet started,
// and next_update / last_update.
//
// Each law's arithmetic is one set of __device__ functions below, shared
// by both forms, so Algorithm 1 and Algorithm 2 are each spelled once.
//
// Design: one thread per flow (or slot) over the B*F flat rows of a batch
// (the rows are independent, so a batch changes nothing in any row's
// arithmetic). The per-hop inputs stay in the engine's [F, H] row-major
// layout (H <= 16 hops; the observe kernels unroll the hops, in registers).
// Only a row whose law updates this tick reads its observation and w_old:
// every other row keeps its law state and window before the clamp, as the
// plain version's masks select.
//
// Bound: not bytes. The observe kernels move about 150 B a flow at H = 3
// (6 KB at S = 384): far below a microsecond at 3.35 TB/s. What bounds
// them is latency: two dependent L2 round trips, first the observations
// (the ring rows depend on the path and the RTT, read in the same set of
// loads as the law config), then w_old, whose ring row depends on the
// observed RTT. Each set's loads are issued together. The rings at the
// paper's shape (hist_q, hist_out 512 x 289, hist_w 512 x 384 floats) sit
// in the 50 MB L2 many times over. At the simulator's widths the launch
// itself is the floor.
//
// Numerics: built with -fmad=false so every product is rounded before it
// is added, max/min/clip propagate NaN as torch.amax/clamp/maximum do,
// division is IEEE (no fast math), and rintf rounds half to even as
// torch.round does. With that the kernels equal their plain PyTorch
// versions bit for bit (repro_torch/kernels/ref.py for the TPU form; for
// the observe form, core/backends.py's plain observe steps: fluid's
// _observe, ref.py's law, the clamp and the update times). gmax starts at
// -3.4e38 as in the Pallas kernel; the plain version's amax differs only
// when every hop's power is below that (i.e. -inf).

#include <cuda_runtime.h>
#include <stdint.h>

// The observe kernels' arguments, field for field the wrapper's
// _ObserveArgs (kernels/powertcp_step.py); outside the anonymous namespace,
// since the extern "C" entry points take it.
// Rows are the B*F flat flows (slots) of the batch; the rings are
// [B, D, Q+1] (hist_q, hist_out) and [B, D, F] (hist_w); bw is [B, Q+1],
// scenario b's row at b * bw_stride (0: one [Q+1] row the batch shares).
// Optional pointers are null where the engine has no such field:
// prev_theta / prev_out (Algorithm 1), hist_out (Algorithm 2), started
// (the slot engine), admit_t and slot_flow (the padded engine). A law
// config leaf is read by its mode: 0 one value per scenario ([B, 1]),
// 1 one per row ([B, F]), 2 one per schedule entry ([B, N], at the
// row's slot_flow clamped to [0, N-1]).
struct ObserveArgs {
  const float* hist_q;
  const float* hist_out;
  const float* hist_w;
  const int* path;
  const int* tf_steps;
  const int* rtt_steps;
  const float* bw;
  const float* tau;
  const float* nic;
  const float* theta_now;
  const float* w;
  const float* gs_prev;
  const float* prev_theta;
  const float* next_update;
  const float* last_update;
  const uint8_t* active;
  const uint8_t* started;
  const int* admit_t;
  const int* slot_flow;
  const float* cfg_tau;
  const float* cfg_beta;
  float* w_out;
  float* gs_out;
  float* prev_out;
  float* next_out;
  float* last_out;
  int B, F, H, D, Q, N, ptr, t, tau_mode, beta_mode, has_period, bw_stride;
  float t_sec, dt, inv_dt, next_period, gamma, one_minus_gamma, w_min;
};

namespace {

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// a mod d in [0, d), as torch.remainder
__device__ __forceinline__ int imod(int a, int d) {
  if (a >= 0 && a < d) return a;
  if (a < 0 && a >= -d) return a + d;
  return ((a % d) + d) % d;
}

__device__ __forceinline__ int iclamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

constexpr int kThreads = 256;
constexpr float kGmax0 = -3.4e38f;

// -------------------------------------------------------------------------
// The laws, spelled once
// -------------------------------------------------------------------------

struct LawConsts {
  float gamma, one_minus_gamma, w_min;
};

struct Window {
  float w, gs;
};

// Algorithm 1 NORMPOWER of one hop: (qdot + mu)(q + b tau) / max(b^2 tau,
// 1); an invalid hop contributes 0, negative power (a draining queue)
// stays. The flow's power is the max over its hops from kGmax0.
__device__ __forceinline__ float alg1_hop_power(bool valid, float q,
                                                float qdot, float mu,
                                                float b, float tau) {
  const float cur = qdot + mu;
  const float volt = q + b * tau;
  const float base = pmax(b * b * tau, 1.0f);
  return valid ? cur * volt / base : 0.0f;
}

// Algorithm 2 NORMPOWER: Gamma_norm = (thetadot + 1) * theta / tau.
__device__ __forceinline__ float alg2_norm_power(float theta, float prev,
                                                 float dt_obs, float tau) {
  const float thetadot = (theta - prev) / pmax(dt_obs, 1e-12f);
  return (thetadot + 1.0f) * theta / pmax(tau, 1e-12f);
}

// Both laws after NORMPOWER: EWMA smoothing with dt clipped to tau (Alg. 1
// line 24), then UPDATEWINDOW (line 27), where the flow updates (u).
__device__ __forceinline__ Window smooth_update(float gnorm, float tau,
                                                float dt_obs, float gs_prev,
                                                float w_old, float beta,
                                                float w, bool u,
                                                const LawConsts& c) {
  const float d = pmin(pmax(dt_obs, 0.0f), tau);
  const float gs = (gs_prev * (tau - d) + gnorm * d) / pmax(tau, 1e-12f);
  const float gs_new = u ? gs : gs_prev;
  const float target = w_old / pmax(gs_new, 1e-9f) + beta;
  const float w_new = c.gamma * target + c.one_minus_gamma * w;
  return Window{u ? pmax(w_new, c.w_min) : w, gs_new};
}

// -------------------------------------------------------------------------
// The TPU kernels' form: telemetry already gathered
// -------------------------------------------------------------------------

__global__ void powertcp_step_kernel(
    const float* __restrict__ q, const float* __restrict__ qdot,
    const float* __restrict__ mu, const float* __restrict__ b,
    const uint8_t* __restrict__ valid, const float* __restrict__ tau,
    const float* __restrict__ w, const float* __restrict__ w_old,
    const float* __restrict__ gs_prev, const float* __restrict__ dt_obs,
    const uint8_t* __restrict__ upd, const float* __restrict__ beta,
    float* __restrict__ w_out, float* __restrict__ gs_out, int F, int H,
    LawConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F) return;
  const float t = tau[i];
  const long long row = static_cast<long long>(i) * H;
  float gmax = kGmax0;
  for (int h = 0; h < H; ++h)
    gmax = pmax(gmax, alg1_hop_power(valid[row + h] != 0, q[row + h],
                                     qdot[row + h], mu[row + h], b[row + h],
                                     t));
  const Window r = smooth_update(gmax, t, dt_obs[i], gs_prev[i], w_old[i],
                                 beta[i], w[i], upd[i] != 0, c);
  w_out[i] = r.w;
  gs_out[i] = r.gs;
}

__global__ void theta_powertcp_step_kernel(
    const float* __restrict__ theta, const float* __restrict__ prev_theta,
    const float* __restrict__ tau, const float* __restrict__ w,
    const float* __restrict__ w_old, const float* __restrict__ gs_prev,
    const float* __restrict__ dt_obs, const uint8_t* __restrict__ upd,
    const float* __restrict__ beta, float* __restrict__ w_out,
    float* __restrict__ gs_out, float* __restrict__ prev_out, int F,
    LawConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F) return;
  const float t = tau[i];
  const float th = theta[i];
  const float pv = prev_theta[i];
  const float dt = dt_obs[i];
  const bool u = upd[i] != 0;
  const Window r = smooth_update(alg2_norm_power(th, pv, dt, t), t, dt,
                                 gs_prev[i], w_old[i], beta[i], w[i], u, c);
  w_out[i] = r.w;
  gs_out[i] = r.gs;
  prev_out[i] = u ? th : pv;
}

// -------------------------------------------------------------------------
// The engines' form: observe + law
// -------------------------------------------------------------------------

__device__ __forceinline__ long long cfg_index(int mode, int b, long long i,
                                               int sf, int N) {
  if (mode == 0) return b;
  if (mode == 1) return i;
  return static_cast<long long>(b) * N + iclamp(sf, 0, N - 1);
}

template <int LAW, int MAXH>
__global__ void __launch_bounds__(kThreads)
    observe_step_kernel(const ObserveArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(a.B) * a.F) return;
  const int F = a.F, H = a.H, D = a.D, Q = a.Q, Q1 = a.Q + 1;
  const int b = static_cast<int>(i / F);
  const int f = static_cast<int>(i - static_cast<long long>(b) * F);
  const float w = a.w[i], nic = a.nic[i], tau = a.tau[i];
  const float th_now = a.theta_now[i];
  const float gp = a.gs_prev[i];
  const float pv = LAW == 1 ? a.prev_theta[i] : 0.0f;
  float nu = a.next_update[i], lu = a.last_update[i];
  const bool u = a.active[i] != 0 && a.t_sec >= nu;
  float wl = w, gs = gp, prev = pv;
  if (u) {
    // -- round trip 1: the path, then every hop's delayed observation and
    //    the law config, issued together
    const long long hrow = i * H;
    const int rtt = a.rtt_steps[i];
    const int sf = a.slot_flow ? a.slot_flow[i] : 0;
    int p[MAXH], oh[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      p[h] = Q;
      oh[h] = 0;
      if (h < H) {
        p[h] = a.path[hrow + h];
        oh[h] = imod(a.ptr - iclamp(rtt - a.tf_steps[hrow + h], 1, D - 2), D);
      }
    }
    const float* hq = a.hist_q + static_cast<long long>(b) * D * Q1;
    const float* ho =
        LAW == 0 ? a.hist_out + static_cast<long long>(b) * D * Q1 : nullptr;
    const float* bw = a.bw + static_cast<long long>(b) * a.bw_stride;
    float qo[MAXH], qp[MAXH], mu[MAXH], bh[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      qo[h] = qp[h] = mu[h] = 0.0f;
      bh[h] = 1.0f;
      if (h < H && p[h] < Q) {
        qo[h] = hq[oh[h] * Q1 + p[h]];
        if (LAW == 0) {
          qp[h] = hq[imod(oh[h] - 1, D) * Q1 + p[h]];
          mu[h] = ho[oh[h] * Q1 + p[h]];
        }
        bh[h] = bw[p[h]];
      }
    }
    const float ctau = a.cfg_tau[cfg_index(a.tau_mode, b, i, sf, a.N)];
    const float beta = a.cfg_beta[cfg_index(a.beta_mode, b, i, sf, a.N)];

    // -- the RTT sample rebuilt from the observation (a left-to-right
    //    chain over hops, as fluid._hop_sum), NORMPOWER for Algorithm 1
    float acc = 0.0f, gmax = kGmax0;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        const bool valid = p[h] < Q;
        const float x = valid ? qo[h] / bh[h] : 0.0f;
        acc = h ? acc + x : x;
        if (LAW == 0) {
          const float qdot = (qo[h] - qp[h]) * a.inv_dt;
          gmax = pmax(gmax,
                      alg1_hop_power(valid, qo[h], qdot, mu[h], bh[h], ctau));
        }
      }
    }
    const float theta_obs = tau + acc;
    const int wd = iclamp(static_cast<int>(rintf(theta_obs / a.dt)), 1, D - 2);

    // -- round trip 2: w_old, whose ring row depends on the observation
    float w_old = a.hist_w[(static_cast<long long>(b) * D + imod(a.ptr - wd, D))
                               * F + f];
    if (a.admit_t && !(a.t - wd >= a.admit_t[i])) w_old = nic * tau;
    const float dt_obs = pmax(a.t_sec - lu, a.dt);

    float gnorm = gmax;
    if (LAW == 1) {
      gnorm = alg2_norm_power(theta_obs, pv, dt_obs, ctau);
      prev = theta_obs;
    }
    const Window r = smooth_update(gnorm, ctau, dt_obs, gp, w_old, beta, w,
                                   true,
                                   LawConsts{a.gamma, a.one_minus_gamma,
                                             a.w_min});
    wl = r.w;
    gs = r.gs;
    nu = a.has_period ? a.next_period : a.t_sec + th_now;
    lu = a.t_sec;
  }
  // the window clamp on every row, each product rounded; a padded flow
  // that has not started holds its window
  wl = pmin(pmax(wl, a.w_min), 8.0f * nic * tau + 8.0f * nic * th_now);
  if (a.started && a.started[i] == 0) wl = w;
  a.w_out[i] = wl;
  a.gs_out[i] = gs;
  if (LAW == 1) a.prev_out[i] = prev;
  a.next_out[i] = nu;
  a.last_out[i] = lu;
}

template <int LAW>
int launch_observe(const ObserveArgs* a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a->B) * a->F;
  const int blocks = static_cast<int>((rows + kThreads - 1) / kThreads);
  if (a->H <= 4)
    observe_step_kernel<LAW, 4><<<blocks, kThreads, 0, stream>>>(*a);
  else if (a->H <= 8)
    observe_step_kernel<LAW, 8><<<blocks, kThreads, 0, stream>>>(*a);
  else if (a->H <= 16)
    observe_step_kernel<LAW, 16><<<blocks, kThreads, 0, stream>>>(*a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: the floor of a launch through this interface.
__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int powertcp_step_f32(
    const float* q, const float* qdot, const float* mu, const float* b,
    const uint8_t* valid, const float* tau, const float* w,
    const float* w_old, const float* gs_prev, const float* dt_obs,
    const uint8_t* upd, const float* beta, float* w_out, float* gs_out,
    int F, int H, float gamma, float one_minus_gamma, float w_min,
    void* stream) {
  const int blocks = (F + kThreads - 1) / kThreads;
  powertcp_step_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      q, qdot, mu, b, valid, tau, w, w_old, gs_prev, dt_obs, upd, beta,
      w_out, gs_out, F, H, LawConsts{gamma, one_minus_gamma, w_min});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int theta_powertcp_step_f32(
    const float* theta, const float* prev_theta, const float* tau,
    const float* w, const float* w_old, const float* gs_prev,
    const float* dt_obs, const uint8_t* upd, const float* beta,
    float* w_out, float* gs_out, float* prev_out, int F, float gamma,
    float one_minus_gamma, float w_min, void* stream) {
  const int blocks = (F + kThreads - 1) / kThreads;
  theta_powertcp_step_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      theta, prev_theta, tau, w, w_old, gs_prev, dt_obs, upd, beta, w_out,
      gs_out, prev_out, F, LawConsts{gamma, one_minus_gamma, w_min});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int powertcp_observe_step_f32(const ObserveArgs* a, void* stream) {
  return launch_observe<0>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int theta_powertcp_observe_step_f32(const ObserveArgs* a,
                                               void* stream) {
  return launch_observe<1>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int observe_step_abi() {
  return static_cast<int>(sizeof(ObserveArgs));
}

extern "C" int launch_floor_f32(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
