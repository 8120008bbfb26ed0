// PowerTCP control-law kernels for Hopper (sm_90a), plain C interface.
//
// Replace the Pallas kernels of src/repro/kernels/powertcp_step.py:
//   powertcp_step_f32        <- powertcp_step (_kernel), Algorithm 1
//   theta_powertcp_step_f32  <- theta_powertcp_step (_theta_kernel),
//                               Algorithm 2
//
// Design: one thread per flow. The per-hop inputs stay in the engine's
// [F, H] row-major layout (H <= 5 hops), so the TPU kernel's [H, F]
// transpose and tile padding go away; each thread walks its row's hops.
// The work is a few dozen flops per flow over ~13 words of input, so the
// kernel is bound by bytes (and, at the simulator's F of a few thousand,
// by the launch itself), not by arithmetic.
//
// Numerics: built with -fmad=false so every product is rounded before it
// is added, and max/min/clip propagate NaN as jnp.maximum/minimum and
// torch.amax/clamp do. With that the kernels equal their plain PyTorch
// versions (repro_torch/kernels/ref.py) bit for bit. gmax starts at
// -3.4e38 as in the Pallas kernel; the plain version's amax differs only
// when every hop's power is below that (i.e. -inf).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

constexpr int kThreads = 256;

__global__ void powertcp_step_kernel(
    const float* __restrict__ q, const float* __restrict__ qdot,
    const float* __restrict__ mu, const float* __restrict__ b,
    const uint8_t* __restrict__ valid, const float* __restrict__ tau,
    const float* __restrict__ w, const float* __restrict__ w_old,
    const float* __restrict__ gs_prev, const float* __restrict__ dt_obs,
    const uint8_t* __restrict__ upd, const float* __restrict__ beta,
    float* __restrict__ w_out, float* __restrict__ gs_out, int F, int H,
    float gamma, float one_minus_gamma, float w_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F) return;
  const float t = tau[i];
  const long long row = static_cast<long long>(i) * H;
  // NORMPOWER: max over hops of (qdot + mu)(q + b tau) / max(b^2 tau, 1);
  // invalid hops contribute 0, negative power (a draining queue) stays.
  float gmax = -3.4e38f;
  for (int h = 0; h < H; ++h) {
    const float bh = b[row + h];
    const float cur = qdot[row + h] + mu[row + h];
    const float volt = q[row + h] + bh * t;
    const float base = pmax(bh * bh * t, 1.0f);
    const float g = valid[row + h] ? cur * volt / base : 0.0f;
    gmax = pmax(gmax, g);
  }
  // EWMA smoothing with dt clipped to tau, then UPDATEWINDOW.
  const float d = pmin(pmax(dt_obs[i], 0.0f), t);
  const float gp = gs_prev[i];
  const float gs = (gp * (t - d) + gmax * d) / pmax(t, 1e-12f);
  const bool u = upd[i] != 0;
  const float gs_new = u ? gs : gp;
  const float target = w_old[i] / pmax(gs_new, 1e-9f) + beta[i];
  const float wi = w[i];
  const float w_new = gamma * target + one_minus_gamma * wi;
  w_out[i] = u ? pmax(w_new, w_min) : wi;
  gs_out[i] = gs_new;
}

__global__ void theta_powertcp_step_kernel(
    const float* __restrict__ theta, const float* __restrict__ prev_theta,
    const float* __restrict__ tau, const float* __restrict__ w,
    const float* __restrict__ w_old, const float* __restrict__ gs_prev,
    const float* __restrict__ dt_obs, const uint8_t* __restrict__ upd,
    const float* __restrict__ beta, float* __restrict__ w_out,
    float* __restrict__ gs_out, float* __restrict__ prev_out, int F,
    float gamma, float one_minus_gamma, float w_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F) return;
  const float t = tau[i];
  const float th = theta[i];
  const float pv = prev_theta[i];
  const float dt = dt_obs[i];
  // Algorithm 2 NORMPOWER: Gamma_norm = (thetadot + 1) * theta / tau.
  const float thetadot = (th - pv) / pmax(dt, 1e-12f);
  const float gnorm = (thetadot + 1.0f) * th / pmax(t, 1e-12f);
  const float d = pmin(pmax(dt, 0.0f), t);
  const float gp = gs_prev[i];
  const float gs = (gp * (t - d) + gnorm * d) / pmax(t, 1e-12f);
  const bool u = upd[i] != 0;
  const float gs_new = u ? gs : gp;
  const float target = w_old[i] / pmax(gs_new, 1e-9f) + beta[i];
  const float wi = w[i];
  const float w_new = gamma * target + one_minus_gamma * wi;
  w_out[i] = u ? pmax(w_new, w_min) : wi;
  gs_out[i] = gs_new;
  prev_out[i] = u ? th : pv;
}

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
      w_out, gs_out, F, H, gamma, one_minus_gamma, w_min);
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
      gs_out, prev_out, F, gamma, one_minus_gamma, w_min);
  return static_cast<int>(cudaGetLastError());
}
