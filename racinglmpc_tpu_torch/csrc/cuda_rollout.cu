// Kernel B3: batched plant rollout, one control period of explicit-Euler
// substeps on the dual-frame Pacejka bicycle.
//
// Replaces racinglmpc_tpu/ops/pallas_rollout.py::_kernel. Semantics are
// those of racinglmpc_tpu/models/dynamics.py::_substep (slip angles by
// atan2f, Pacejka forces by atanf, curvature by a searchsorted-style
// segment lookup after the s-wrap, den clamped to +-0.05); the noise is
// added outside the kernel.
//
// Bound on this card: per scenario 12 floats in, 12 out, and ~100 substeps
// x ~60 flops incl. 6 transcendentals, so the kernel is bound by the
// special-function and FMA throughput of the SMs, not by memory: at batch
// 256 it is one partly filled wave of threads. The design keeps the whole
// state in registers for all substeps (one thread per scenario, no shared
// memory, no synchronization) and reads the vehicle scalars and the segment
// table from the kernel's parameter space.
#include <cuda_runtime.h>
#include <math.h>

#define RL_MAX_SEG 16

struct RolloutParams {
  float m, lf, lr, Iz, Df, Cf, Bf, Dr, Cr, Br;
  float dT;
  float L;
  int substeps;
  int nseg;
  float s0[RL_MAX_SEG];
  float curv[RL_MAX_SEG];
};

__global__ void rollout_kernel(const RolloutParams p,
                               const float* __restrict__ x,
                               const float* __restrict__ xg,
                               const float* __restrict__ u,
                               float* __restrict__ ox,
                               float* __restrict__ oxg, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float vx = x[b * 6 + 0], vy = x[b * 6 + 1], wz = x[b * 6 + 2];
  float epsi = x[b * 6 + 3], s = x[b * 6 + 4], ey = x[b * 6 + 5];
  float psi = xg[b * 6 + 3], X = xg[b * 6 + 4], Y = xg[b * 6 + 5];
  const float delta = u[b * 2 + 0], a = u[b * 2 + 1];
  const float sd = sinf(delta), cd = cosf(delta);
  const float dT = p.dT;

  for (int k = 0; k < p.substeps; ++k) {
    const float alpha_f = delta - atan2f(vy + p.lf * wz, vx);
    const float alpha_r = -atan2f(vy - p.lr * wz, vx);
    const float fyf = p.Df * sinf(p.Cf * atanf(p.Bf * alpha_f));
    const float fyr = p.Dr * sinf(p.Cr * atanf(p.Br * alpha_r));
    const float dvx = a - fyf * sd / p.m + wz * vy;
    const float dvy = (fyf * cd + fyr) / p.m - wz * vx;
    const float dwz = (p.lf * fyf * cd - p.lr * fyr) / p.Iz;

    // curvature: s-wrap for s > L, then searchsorted(s0, s, right) - 1
    const float sw = s > p.L ? s - p.L * floorf(s / p.L) : s;
    int idx = -1;
    for (int i = 0; i < p.nseg; ++i) idx += (p.s0[i] <= sw) ? 1 : 0;
    idx = idx < 0 ? 0 : (idx > p.nseg - 1 ? p.nseg - 1 : idx);
    const float cur = p.curv[idx];

    float den = 1.0f - cur * ey;
    den = den >= 0.0f ? fmaxf(den, 0.05f) : fminf(den, -0.05f);
    const float ce = cosf(epsi), se = sinf(epsi);
    const float s_dot = (vx * ce - vy * se) / den;
    const float depsi = wz - s_dot * cur;
    const float dey = vx * se + vy * ce;
    const float cp = cosf(psi), sp = sinf(psi);

    const float vxn = vx + dT * dvx, vyn = vy + dT * dvy, wzn = wz + dT * dwz;
    epsi = epsi + dT * depsi;
    s = s + dT * s_dot;
    ey = ey + dT * dey;
    X = X + dT * (vx * cp - vy * sp);
    Y = Y + dT * (vx * sp + vy * cp);
    psi = psi + dT * wz;
    vx = vxn;
    vy = vyn;
    wz = wzn;
  }
  ox[b * 6 + 0] = vx;  ox[b * 6 + 1] = vy;  ox[b * 6 + 2] = wz;
  ox[b * 6 + 3] = epsi; ox[b * 6 + 4] = s;  ox[b * 6 + 5] = ey;
  oxg[b * 6 + 0] = vx; oxg[b * 6 + 1] = vy; oxg[b * 6 + 2] = wz;
  oxg[b * 6 + 3] = psi; oxg[b * 6 + 4] = X; oxg[b * 6 + 5] = Y;
}

extern "C" int rl_rollout(RolloutParams p, const float* x, const float* xg,
                          const float* u, float* ox, float* oxg, int B,
                          void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  rollout_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, x, xg, u, ox, oxg, B);
  return static_cast<int>(cudaGetLastError());
}
