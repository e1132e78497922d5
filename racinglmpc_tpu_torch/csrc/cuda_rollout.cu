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
// x ~60 flops incl. 10 transcendental calls, so neither bytes nor
// operations bound it: each scenario is a chain of dependent substeps, and
// the time is the length of that chain (at batch 256 a few warps cover the
// whole batch, one warp to a scheduler, and more SMs do not shorten it).
// Every libm call and IEEE division ends in a slow-path branch, which
// splits the substep into basic blocks that run one after another, so the
// chain is the sum of the calls' latencies, not the longest path.
//
// The design shortens that chain without changing one bit of the result:
// - four lanes per scenario, in lockstep, run the same calls on different
//   arguments. Lane 0 takes the front tire, lane 1 the rear (atan2f, atanf,
//   sinf); lanes 2 and 3 put epsi and psi through the same sinf and cosf.
//   So a substep runs atan2f, atanf, sinf, cosf once where one thread ran
//   them ten times. The four divisions (dvx, dvy by m, dwz by Iz, s_dot
//   by den) run as one, a lane each. Shuffles inside the group of four
//   hand the results round; every lane then holds the whole state and
//   runs the rest of the substep, so every value is computed by exactly
//   the expression of the one-thread kernel it replaces. Where such an
//   expression is a sum of two products (vx ce - vy se, vx se + vy ce and
//   psi's pair), the compiler may fuse either product into an FMA, and it
//   chose differently once sin and cos arrive by shuffle; those four are
//   written out with the one-thread kernel's choice (its SASS: the first
//   product fused in a difference, the second in a sum);
// - the segment index is carried across substeps: the table is scanned
//   again only when s leaves [s0[idx], s0[idx+1]) (or wraps), which gives
//   the full scan's index; the s-wrap division runs only when s > L;
// - the table sits in shared memory and the vehicle scalars in registers.
// The 32-byte stack frame ptxas reports belongs to the Payne-Hanek
// reduction inside sinf/cosf, run only for |x| > 105615.
#include <cuda_runtime.h>
#include <math.h>

#include "rl_phases.cuh"

#define RL_MAX_SEG 16
#define RL_LANES 4      // lanes per scenario
#define RL_THREADS 64   // 16 scenarios per CTA
#define FULL 0xffffffffu

// per-substep phases of scenario 0 (-DRL_PHASES)
enum { RP_TIRE, RP_CURV, RP_KIN, RP_N };
RL_PHASE_DECL(rl_rollout_phase, RP_N)

struct RolloutParams {
  float m, lf, lr, Iz, Df, Cf, Bf, Dr, Cr, Br;
  float dT;
  float L;
  int substeps;
  int nseg;
  float s0[RL_MAX_SEG];
  float curv[RL_MAX_SEG];
};

// value of lane k of this lane's group of four
static __device__ __forceinline__ float from(float v, int k) {
  return __shfl_sync(FULL, v, k, RL_LANES);
}

__global__ void __launch_bounds__(RL_THREADS)
rollout_kernel(const RolloutParams p, const float* __restrict__ x,
               const float* __restrict__ xg, const float* __restrict__ u,
               float* __restrict__ ox, float* __restrict__ oxg, int B) {
  __shared__ float ts0[RL_MAX_SEG], tcv[RL_MAX_SEG];
  if (threadIdx.x < RL_MAX_SEG) {
    ts0[threadIdx.x] = p.s0[threadIdx.x];
    tcv[threadIdx.x] = p.curv[threadIdx.x];
  }
  __syncthreads();
  const int g = blockIdx.x * RL_THREADS + threadIdx.x;
  const int j = threadIdx.x & (RL_LANES - 1);
  const bool live = g / RL_LANES < B;
  const int b = live ? g / RL_LANES : B - 1;  // the tail's lanes still shuffle
  const float m = p.m, lf = p.lf, lr = p.lr, Iz = p.Iz, L = p.L, dT = p.dT;
  const int nseg = p.nseg;
  // this lane's tire (lanes 2, 3 run the same calls on their angles)
  const float Bt = j == 1 ? p.Br : p.Bf, Ct = j == 1 ? p.Cr : p.Cf;
  const float Dt = j == 1 ? p.Dr : p.Df;

  float vx = x[b * 6 + 0], vy = x[b * 6 + 1], wz = x[b * 6 + 2];
  float epsi = x[b * 6 + 3], s = x[b * 6 + 4], ey = x[b * 6 + 5];
  float psi = xg[b * 6 + 3], X = xg[b * 6 + 4], Y = xg[b * 6 + 5];
  const float delta = u[b * 2 + 0], a = u[b * 2 + 1];
  const float sd = sinf(delta), cd = cosf(delta);
  float lo = INFINITY, hi = -INFINITY, cur = 0.0f;   // first substep scans
  RL_PHASE_START(g == 0)

#pragma unroll 1
  for (int k = 0; k < p.substeps; ++k) {
    // curvature: s-wrap for s > L, then searchsorted(s0, s, right) - 1,
    // scanned only when s has left the segment found last
    float sw = s;
    if (s > L) sw = s - L * floorf(s / L);
    if (!(sw >= lo && sw < hi)) {
      int idx = -1;
      for (int i = 0; i < nseg; ++i) idx += (ts0[i] <= sw) ? 1 : 0;
      idx = idx < 0 ? 0 : (idx > nseg - 1 ? nseg - 1 : idx);
      cur = tcv[idx];
      lo = idx > 0 ? ts0[idx] : -INFINITY;
      hi = idx < nseg - 1 ? ts0[idx + 1] : INFINITY;
    }
    RL_PHASE(rl_rollout_phase, RP_CURV, cur)

    // lanes 0 / 1: front / rear slip angle and Pacejka force; lanes 2 / 3:
    // sin and cos of epsi / psi
    const float yf = vy + lf * wz, yr = vy - lr * wz;
    const float t = atan2f(j == 0 ? yf : yr, vx);
    const float alpha = j == 0 ? delta - t : -t;
    const float at = atanf(Bt * alpha);
    const float ang = j < 2 ? Ct * at : (j == 2 ? epsi : psi);
    const float sv = sinf(ang), cv = cosf(ang);
    const float fv = Dt * sv;
    const float fyf = from(fv, 0), fyr = from(fv, 1);
    const float se = from(sv, 2), ce = from(cv, 2);
    const float sp = from(sv, 3), cp = from(cv, 3);

    // the four divisions, a lane each
    float den = 1.0f - cur * ey;
    den = den >= 0.0f ? fmaxf(den, 0.05f) : fminf(den, -0.05f);
    const float n0 = fyf * sd, n1 = fyf * cd + fyr;
    const float n2 = lf * fyf * cd - lr * fyr;
    const float n3 = __fmaf_rn(vx, ce, -__fmul_rn(vy, se));
    const float q = (j == 0 ? n0 : j == 1 ? n1 : j == 2 ? n2 : n3) /
                    (j < 2 ? m : j == 2 ? Iz : den);
    const float dvx = a - from(q, 0) + wz * vy;
    const float dvy = from(q, 1) - wz * vx;
    const float dwz = from(q, 2);
    const float s_dot = from(q, 3);
    RL_PHASE(rl_rollout_phase, RP_TIRE, dvx + dvy + dwz + s_dot)

    const float depsi = wz - s_dot * cur;
    const float dey = __fmaf_rn(vy, ce, __fmul_rn(vx, se));
    const float vxn = vx + dT * dvx, vyn = vy + dT * dvy, wzn = wz + dT * dwz;
    epsi = epsi + dT * depsi;
    s = s + dT * s_dot;
    ey = ey + dT * dey;
    X = X + dT * __fmaf_rn(vx, cp, -__fmul_rn(vy, sp));
    Y = Y + dT * __fmaf_rn(vy, cp, __fmul_rn(vx, sp));
    psi = psi + dT * wz;
    vx = vxn;
    vy = vyn;
    wz = wzn;
    RL_PHASE(rl_rollout_phase, RP_KIN, vx + epsi + s + ey + X + Y + psi)
  }
  if (!live || j != 0) return;
  ox[b * 6 + 0] = vx;  ox[b * 6 + 1] = vy;  ox[b * 6 + 2] = wz;
  ox[b * 6 + 3] = epsi; ox[b * 6 + 4] = s;  ox[b * 6 + 5] = ey;
  oxg[b * 6 + 0] = vx; oxg[b * 6 + 1] = vy; oxg[b * 6 + 2] = wz;
  oxg[b * 6 + 3] = psi; oxg[b * 6 + 4] = X; oxg[b * 6 + 5] = Y;
}

extern "C" int rl_rollout(RolloutParams p, const float* x, const float* xg,
                          const float* u, float* ox, float* oxg, int B,
                          void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B * RL_LANES + RL_THREADS - 1) / RL_THREADS;
  rollout_kernel<<<blocks, RL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, x, xg, u, ox, oxg, B);
  return static_cast<int>(cudaGetLastError());
}

RL_PHASE_EXPORT(rl_rollout_phases, rl_rollout_phase, RP_N)
