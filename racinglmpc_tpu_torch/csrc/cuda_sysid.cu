// Kernel B2: fused local system identification over the LMPC horizon.
//
// Replaces racinglmpc_tpu/ops/pallas_sysid.py::_kernel / _kernel_body.
// Semantics are those of racinglmpc_tpu/models/sysid.py's
// local_linearization_horizon: per horizon query and per stored lap, the
// knn nearest rows in the scaled-L1 metric on [vx, vy, wz, delta, a]
// (candidates 0..steps-2 of non-empty laps; argmin ties to the first
// index), Epanechnikov weights (zero at d >= h), two 5x5 weighted normal
// equations (vx row on [vx, vy, wz, a, 1]; lateral rows on
// [vx, vy, wz, delta, 1] -> vy', wz'), ridge jitter, Gauss-Jordan with
// diagonal pivots, and the analytic constant-curvature kinematic rows.
//
// Bound on this card: per scenario the lap store is K x T x 8 floats
// (64 KB at K=4, T=512) and every query scans all of it: ~N x K x T x 16
// flops plus knn x K rounds of a T-long arg-min, so ~1-2 MFLOP and a few
// hundred KB of (L1/L2-resident) reads per scenario -- latency of the
// dependent arg-min rounds, not bandwidth, sets the time. The design gives
// each query its own warp (no block-wide synchronization), keeps one lap's
// T distances per warp in shared memory, runs each arg-min round as a
// 5-step shuffle reduction, and accumulates the normal equations in
// registers; the store is read straight from global memory (coalesced
// along T by the lanes).
#include <cuda_runtime.h>
#include <math.h>

#define RL_MAX_SEG 16

struct SysidParams {
  int K, T, N, knn, empty, nseg;
  float h, reg, dt, L;
  float scal[5];
  float s0[RL_MAX_SEG];
  float curv[RL_MAX_SEG];
};

__device__ __forceinline__ int tri(int a, int b) {  // a <= b, 5x5 upper
  return a * 5 - a * (a - 1) / 2 + (b - a);
}

// Gauss-Jordan, diagonal pivots, the reference's elimination order.
template <int NY>
__device__ void gj_solve(float (&M)[5][5 + NY]) {
  for (int k = 0; k < 5; ++k) {
    const float piv = M[k][k];
    float row[5 + NY];
#pragma unroll
    for (int j = 0; j < 5 + NY; ++j) row[j] = M[k][j] / piv;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (i == k) continue;
      const float f = M[i][k];
#pragma unroll
      for (int j = 0; j < 5 + NY; ++j)
        M[i][j] = __fsub_rn(M[i][j], __fmul_rn(f, row[j]));
    }
#pragma unroll
    for (int j = 0; j < 5 + NY; ++j) M[k][j] = row[j];
  }
}

__global__ void sysid_kernel(const SysidParams p,
                             const float* __restrict__ sx,
                             const float* __restrict__ su,
                             const int* __restrict__ steps,
                             const float* __restrict__ xq,
                             const float* __restrict__ uq,
                             float* __restrict__ outA,
                             float* __restrict__ outB,
                             float* __restrict__ outC) {
  extern __shared__ float dsh[];
  const int b = blockIdx.x;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= p.N) return;
  const int T = p.T, K = p.K;
  float* d = dsh + w * T;

  const float* xqq = xq + ((size_t)b * p.N + w) * 6;
  const float* uqq = uq + ((size_t)b * p.N + w) * 2;
  float xv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xv[i] = xqq[i];
  const float z[5] = {xv[0], xv[1], xv[2], uqq[0], uqq[1]};

  float Qv[15], Ql[15], bv[5], bl[10];
#pragma unroll
  for (int i = 0; i < 15; ++i) { Qv[i] = 0.f; Ql[i] = 0.f; }
#pragma unroll
  for (int i = 0; i < 5; ++i) { bv[i] = 0.f; bl[2 * i] = 0.f; bl[2 * i + 1] = 0.f; }

  for (int k = 0; k < K; ++k) {
    const int st = steps[b * K + k];
    const int nvalid = (st < T ? st : T) - 1;
    const bool nonempty = st < p.empty;
    const float* lx = sx + ((size_t)b * K + k) * T * 6;
    const float* lu = su + ((size_t)b * K + k) * T * 2;
    for (int t = lane; t < T; t += 32) {
      float dist = INFINITY;
      if (nonempty && t < nvalid) {
        const float f[5] = {lx[t * 6 + 0], lx[t * 6 + 1], lx[t * 6 + 2],
                            lu[t * 2 + 0], lu[t * 2 + 1]};
        dist = 0.f;
#pragma unroll
        for (int j = 0; j < 5; ++j)
          dist = __fadd_rn(dist, fabsf(__fmul_rn(f[j] - z[j], p.scal[j])));
      }
      d[t] = dist;
    }
    __syncwarp();
    for (int r = 0; r < p.knn; ++r) {
      float best = INFINITY;
      int bi = T;
      for (int t = lane; t < T; t += 32) {
        const float v = d[t];
        if (v < best || (v == best && t < bi)) { best = v; bi = t; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ov < best || (ov == best && oi < bi)) { best = ov; bi = oi; }
      }
      best = __shfl_sync(0xffffffffu, best, 0);
      bi = __shfl_sync(0xffffffffu, bi, 0);
      __syncwarp();
      if (lane == 0) d[bi] = INFINITY;   // exclude from the next rounds
      __syncwarp();

      const float q = best / p.h;
      const float wgt =
          best < p.h ? __fmul_rn(0.75f, __fsub_rn(1.0f, __fmul_rn(q, q))) : 0.0f;
      const int sc = bi + 1 < T ? bi + 1 : T - 1;
      const float vx = lx[bi * 6 + 0], vy = lx[bi * 6 + 1], wz = lx[bi * 6 + 2];
      const float de = lu[bi * 2 + 0], ac = lu[bi * 2 + 1];
      const float y0 = lx[sc * 6 + 0], y1 = lx[sc * 6 + 1], y2 = lx[sc * 6 + 2];
      const float mv[5] = {vx, vy, wz, ac, 1.0f};
      const float ml[5] = {vx, vy, wz, de, 1.0f};
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        // unfused multiply / add: the plain version's rounding, operation
        // for operation (these 5x5 systems are near singular when stored
        // laps repeat, so contraction differences would be amplified)
        const float wv = __fmul_rn(wgt, mv[a]), wl = __fmul_rn(wgt, ml[a]);
#pragma unroll
        for (int c = a; c < 5; ++c) {
          Qv[tri(a, c)] = __fadd_rn(Qv[tri(a, c)], __fmul_rn(wv, mv[c]));
          Ql[tri(a, c)] = __fadd_rn(Ql[tri(a, c)], __fmul_rn(wl, ml[c]));
        }
        bv[a] = __fadd_rn(bv[a], __fmul_rn(wv, y0));
        bl[2 * a] = __fadd_rn(bl[2 * a], __fmul_rn(wl, y1));
        bl[2 * a + 1] = __fadd_rn(bl[2 * a + 1], __fmul_rn(wl, y2));
      }
    }
    __syncwarp();
  }

  float Mv[5][6], Ml[5][7];
#pragma unroll
  for (int a = 0; a < 5; ++a) {
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const int i = a <= c ? tri(a, c) : tri(c, a);
      Mv[a][c] = Qv[i] + (a == c ? p.reg : 0.f);
      Ml[a][c] = Ql[i] + (a == c ? p.reg : 0.f);
    }
    Mv[a][5] = bv[a];
    Ml[a][5] = bl[2 * a];
    Ml[a][6] = bl[2 * a + 1];
  }
  gj_solve<1>(Mv);
  gj_solve<2>(Ml);

  if (lane != 0) return;
  // kinematic rows (constant-curvature Jacobian at the query)
  const float vx = xv[0], vy = xv[1], wz = xv[2], epsi = xv[3], s = xv[4], ey = xv[5];
  const float sw = s > p.L ? s - p.L * floorf(s / p.L) : s;
  int idx = -1;
  for (int i = 0; i < p.nseg; ++i) idx += (p.s0[i] <= sw) ? 1 : 0;
  idx = idx < 0 ? 0 : (idx > p.nseg - 1 ? p.nseg - 1 : idx);
  const float cur = p.curv[idx];
  float den = 1.0f - cur * ey;
  den = den >= 0.0f ? fmaxf(den, 0.05f) : fminf(den, -0.05f);
  const float ce = cosf(epsi), se = sinf(epsi), h = p.dt;
  const float sdot = (vx * ce - vy * se) / den;
  const float den2 = den * den;
  const float r3[6] = {-h * ce / den * cur, h * se / den * cur, h,
                       1.0f - h * (-vx * se - vy * ce) / den * cur, 0.0f,
                       h * (vx * ce - vy * se) / den2 * cur * (-cur)};
  const float r4[6] = {h * ce / den, -h * se / den, 0.0f,
                       h * (-vx * se - vy * ce) / den, 1.0f,
                       -h * (vx * ce - vy * se) / den2 * (-cur)};
  const float r5[6] = {h * se, h * ce, 0.0f, h * (vx * ce - vy * se), 0.0f, 1.0f};
  const float f3 = epsi + h * (wz - sdot * cur);
  const float f4 = s + h * sdot;
  const float f5 = ey + h * (vx * se + vy * ce);

  float* A = outA + ((size_t)b * p.N + w) * 36;
  float* Bm = outB + ((size_t)b * p.N + w) * 12;
  float* C = outC + ((size_t)b * p.N + w) * 6;
#pragma unroll
  for (int i = 0; i < 36; ++i) A[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 12; ++i) Bm[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    A[0 * 6 + j] = Mv[j][5];
    A[1 * 6 + j] = Ml[j][5];
    A[2 * 6 + j] = Ml[j][6];
  }
  Bm[0 * 2 + 1] = Mv[3][5];
  Bm[1 * 2 + 0] = Ml[3][5];
  Bm[2 * 2 + 0] = Ml[3][6];
  C[0] = Mv[4][5];
  C[1] = Ml[4][5];
  C[2] = Ml[4][6];
  float d3 = 0.f, d4 = 0.f, d5 = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    A[3 * 6 + j] = r3[j];
    A[4 * 6 + j] = r4[j];
    A[5 * 6 + j] = r5[j];
    d3 += r3[j] * xv[j];
    d4 += r4[j] * xv[j];
    d5 += r5[j] * xv[j];
  }
  C[3] = f3 - d3;
  C[4] = f4 - d4;
  C[5] = f5 - d5;
}

extern "C" int rl_sysid(SysidParams p, const float* sx, const float* su,
                        const int* steps, const float* xq, const float* uq,
                        float* A, float* Bm, float* C, int B, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)p.N * p.T * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sysid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sysid_kernel<<<B, p.N * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      p, sx, su, steps, xq, uq, A, Bm, C);
  return static_cast<int>(cudaGetLastError());
}
