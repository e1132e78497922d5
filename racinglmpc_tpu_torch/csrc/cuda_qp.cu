// Kernel B1: the ADMM iteration loop with the rho-escalation rescue.
//
// Replaces racinglmpc_tpu/ops/pallas_qp.py::_kernel + _admm_core (through
// admm_iterate). Per scenario, on the Ruiz-scaled QP with fixed rho:
//   entry check (iters = 0 when already at tolerance); chunks of
//   check_every iterations of
//     rhs = sigma x - q + A'(rho z - y);  xt = rhs.Kinv
//     refine: xt += (rhs - (xt.P + sigma xt + A'(rho A xt))).Kinv
//     x = alpha xt + (1-alpha) x;  z_rel = alpha A xt + (1-alpha) z
//     z = clip(z_rel + y/rho, l, u);  y += rho (z_rel - z)
//   with the unscaled primal/dual checks after each chunk and exactly
//   max_iter iterations counted; then, where pri > rescue_trigger, the
//   rescue (second launch): K2 = (A'(rho A)) s + P + sigma I, a two-pass
//   Newton-Schulz inverse from Jacobi (or Kinv/s when its padded Frobenius
//   residual is < 0.9), and up to rescue_max_iter iterations at rho*s with
//   a primal-only exit. The device functions live in qp_common.cuh (shared
//   with B4, cuda_qp_fused.cu, which launches this file's rescue too).
//
// Bound on this card: each iteration reads Kinv twice, P once and A four
// times (~1.3 MB per scenario at n=200, m=257) for ~0.65 MFLOP, so one
// scenario's loop is bound by L2/HBM bandwidth; the batch (256 x 525 KB of
// matrices) does not fit in the 50 MB L2. The design runs one CTA of 512
// threads per scenario, so each scenario exits at its own convergence
// (the per-scenario early exit the Pallas kernel was built around), keeps
// every vector in shared memory and streams the matrices from global memory
// with coalesced loads: v.M as column-per-thread sums split over two row
// halves, M v as one warp per row with a shuffle reduction. The rare
// rescue lanes run a 64x64-tiled float32 GEMM in shared memory with the
// n x n matrices in a global workspace; other lanes' CTAs return at once.
#include "qp_common.cuh"

__global__ void __launch_bounds__(NT)
admm_main(const QPParams p, const float* P_, const float* Kinv_,
          const float* A_, const float* nvecs, const float* vecs,
          const float* cinv, const float* x0, const float* z0,
          const float* y0, float* xo, float* zo, float* yo, float* stats,
          int* flags) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, n = p.n, m = p.m, tid = threadIdx.x;
  Ctx c = carve(sm, n, m);
  const float* P = P_ + (size_t)b * n * n;
  const float* Kinv = Kinv_ + (size_t)b * n * n;
  const float* A = A_ + (size_t)b * m * n;
  load_vectors(p, c, nvecs + (size_t)b * 2 * n, vecs + (size_t)b * 5 * m);
  for (int j = tid; j < n; j += NT) c.x[j] = x0[(size_t)b * n + j];
  for (int i = tid; i < m; i += NT) {
    c.z[i] = z0[(size_t)b * m + i];
    c.y[i] = y0[(size_t)b * m + i];
  }
  __syncthreads();
  admm_loop(p, c, b, P, A, Kinv, cinv[b], xo, zo, yo, stats, flags);
}

// kpad: per-scenario pad-block scalar of Kinv (B4's refreshed inverse), or
// nullptr when Kinv's pad block is zero (B1)
__global__ void __launch_bounds__(NT)
admm_rescue(const QPParams p, const float* P_, const float* Kinv_,
            const float* A_, const float* nvecs, const float* vecs,
            const float* cinv, const float* kpad, float* xo, float* zo,
            float* yo, float* stats, int* flags, float* ws) {
  const int b = blockIdx.x;
  if (flags[b * 3 + 2] == 0) return;
  extern __shared__ float sm[];
  const int n = p.n, m = p.m, tid = threadIdx.x;
  Ctx c = carve(sm, n, m);
  float* As = sm + ctx_floats(n, m);
  float* Bs = As + TILE * TK;
  float* dg = Bs + TILE * TK;
  const float* P = P_ + (size_t)b * n * n;
  const float* Kinv = Kinv_ + (size_t)b * n * n;
  const float* A = A_ + (size_t)b * m * n;
  float* K2 = ws + (size_t)b * 4 * n * n;
  float* X = K2 + (size_t)n * n;
  float* Y = X + (size_t)n * n;
  float* R = Y + (size_t)n * n;
  load_vectors(p, c, nvecs + (size_t)b * 2 * n, vecs + (size_t)b * 5 * m);
  for (int j = tid; j < n; j += NT) c.x[j] = xo[(size_t)b * n + j];
  for (int i = tid; i < m; i += NT) {
    c.z[i] = zo[(size_t)b * m + i];
    c.y[i] = yo[(size_t)b * m + i];
  }
  __syncthreads();
  const float s = p.rescue_rho_scale;
  float mx, sq;

  // K2 = (A' (rho A)) s + P + sigma I and its Jacobi init
  const float cjm = build_k_jacobi(p, c, P, A, s, K2, dg, As, Bs);
  const float xj_pad = 1.f / cjm;

  // warm test on Kinv / s: the pad block adds n_pad (1 - kp/s)^2 to the
  // squared Frobenius residual; at >= 0.81 the reference never takes it
  const float kp = kpad ? kpad[b] : 0.f;
  const float pad_d = 1.f - kp / s;
  const float pad_sq = p.n_pad ? (float)p.n_pad * pad_d * pad_d : 0.f;
  bool use_warm = false;
  if (pad_sq < 0.81f) {
    for (size_t e = tid; e < (size_t)n * n; e += NT) X[e] = Kinv[e] / s;
    __syncthreads();
    block_gemm(n, n, K2, n, false, X, nullptr, R, EPI_RESID, nullptr, 0.f,
               0.f, As, Bs, c.red, mx, sq);
    const float r0f = sqrtf(sq + pad_sq);
    use_warm = isfinite(r0f) && r0f < 0.9f;
  }
  if (!use_warm) write_jacobi(n, dg, cjm, X);
  float xp = use_warm ? kp / s : xj_pad;
  const float r1 = ns_run(p, n, K2, X, Y, R, xp, As, Bs, c.red);
  if (!isfinite(r1) || r1 > 50.f * p.ns_tol) {
    write_jacobi(n, dg, cjm, X);
    xp = xj_pad;
  }
  ns_run(p, n, K2, X, Y, R, xp, As, Bs, c.red);

  // iterations at rho * s with K2inv = X
  for (int i = tid; i < m; i += NT) {
    c.rho[i] = c.rho[i] * s;
    c.rinv[i] = c.rinv[i] / s;
  }
  __syncthreads();
  const float c_inv = cinv[b];
  const int it_main = min(flags[b * 3 + 0], p.max_iter);
  int iters = it_main + p.rescue_max_iter;
  bool rdone = false;
  float pri = stats[b * 2 + 0], dua = stats[b * 2 + 1];
  run_chunks(p, c, P, A, X, c_inv, p.rescue_max_iter, it_main, p.rescue_exit,
             rdone, iters, pri, dua);
  for (int j = tid; j < n; j += NT) xo[(size_t)b * n + j] = c.x[j];
  for (int i = tid; i < m; i += NT) {
    zo[(size_t)b * m + i] = c.z[i];
    yo[(size_t)b * m + i] = c.y[i];
  }
  if (tid == 0) {
    stats[b * 2 + 0] = pri;
    stats[b * 2 + 1] = dua;
    flags[b * 3 + 0] = iters;
    if (pri < p.rescue_exit) flags[b * 3 + 1] = 1;
  }
}

extern "C" int rl_admm(QPParams p, const float* P, const float* Kinv,
                       const float* A, const float* nvecs, const float* vecs,
                       const float* cinv, const float* x0, const float* z0,
                       const float* y0, float* xo, float* zo, float* yo,
                       float* stats, int* flags, int B, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = ctx_floats(p.n, p.m) * sizeof(float);
  int e = set_smem(reinterpret_cast<const void*>(admm_main), smem);
  if (e) return e;
  admm_main<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p, P, Kinv, A, nvecs, vecs, cinv, x0, z0, y0, xo, zo, yo, stats, flags);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_admm_rescue(QPParams p, const float* P, const float* Kinv,
                              const float* A, const float* nvecs,
                              const float* vecs, const float* cinv,
                              const float* kpad, float* xo, float* zo,
                              float* yo, float* stats, int* flags, float* ws,
                              int B, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = gemm_ctx_floats(p.n, p.m) * sizeof(float);
  int e = set_smem(reinterpret_cast<const void*>(admm_rescue), smem);
  if (e) return e;
  admm_rescue<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p, P, Kinv, A, nvecs, vecs, cinv, kpad, xo, zo, yo, stats, flags, ws);
  return static_cast<int>(cudaGetLastError());
}
