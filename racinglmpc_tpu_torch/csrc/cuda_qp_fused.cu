// Kernel B4: the fused-prologue ADMM (K build + Newton-Schulz inverse
// refresh + the ADMM loop of B1, per scenario).
//
// Replaces racinglmpc_tpu/ops/pallas_qp.py::_kernel_fused (through
// admm_iterate_fused). Per scenario, on the Ruiz-scaled QP with fixed rho:
//   K = A'(rho A) + P + sigma I (the 128-pad block of the reference's
//     padded K is the identity: carried as a scalar below);
//   Jacobi init Xj = diag(dg) / max(|I - K diag(dg)|_F, 1), dg = 1/diag K;
//   warm test |I - K X0|_F < 0.9 on X0 = kinv0 (only where warm_ok; the
//     reference pads X0 with a unit diagonal, so the pad adds nothing);
//   two Newton-Schulz passes X <- X + X (I - K X) from r = inf while
//     max|I - K X| > ns_tol and it < ns_max_iters (the second restarts from
//     Xj when the first ends non-finite or above 50 ns_tol); the pad scalar
//     xp (1 on the warm path, 1/max(cj, 1) on the Jacobi path) follows its
//     own Newton-Schulz sequence and enters max|R| as |1 - xp|;
//   then B1's ADMM loop on the refreshed X. Lanes that need the
//   rho-escalation rescue are handled by B1's rescue launch
//   (cuda_qp.cu:admm_rescue), given the refreshed X and its pad scalars.
// Outputs: x, z, y, (pri, dua), (iters, done, needs-rescue, streamed), the
// refreshed inverse, ns_resid (the residual before the last update), the pad
// scalar, and (warm start taken, Newton-Schulz iterations) for diagnostics.
//
// Bound on this card: the prologue's operations, 2 m n^2 for K as a dense
// GEMM (what A's nonzeros need is far less: sum over rows of nnz(row)^2)
// and 4 n^3 per Newton-Schulz iteration (~20 on a cold LTV build: ~0.25
// GFLOP per scenario at n = 146), dominate. K and X are 85-160 KB each at
// n = 146-200 and do not fit in shared memory together, so K, X, Y and R
// live in a per-scenario global workspace (4 n^2 floats, L2-resident per
// CTA) and the products run as B1's rescue does: one CTA of 512 threads
// per scenario (each scenario exits its own Newton-Schulz loop and its own
// ADMM loop, the point of the fused kernel) over a 64x64-tiled float32
// GEMM on the CUDA cores, whose tiles overlay the Kinv slot of B1's
// resident layout. The ADMM phase then runs on B1's resident core: A and
// P compressed into shared memory at the start (one read), the refreshed
// X copied into the slot, and the loop reads only shared memory, with the
// same bits as the streaming core; shapes that do not fit
// (ops/cuda_qp.py:smem_plan) and scenarios whose nonzeros overflow the
// cap run the streaming core, flagged and counted. The K build and the
// Newton-Schulz GEMM (tensor cores, wgmma in split-float32; TMA) are left
// for later work.
#include "qp_common.cuh"

template <bool RES>
__global__ void __launch_bounds__(NT)
admm_fused(const QPParams p, const float* P_, const float* A_,
           const float* kinv0_, const int* warm_ok, const float* nvecs,
           const float* vecs, const float* cinv, const float* x0,
           const float* z0, const float* y0, float* xo, float* zo, float* yo,
           float* stats, int* flags, float* kinv_out, float* ns_out,
           float* kpad_out, int* ns_info, float* ws, int* streamed) {
  const int b = blockIdx.x, n = p.n, m = p.m, tid = threadIdx.x;
  unsigned char* smb = dyn_smem();
  const size_t nn = (size_t)n * n;
  const float* P = P_ + (size_t)b * nn;
  const float* A = A_ + (size_t)b * m * n;
  float *ctxp, *slot;
  Sparse s;
  bool fits = false;
  if (RES) {
    const Resident L = resident_layout(n, m, p.nnz_cap);
    ctxp = reinterpret_cast<float*>(smb + L.ctx);
    slot = reinterpret_cast<float*>(smb + L.slot);
    s = carve_sparse(smb, L);
    fits = build_sparse(p, A, P, s, reinterpret_cast<int*>(ctxp));
    __syncthreads();
  } else {
    ctxp = reinterpret_cast<float*>(smb);
    slot = ctxp + ctx_floats(n, m);
  }
  Ctx c = carve(ctxp, n, m);
  float* As = slot;
  float* Bs = As + TILE * TK;
  float* dg = Bs + TILE * TK;
  float* K = ws + (size_t)b * 4 * nn;
  float* X = K + nn;
  float* Y = X + nn;
  float* R = Y + nn;
  load_state(p, c, b, nvecs, vecs, x0, z0, y0);

  // K = A'(rho A) + P + sigma I and its Jacobi init
  const float cjm = build_k_jacobi(p, c, P, A, 1.f, K, dg, As, Bs);
  const float xj_pad = 1.f / cjm;

  bool use_warm = false;
  if (warm_ok[b]) {
    const float* X0 = kinv0_ + (size_t)b * nn;
    for (size_t e = tid; e < nn; e += NT) X[e] = X0[e];
    __syncthreads();
    float mx, sq;
    block_gemm(n, n, K, n, false, X, nullptr, R, EPI_RESID, nullptr, 0.f,
               0.f, As, Bs, c.red, mx, sq);
    const float r0f = sqrtf(sq);
    use_warm = isfinite(r0f) && r0f < 0.9f;
  }
  if (!use_warm) write_jacobi(n, dg, cjm, X);
  float xp = use_warm ? 1.f : xj_pad;
  int it1 = 0, it2 = 0;
  const float r1 = ns_run(p, n, K, X, Y, R, xp, As, Bs, c.red, &it1);
  if (!isfinite(r1) || r1 > 50.f * p.ns_tol) {
    write_jacobi(n, dg, cjm, X);
    xp = xj_pad;
  }
  const float ns_resid = ns_run(p, n, K, X, Y, R, xp, As, Bs, c.red, &it2);

  float* ko = kinv_out + (size_t)b * nn;
  for (size_t e = tid; e < nn; e += NT) ko[e] = X[e];
  if (tid == 0) {
    ns_out[b] = ns_resid;
    kpad_out[b] = xp;
    ns_info[b * 2 + 0] = use_warm ? 1 : 0;
    ns_info[b * 2 + 1] = it1 + it2;
  }
  if (RES) {   // X into the slot (the GEMM tiles are done with)
    for (size_t e = tid; e < nn; e += NT) slot[e] = X[e];
    __syncthreads();
    if (fits)
      admm_loop(p, c, b, SparseOps(s, slot, n, m), cinv[b], false, xo, zo,
                yo, stats, flags, streamed);
    else
      admm_loop(p, c, b, DenseOps{P, A, slot, n, m}, cinv[b], true, xo, zo,
                yo, stats, flags, streamed);
  } else {
    admm_loop(p, c, b, DenseOps{P, A, X, n, m}, cinv[b], true, xo, zo, yo,
              stats, flags, streamed);
  }
}

extern "C" int rl_admm_fused(QPParams p, const float* P, const float* A,
                             const float* kinv0, const int* warm_ok,
                             const float* nvecs, const float* vecs,
                             const float* cinv, const float* x0,
                             const float* z0, const float* y0, float* xo,
                             float* zo, float* yo, float* stats, int* flags,
                             float* kinv_out, float* ns_out, float* kpad_out,
                             int* ns_info, float* ws, int* streamed,
                             int layout, int B, void* stream) {
  if (B <= 0) return 0;
  const bool res = layout == LAYOUT_RESIDENT;
  const size_t smem = res ? resident_layout(p.n, p.m, p.nnz_cap).total
                          : gemm_ctx_floats(p.n, p.m) * sizeof(float);
  const void* fn = res ? reinterpret_cast<const void*>(admm_fused<true>)
                       : reinterpret_cast<const void*>(admm_fused<false>);
  int e = set_smem(fn, smem);
  if (e) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (res)
    admm_fused<true><<<B, NT, smem, st>>>(
        p, P, A, kinv0, warm_ok, nvecs, vecs, cinv, x0, z0, y0, xo, zo, yo,
        stats, flags, kinv_out, ns_out, kpad_out, ns_info, ws, streamed);
  else
    admm_fused<false><<<B, NT, smem, st>>>(
        p, P, A, kinv0, warm_ok, nvecs, vecs, cinv, x0, z0, y0, xo, zo, yo,
        stats, flags, kinv_out, ns_out, kpad_out, ns_info, ws, streamed);
  return static_cast<int>(cudaGetLastError());
}
