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
//   then B1's ADMM loop on the refreshed X, its iterations at the
//   precision the caller asks (B1's instantiations; "bf16x3" splits the
//   refreshed X). Lanes that need the
//   rho-escalation rescue are handled by B1's rescue launch
//   (cuda_qp.cu:admm_rescue), given the refreshed X and its pad scalars.
// Outputs: x, z, y, (pri, dua), (iters, done, needs-rescue, streamed), the
// refreshed inverse, ns_resid (the residual before the last update), the pad
// scalar, and (warm start taken, Newton-Schulz iterations) for diagnostics.
//
// Bound on this card: the prologue's operations, 2 m n^2 for K as a dense
// product (what A's nonzeros need is far less: sum over rows of
// nnz(row)^2) and 4 n^3 per Newton-Schulz iteration (~20 on a cold LTV
// build: ~0.25 GFLOP per scenario at n = 146), full float32 FMAs on the
// CUDA cores (TF32 and split-float32 tensor-core products are ruled out:
// every product must keep its fmaf chain, see below). Two launches, one
// CTA of 512 threads per scenario in each, so that each scenario exits its
// own Newton-Schulz loop and its own ADMM loop:
//   - the prologue (admm_fused_prologue below): K, X, Y and R in a
//     per-scenario global workspace (4 n^2 floats: K and X are 85-160 KB
//     each at n = 146-200 and do not fit in shared memory together). Each
//     product (qp_common.cuh:product, shared with B1's rescue) holds the
//     whole n x n output in registers, 8 x 8 outputs a thread read as
//     float4 fragments, and streams the two operands once through shared
//     memory in 16-deep slabs by cp.async, double buffered with one barrier
//     a slab, issued by the warps that hold no output cells, so the loads
//     hide behind the FMAs. The 8 x 8 cells need over 64 registers a
//     thread, so one CTA fits an SM and a batch of 256 runs in two waves
//     (cuda_qp_fused.py:plan). Every output is one fmaf chain over k in
//     order, as in the first port's 64 x 64-tiled GEMM, and the epilogues
//     are its operations pinned with __fmaf_rn / __fadd_rn / __fsub_rn:
//     the refreshed inverse, the Newton-Schulz counts and the warm
//     decisions keep their bits;
//   - the ADMM loop: B1's main kernel on the refreshed inverse
//     (cuda_qp.cu:rl_admm), in the layout ops/cuda_qp.py:choose_layout
//     picks, with B4's streamed-scenario counter. Its own kernel: the ADMM
//     core holds every register at 512 threads, and the prologue's state
//     beside it spilled. Its loop is the one the fused kernel ran on the
//     same inverse, so the bits are too.
#include "qp_common.cuh"

#ifdef QP_PHASES
static __device__ long long fused_phase[FPH_N];   // qp_common.cuh: FPH_*
#define FUSED_CLK fused_phase
#else
#define FUSED_CLK static_cast<long long*>(nullptr)
#endif

// One CTA per SM by registers (the 8 x 8 cells need over 64 a thread at
// 512 threads): the batch runs in waves of 132.
__global__ void __launch_bounds__(NT, 1)
admm_fused_prologue(const QPParams p, const float* P_, const float* A_,
                    const float* kinv0_, const int* warm_ok,
                    const float* vecs, float* kinv_out, float* ns_out,
                    float* kpad_out, int* ns_info, float* ws) {
  const int b = blockIdx.x, n = p.n, m = p.m, tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const float* P = P_ + (size_t)b * nn;
  const float* A = A_ + (size_t)b * m * n;
  float* ctxp = reinterpret_cast<float*>(dyn_smem());
  Ctx c = carve(ctxp, n, m);
  float* stage = ctxp + ctx_floats(n, m);   // the slabs, then the diagonal
  float* dg = stage + 2 * PK * (geo(n).sa + 8 * geo(n).cells);
  float* K = ws + (size_t)b * 4 * nn;
  float* X = K + nn;
  float* Y = X + nn;
  float* R = Y + nn;
  const float* rho = vecs + (size_t)b * 5 * m + 2 * m;   // pack_vectors
  for (int i = tid; i < m; i += NT) c.rho[i] = rho[i];
  __syncthreads();
  long long* clk = FUSED_CLK;
  TSTART

  // K = A'(rho A) + P + sigma I and its Jacobi init
  const float cjm = k_jacobi(p, c, P, A, 1.f, K, dg, stage, clk);
  const float xj_pad = 1.f / cjm;
  TMARK(clk, FPH_KBUILD, tid == 0)

  bool use_warm = false;
  if (warm_ok[b]) {
    const float* X0 = kinv0_ + (size_t)b * nn;
    for (size_t e = tid; e < nn; e += NT) X[e] = X0[e];
    __syncthreads();
    product<OP_RESID>(n, n, K, X, nullptr, 1.f, nullptr, 0.f, R, stage,
                      c.red, clk);
    const float r0f = sqrtf(frob_sq(n, R, c.red));
    use_warm = isfinite(r0f) && r0f < 0.9f;
  }
  if (!use_warm) write_jacobi(n, dg, cjm, X);
  TMARK(clk, FPH_WARM, tid == 0)
  float xp = use_warm ? 1.f : xj_pad;
  int it1 = 0, it2 = 0;
  const float r1 = ns_run(p, n, K, X, Y, R, xp, stage, c.red, &it1, clk);
  if (!isfinite(r1) || r1 > 50.f * p.ns_tol) {
    write_jacobi(n, dg, cjm, X);
    xp = xj_pad;
  }
  const float ns_resid =
      ns_run(p, n, K, X, Y, R, xp, stage, c.red, &it2, clk);
  TMARK(clk, FPH_NS, tid == 0)

  float* ko = kinv_out + (size_t)b * nn;
  for (size_t e = tid; e < nn; e += NT) ko[e] = X[e];
  if (tid == 0) {
    ns_out[b] = ns_resid;
    kpad_out[b] = xp;
    ns_info[b * 2 + 0] = use_warm ? 1 : 0;
    ns_info[b * 2 + 1] = it1 + it2;
  }
}

// dynamic shared memory of the prologue launch
extern "C" long long rl_fused_smem_bytes(int n, int m) {
  return (long long)prologue_smem(n, m);
}

// CTAs per SM the card runs of the prologue kernel (the occupancy
// calculator: shared memory, registers and threads); < 0 on an error
extern "C" int rl_fused_ctas_per_sm(int n, int m) {
  const size_t smem = prologue_smem(n, m);
  const void* fn = reinterpret_cast<const void*>(admm_fused_prologue);
  if (set_smem(fn, smem)) return -1;
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, NT, smem) !=
      cudaSuccess)
    return -1;
  return ctas;
}

// B1's main launch (cuda_qp.cu)
extern "C" int rl_admm(QPParams p, const float* P, const float* Kinv,
                       const float* A, const float* nvecs, const float* vecs,
                       const float* cinv, const float* x0, const float* z0,
                       const float* y0, float* xo, float* zo, float* yo,
                       float* stats, int* flags, int* streamed, int prec,
                       int layout, int B, void* stream);

// the prologue, then B1's ADMM loop on the refreshed inverse (kinv_out) at
// iteration precision prec
extern "C" int rl_admm_fused(QPParams p, const float* P, const float* A,
                             const float* kinv0, const int* warm_ok,
                             const float* nvecs, const float* vecs,
                             const float* cinv, const float* x0,
                             const float* z0, const float* y0, float* xo,
                             float* zo, float* yo, float* stats, int* flags,
                             float* kinv_out, float* ns_out, float* kpad_out,
                             int* ns_info, float* ws, int* streamed,
                             int prec, int layout, int B, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = prologue_smem(p.n, p.m);
  int e = set_smem(reinterpret_cast<const void*>(admm_fused_prologue), smem);
  if (e) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  admm_fused_prologue<<<B, NT, smem, st>>>(p, P, A, kinv0, warm_ok, vecs,
                                           kinv_out, ns_out, kpad_out,
                                           ns_info, ws);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  return rl_admm(p, P, kinv_out, A, nvecs, vecs, cinv, x0, z0, y0, xo, zo,
                 yo, stats, flags, streamed, prec, layout, B, stream);
}

#ifdef QP_PHASES
// B4's prologue clocks into host[FPH_N]; reset: zero them
extern "C" int rl_fused_phases(long long* host, int reset) {
  if (reset) {
    const long long zero[FPH_N] = {0};
    return static_cast<int>(
        cudaMemcpyToSymbol(fused_phase, zero, sizeof(zero)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, fused_phase, FPH_N * sizeof(long long)));
}
#endif
