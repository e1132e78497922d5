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
// Bound on this card. What the work needs is one read of P, Kinv and A per
// solve (134.6 MB at batch 256, n = 200, m = 257: ~40 us, bytes-bound); A
// is 1.8% and P 0.3% nonzero. Streaming the dense matrices from global
// memory in every product, as the first port did, moves ~1.3 MB per
// scenario per iteration, and the batch does not fit in the 50 MB L2. The
// design keeps each scenario's problem on chip, as the Pallas kernel kept
// it in VMEM:
//   - one CTA of 512 threads per scenario (each scenario exits at its own
//     convergence; the block scheduler hands a freed SM the next one);
//   - resident layout: the prologue starts a bulk copy (cp.async.bulk on an
//     mbarrier) of Kinv into shared memory and, while it flies, reads A and
//     P once, coalesced, compacting their nonzeros into shared memory: A as
//     CSR (A x) and CSC (v.A), P as CSC (v.P; P is not exactly symmetric),
//     int16 indices. The loop then reads only shared memory. Every product
//     sums in the dense kernels' order (A x: lane = column mod 32, then the
//     xor tree; v.M: two row halves, then their sum), so the resident and
//     stream layouts give the same bits and two calls give the same bits
//     (no floating-point atomics). Each elementwise step is folded into a
//     product's pass (8 barriers per iteration). Full float32 FMAs on the
//     CUDA cores; K is never formed;
//   - stream layout: the same core reading dense P, Kinv and A from global
//     memory in every product, for shapes whose Kinv does not fit beside the
//     vectors (ops/cuda_qp.py:smem_plan) or when forced; a resident CTA whose
//     nonzeros overflow the cap runs it on its shared Kinv with dense A and
//     P from global memory. Each such scenario is flagged and counted.
// What bounds the resident loop now is latency, not bytes: an iteration is
// a chain of 8 dependent block-wide passes (two over Kinv in shared memory,
// bound by its ~1,250 shared-memory wavefronts each), ~13K SM cycles, and a
// call lasts as long as its slowest scenario's iterations (PERF.md).
// The rare rescue lanes build K2 and run the Newton-Schulz passes on B4's
// product core (qp_common.cuh: the whole n x n output in registers, the
// operands staged by producer warps) with the n x n matrices in a global
// workspace, in a launch of their own (beside the ADMM core's state the
// core spilled); a second launch copies the inverse into the slot and runs
// their chunks on the resident core. Other lanes' CTAs return at once.
// Iteration precision: the main kernels are instantiated at each of
// PREC_HIGHEST, PREC_BF16X3 and PREC_DEFAULT (the reference's
// pallas_iter_precision "highest", "bf16x3", "default"); only the products
// of the main loop's iterations change (qp_common.cuh: one set of passes
// templated on the precision, its accumulator Acc; the operands split on
// the fly, three float32 accumulators an output at bf16x3), and the rescue
// always iterates at PREC_HIGHEST. At PREC_HIGHEST an output is one
// float32 fmaf chain, with the bits the loop had before the variants
// came. bf16x3 triples the iteration's multiply-adds and adds the splits,
// on the CUDA cores: a float32 FMA is already exact in one pass here, so
// no variant is faster.
#include "qp_common.cuh"

// (NT, 1): without the 1, ptxas may cap this kernel at 64 registers and
// spill inside the streamed products (measured: twice the time)
template <int PR>
__global__ void __launch_bounds__(NT, 1)
admm_main_stream(const QPParams p, const float* P_, const float* Kinv_,
                 const float* A_, const float* nvecs, const float* vecs,
                 const float* cinv, const float* x0, const float* z0,
                 const float* y0, float* xo, float* zo, float* yo,
                 float* stats, int* flags, int* streamed) {
  const int b = blockIdx.x, n = p.n, m = p.m;
  Ctx c = carve(reinterpret_cast<float*>(dyn_smem()), n, m);
  const DenseOps op{P_ + (size_t)b * n * n, A_ + (size_t)b * m * n,
                    Kinv_ + (size_t)b * n * n, n, m};
  load_state(p, c, b, nvecs, vecs, x0, z0, y0);
  admm_loop<PR>(p, c, b, op, cinv[b], true, xo, zo, yo, stats, flags,
                streamed);
}

// One CTA per SM by registers (~100 of them for 512 threads): a bound of
// two CTAs would cap them at 64 and spill the products' partial sums.
template <int PR>
__global__ void __launch_bounds__(NT, 1)
admm_main_resident(const QPParams p, const float* P_, const float* Kinv_,
                   const float* A_, const float* nvecs, const float* vecs,
                   const float* cinv, const float* x0, const float* z0,
                   const float* y0, float* xo, float* zo, float* yo,
                   float* stats, int* flags, int* streamed) {
  const int b = blockIdx.x, n = p.n, m = p.m;
  unsigned char* smb = dyn_smem();
  const Resident L = resident_layout(n, m, p.nnz_cap);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smb);
  float* ctxp = reinterpret_cast<float*>(smb + L.ctx);
  Sparse s = carve_sparse(smb, L);
  const float* P = P_ + (size_t)b * n * n;
  const float* A = A_ + (size_t)b * m * n;
  PHASE_START
  if (threadIdx.x == 0) mbar_init(bar);
  const float* K = kinv_copy_start(Kinv_ + (size_t)b * n * n, n * n,
                                   reinterpret_cast<float*>(smb + L.slot),
                                   bar);
  const bool fits = build_sparse(p, A, P, s, reinterpret_cast<int*>(ctxp));
  __syncthreads();   // the compaction's scratch (the context) is free
  PHASE(PH_PROLOGUE)
  Ctx c = carve(ctxp, n, m);
  load_state(p, c, b, nvecs, vecs, x0, z0, y0);
  mbar_wait(bar, 0);
  PHASE(PH_WAIT)
  if (fits)
    admm_loop<PR>(p, c, b, SparseOps(s, K, n, m), cinv[b], false, xo, zo,
                  yo, stats, flags, streamed);
  else
    admm_loop<PR>(p, c, b, DenseOps{P, A, K, n, m}, cinv[b], true, xo, zo,
                  yo, stats, flags, streamed);
}

// The rescue's Newton-Schulz prologue, on the lanes flags[:, 2] marks:
// K2 = (A' (rho A)) s + P + sigma I, its inverse from Jacobi or Kinv / s,
// written to the first n^2 floats of the lane's workspace. kpad:
// per-scenario pad-block scalar of Kinv (B4's refreshed inverse), or
// nullptr when Kinv's pad block is zero (B1). count: nullptr, or the
// rescue's work counter, to which each rescued lane adds 1 (count[0]), its
// Newton-Schulz iterations of both passes (count[1]) and 1 where it ran
// the warm test's product (count[2]). Its own kernel: beside the ADMM
// core's state the product core spilled.
__global__ void __launch_bounds__(NT, 1)
admm_rescue_prologue(const QPParams p, const float* P_, const float* Kinv_,
                     const float* A_, const float* vecs, const float* kpad,
                     const int* flags, float* ws, int* count) {
  const int b = blockIdx.x;
  if (flags[b * NFLAG + 2] == 0) return;
  const int n = p.n, m = p.m, tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const float* Kinv = Kinv_ + (size_t)b * nn;
  float* ctxp = reinterpret_cast<float*>(dyn_smem());
  Ctx c = carve(ctxp, n, m);
  float* stage = ctxp + ctx_floats(n, m);   // the slabs, then the diagonal
  float* dg = stage + 2 * PK * (geo(n).sa + 8 * geo(n).cells);
  float* K2 = ws + (size_t)b * 4 * nn;
  float* X = K2 + nn;
  float* Y = X + nn;
  float* R = Y + nn;
  const float* rho = vecs + (size_t)b * 5 * m + 2 * m;   // pack_vectors
  for (int i = tid; i < m; i += NT) c.rho[i] = rho[i];
  __syncthreads();
  const float s_r = p.rescue_rho_scale;

  // K2 = (A' (rho A)) s + P + sigma I and its Jacobi init
  const float cjm = k_jacobi(p, c, P_ + (size_t)b * nn,
                             A_ + (size_t)b * m * n, s_r, K2, dg, stage,
                             nullptr);
  const float xj_pad = 1.f / cjm;

  // warm test on Kinv / s: the pad block adds n_pad (1 - kp/s)^2 to the
  // squared Frobenius residual; at >= 0.81 the reference never takes it
  const float kp = kpad ? kpad[b] : 0.f;
  const float pad_d = 1.f - kp / s_r;
  const float pad_sq = p.n_pad ? (float)p.n_pad * pad_d * pad_d : 0.f;
  // each count added where it is known: nothing stays live across the
  // Newton-Schulz passes for it (held across them, ptxas spilled)
  if (count && tid == 0) {
    atomicAdd(count, 1);
    if (pad_sq < 0.81f) atomicAdd(count + 2, 1);
  }
  bool use_warm = false;
  if (pad_sq < 0.81f) {
    for (size_t e = tid; e < nn; e += NT) X[e] = Kinv[e] / s_r;
    __syncthreads();
    product<OP_RESID>(n, n, K2, X, nullptr, 1.f, nullptr, 0.f, R, stage,
                      c.red, nullptr);
    const float r0f = sqrtf(frob_sq(n, R, c.red) + pad_sq);
    use_warm = isfinite(r0f) && r0f < 0.9f;
  }
  if (!use_warm) write_jacobi(n, dg, cjm, X);
  float xp = use_warm ? kp / s_r : xj_pad;
  int its;
  const float r1 = ns_run(p, n, K2, X, Y, R, xp, stage, c.red, &its, nullptr);
  if (count && tid == 0) atomicAdd(count + 1, its);
  if (!isfinite(r1) || r1 > 50.f * p.ns_tol) {
    write_jacobi(n, dg, cjm, X);
    xp = xj_pad;
  }
  ns_run(p, n, K2, X, Y, R, xp, stage, c.red, &its, nullptr);
  if (count && tid == 0) atomicAdd(count + 1, its);
  for (size_t e = tid; e < nn; e += NT) K2[e] = X[e];   // K2 is done with
}

// The rescue's iterations at rho * s with K2inv (the prologue's output,
// the first n^2 floats of the lane's workspace), on the lanes flags[:, 2]
// marks, from the main launch's iterates.
template <bool RES>
__global__ void __launch_bounds__(NT, 1)
admm_rescue(const QPParams p, const float* P_, const float* A_,
            const float* nvecs, const float* vecs, const float* cinv,
            float* xo, float* zo, float* yo, float* stats, int* flags,
            const float* ws) {
  const int b = blockIdx.x;
  if (flags[b * NFLAG + 2] == 0) return;
  const int n = p.n, m = p.m, tid = threadIdx.x;
  unsigned char* smb = dyn_smem();
  const float* P = P_ + (size_t)b * n * n;
  const float* A = A_ + (size_t)b * m * n;
  const float* X = ws + (size_t)b * 4 * n * n;
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
    slot = nullptr;
  }
  Ctx c = carve(ctxp, n, m);
  load_state(p, c, b, nvecs, vecs, xo, zo, yo);
  const float s_r = p.rescue_rho_scale;
  for (int i = tid; i < m; i += NT) {
    c.rho[i] = c.rho[i] * s_r;
    c.rinv[i] = c.rinv[i] / s_r;
  }
  const float c_inv = cinv[b];
  const int it_main = min(flags[b * NFLAG + 0], p.max_iter);
  int iters = it_main + p.rescue_max_iter;
  bool rdone = false;
  float pri = stats[b * 2 + 0], dua = stats[b * 2 + 1];
  if (RES) {   // K2inv into the slot
    for (size_t e = tid; e < (size_t)n * n; e += NT) slot[e] = X[e];
    __syncthreads();
    if (fits)
      run_chunks<PREC_HIGHEST>(p, c, SparseOps(s, slot, n, m), c_inv,
                               p.rescue_max_iter, it_main, p.rescue_exit,
                               rdone, iters, pri, dua);
    else
      run_chunks<PREC_HIGHEST>(p, c, DenseOps{P, A, slot, n, m}, c_inv,
                               p.rescue_max_iter, it_main, p.rescue_exit,
                               rdone, iters, pri, dua);
  } else {
    __syncthreads();
    run_chunks<PREC_HIGHEST>(p, c, DenseOps{P, A, X, n, m}, c_inv,
                             p.rescue_max_iter, it_main, p.rescue_exit,
                             rdone, iters, pri, dua);
  }
  store_iterates(p, c, b, xo, zo, yo);
  if (tid == 0) {
    stats[b * 2 + 0] = pri;
    stats[b * 2 + 1] = dua;
    flags[b * NFLAG + 0] = iters;
    if (pri < p.rescue_exit) flags[b * NFLAG + 1] = 1;
  }
}

// dynamic shared memory of the main and the rescue's iteration launches in
// a layout
extern "C" long long rl_admm_smem_bytes(int n, int m, int nnz_cap,
                                        int layout) {
  if (layout == LAYOUT_RESIDENT)
    return (long long)resident_layout(n, m, nnz_cap).total;
  return (long long)(ctx_floats(n, m) * sizeof(float));
}

template <int PR>
static const void* main_kernel_at(int layout) {
  return layout == LAYOUT_RESIDENT
             ? reinterpret_cast<const void*>(admm_main_resident<PR>)
             : reinterpret_cast<const void*>(admm_main_stream<PR>);
}

// the main kernel's instantiation in a layout at an iteration precision
// (nullptr for an unknown precision)
static const void* main_kernel(int layout, int prec) {
  switch (prec) {
    case PREC_HIGHEST: return main_kernel_at<PREC_HIGHEST>(layout);
    case PREC_BF16X3: return main_kernel_at<PREC_BF16X3>(layout);
    case PREC_DEFAULT: return main_kernel_at<PREC_DEFAULT>(layout);
    default: return nullptr;
  }
}

// CTAs per SM the card runs of the main kernel in a layout at an
// iteration precision (the occupancy calculator: shared memory, registers
// and threads); < 0 on an error
extern "C" int rl_admm_ctas_per_sm(int n, int m, int nnz_cap, int layout,
                                   int prec) {
  const size_t smem = rl_admm_smem_bytes(n, m, nnz_cap, layout);
  const void* fn = main_kernel(layout, prec);
  if (!fn) return -1;
  if (set_smem(fn, smem)) return -1;
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, NT, smem) !=
      cudaSuccess)
    return -1;
  return ctas;
}

// the main launch in a layout, its loop at iteration precision prec
extern "C" int rl_admm(QPParams p, const float* P, const float* Kinv,
                       const float* A, const float* nvecs, const float* vecs,
                       const float* cinv, const float* x0, const float* z0,
                       const float* y0, float* xo, float* zo, float* yo,
                       float* stats, int* flags, int* streamed, int prec,
                       int layout, int B, void* stream) {
  if (B <= 0) return 0;
  const void* fn = main_kernel(layout, prec);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rl_admm_smem_bytes(p.n, p.m, p.nnz_cap, layout);
  int e = set_smem(fn, smem);
  if (e) return e;
  // both layouts' kernels take the same arguments
  void* args[] = {&p,  &P,  &Kinv, &A,  &nvecs, &vecs,  &cinv,  &x0,
                  &z0, &y0, &xo,   &zo, &yo,    &stats, &flags, &streamed};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(B), dim3(NT), args, smem,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int rl_admm_rescue(QPParams p, const float* P, const float* Kinv,
                              const float* A, const float* nvecs,
                              const float* vecs, const float* cinv,
                              const float* kpad, float* xo, float* zo,
                              float* yo, float* stats, int* flags, float* ws,
                              int* count, int layout, int B, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t pro = prologue_smem(p.n, p.m);
  int e = set_smem(reinterpret_cast<const void*>(admm_rescue_prologue), pro);
  if (e) return e;
  admm_rescue_prologue<<<B, NT, pro, st>>>(p, P, Kinv, A, vecs, kpad, flags,
                                           ws, count);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const size_t smem = rl_admm_smem_bytes(p.n, p.m, p.nnz_cap, layout);
  const void* fn = layout == LAYOUT_RESIDENT
                       ? reinterpret_cast<const void*>(admm_rescue<true>)
                       : reinterpret_cast<const void*>(admm_rescue<false>);
  e = set_smem(fn, smem);
  if (e) return e;
  if (layout == LAYOUT_RESIDENT)
    admm_rescue<true><<<B, NT, smem, st>>>(p, P, A, nvecs, vecs, cinv, xo,
                                           zo, yo, stats, flags, ws);
  else
    admm_rescue<false><<<B, NT, smem, st>>>(p, P, A, nvecs, vecs, cinv, xo,
                                            zo, yo, stats, flags, ws);
  return static_cast<int>(cudaGetLastError());
}

#ifdef QP_PHASES
// the phase clocks (qp_common.cuh) into host[PH_N]; reset: zero them
extern "C" int rl_admm_phases(long long* host, int reset) {
  if (reset) {
    const long long zero[PH_N] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(qp_phase, zero, sizeof(zero)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, qp_phase, PH_N * sizeof(long long)));
}
#endif
