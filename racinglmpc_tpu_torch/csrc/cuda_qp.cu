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
// product core (qp_common.cuh: 8 x 8 outputs a thread, the operands staged
// by producer warps) with the n x n matrices in a global workspace (4 n^2
// floats a lane, held in L2), in a launch of their own (beside the ADMM
// core's state the core spilled). A lane is a chain of dependent n^3
// products (K2, then two a Newton-Schulz iteration, 20-80 of them), and
// the LMPC cell rescues ~9 lanes a step: on one SM a lane the rest of the
// card sat idle. So a rescued lane runs on a thread-block cluster of up
// to rescue_split(n) CTAs (one per 8-row cell of the output, at most 8,
// the portable cluster size: 8 at n = 146 and 200), each computing a band
// of whole 8-row cells of every product's rows and staging the whole right
// operand from the workspace in 16-byte copies (8-byte at n = 146, as B4
// does; 4-byte copies kept the load units busy for half a slab). What
// bounds a lane now is its longest band's product (4 of 25 cells at
// n = 200), its multiply at about a third of the FMA issue rate with one
// cell warp or less a scheduler, and the two cluster barriers of each
// iteration (barrier.cluster release / acquire: one band's global writes
// are seen by the next product's readers); the bands' max|R| combine over
// distributed shared memory with nanmax, which no order changes. Every
// output keeps its fmaf chain over k and its epilogue, so K2, each iterate
// and the inverse keep their bits; each CTA takes the two Frobenius sums
// (the Jacobi init's, the warm test's) alone over the whole matrix in the
// one-CTA thread order, so all of them take the same branches with the
// same scalars, and no CTA writes a band of a matrix that another CTA may
// still be reading whole (a barrier after the warm test's sum, before the
// first Newton-Schulz product rewrites R). The split follows what the card
// can run at once: the rescued lanes F, counted on the device from
// flags[:, 2] by every launch, take one cluster each at the largest split
// c (8, 4, 2) whose clusters the card holds F of at once
// (cudaOccupancyMaxActiveClusters: 15, 30 and 66 at n = 200), so F c
// stays within the SMs; past the clusters of 2 (the forced rescue: every
// lane), one CTA a lane, as before. One launch per split and one of B
// CTAs, each returning at once where another takes the lanes. The last
// launch copies the inverse into the slot and runs their chunks on the
// resident core.
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
#include <limits.h>

#include "qp_common.cuh"

// cluster launches of the rescue prologue at most (splits 8, 4, 2)
#define RESCUE_TIERS 3
// (device, split, shared memory) keys of the rescue's cluster occupancy kept
#define RESCUE_KEYS 30

#ifdef QP_PHASES
// the rescue prologue's clocks (admm_bench.py --rescue-lanes --phases):
// qp_common.cuh's FPH_* of the first CTA of the launch that takes lane 0
static __device__ long long rescue_phase[FPH_N];
#define RESCUE_CLK rescue_phase
#else
#define RESCUE_CLK static_cast<long long*>(nullptr)
#endif

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

// The rescued lanes flags[:, 2] marks among B, counted by every thread
static __device__ int rescued_lanes(const int* flags, int B) {
  int F = 0;
  for (int i0 = 0; i0 < B; i0 += NT) {
    const int i = i0 + threadIdx.x;
    F += __syncthreads_count(i < B && flags[i * NFLAG + 2] != 0);
  }
  return F;
}

// the j-th of them in lane order (j < their count); red: NT / 32 ints
static __device__ int rescued_lane(const int* flags, int B, int j, int* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i0 = 0;; i0 += NT) {
    const int i = i0 + threadIdx.x;
    const bool f = i < B && flags[i * NFLAG + 2] != 0;
    const unsigned bal = __ballot_sync(FULL, f);
    if (lane == 0) red[w] = __popc(bal);
    __syncthreads();
    int before = 0, here = 0;
    for (int k = 0; k < NT / 32; ++k) {
      before += k < w ? red[k] : 0;
      here += red[k];
    }
    __syncthreads();
    if (j < here) {
      if (f && before + __popc(bal & ((1u << lane) - 1)) == j) red[0] = i;
      __syncthreads();
      const int b = red[0];
      __syncthreads();
      return b;
    }
    j -= here;
  }
}

// One rescued lane b's prologue, this CTA's band of it (cta_band): K2 =
// (A' (rho A)) s + P + sigma I, its inverse from Jacobi or Kinv / s,
// written to the first n^2 floats of the lane's workspace. kpad:
// per-scenario pad-block scalar of Kinv (B4's refreshed inverse), or
// nullptr when Kinv's pad block is zero (B1). count: nullptr, or the
// rescue's work counter: the band of row 0 adds 1 (count[0]), the lane's
// Newton-Schulz iterations of both passes (count[1]), 1 where it ran the
// warm test's product (count[2]) and the lane's CTAs (count[3]).
// Elementwise work is the band's rows; the Frobenius sums (the Jacobi
// init's and the warm test's) each CTA takes alone over the whole matrix in
// the one-CTA thread order, so every CTA takes the same branches with the
// same scalars.
static __device__ void rescue_lane(const QPParams& p, const float* P_,
                                   const float* Kinv_, const float* A_,
                                   const float* vecs, const float* kpad,
                                   float* ws, int* count, int b, Ctx& c,
                                   float* stage, float* dg) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const float* Kinv = Kinv_ + (size_t)b * nn;
  float* K2 = ws + (size_t)b * 4 * nn;
  float* X = K2 + nn;
  float* Y = X + nn;
  float* R = Y + nn;
  const float* rho = vecs + (size_t)b * 5 * m + 2 * m;   // pack_vectors
  for (int i = tid; i < m; i += NT) c.rho[i] = rho[i];
  __syncthreads();
  const float s_r = p.rescue_rho_scale;
  long long* clk = RESCUE_CLK;
  TSTART

  // K2 = (A' (rho A)) s + P + sigma I and its Jacobi init
  const float cjm = k_jacobi(p, c, P_ + (size_t)b * nn,
                             A_ + (size_t)b * m * n, s_r, K2, dg, stage, clk);
  const float xj_pad = 1.f / cjm;
  TMARK(clk, FPH_KBUILD, tid == 0)

  // warm test on Kinv / s: the pad block adds n_pad (1 - kp/s)^2 to the
  // squared Frobenius residual; at >= 0.81 the reference never takes it
  const float kp = kpad ? kpad[b] : 0.f;
  const float pad_d = 1.f - kp / s_r;
  const float pad_sq = p.n_pad ? (float)p.n_pad * pad_d * pad_d : 0.f;
  int r0, r1;
  const int split = cta_band(n, &r0, &r1);
  // each count added where it is known: nothing stays live across the
  // Newton-Schulz passes for it (held across them, ptxas spilled)
  if (count && r0 == 0 && tid == 0) {
    atomicAdd(count, 1);
    atomicAdd(count + 3, split);
    if (pad_sq < 0.81f) atomicAdd(count + 2, 1);
  }
  bool use_warm = false;
  if (pad_sq < 0.81f) {
    for (size_t e = (size_t)r0 * n + tid; e < (size_t)r1 * n; e += NT)
      X[e] = Kinv[e] / s_r;
    __syncthreads();
    band_sync();
    product<OP_RESID>(n, n, K2, X, nullptr, 1.f, nullptr, 0.f, R, stage,
                      c.red, clk);
    band_sync();
    const float r0f = sqrtf(frob_sq(n, R, c.red) + pad_sq);
    // every CTA has read the whole R (the same r0f, so the same branch)
    // before any writes its band of the next
    band_sync();
    use_warm = isfinite(r0f) && r0f < 0.9f;
  }
  if (!use_warm) write_jacobi(n, dg, cjm, X);
  TMARK(clk, FPH_WARM, tid == 0)
  float xp = use_warm ? kp / s_r : xj_pad;
  int its;
  const float r1s = ns_run(p, n, K2, X, Y, R, xp, stage, c.red, &its, clk);
  if (count && cluster_reg_rank() == 0 && tid == 0) atomicAdd(count + 1, its);
  if (!isfinite(r1s) || r1s > 50.f * p.ns_tol) {
    write_jacobi(n, dg, cjm, X);
    xp = xj_pad;
  }
  ns_run(p, n, K2, X, Y, R, xp, stage, c.red, &its, clk);
  if (count && cluster_reg_rank() == 0 && tid == 0) atomicAdd(count + 1, its);
  TMARK(clk, FPH_NS, tid == 0)
  cta_band(n, &r0, &r1);
  for (size_t e = (size_t)r0 * n + tid; e < (size_t)r1 * n; e += NT)
    K2[e] = X[e];   // K2 is done with
}

// The rescue's Newton-Schulz prologue over the rescued lanes, in launches
// of this kernel that each take the lanes where their count F (of the B
// lanes flags[:, 2] marks) lies in (lo, hi], the rest returning at once:
//   - on clusters (rl_admm_rescue's cluster launches, one per split, hi
//     clusters each): cluster j takes the j-th rescued lane, each CTA of
//     it a band of every product's rows (cta_band);
//   - one CTA a lane (the launch of B CTAs, hi = INT_MAX): CTA b takes
//     lane b whole.
// Its own kernel: beside the ADMM core's state the product core spilled.
__global__ void __launch_bounds__(NT, 1)
admm_rescue_prologue(const QPParams p, const float* P_, const float* Kinv_,
                     const float* A_, const float* vecs, const float* kpad,
                     const int* flags, float* ws, int* count, int B, int lo,
                     int hi) {
  const int n = p.n, m = p.m;
  float* ctxp = reinterpret_cast<float*>(dyn_smem());
  Ctx c = carve(ctxp, n, m);
  float* stage = ctxp + ctx_floats(n, m);   // the slabs, then the diagonal
  float* dg = stage + 2 * PK * (geo(n).sa + 8 * geo(n).cells);
  int b;
  if (cluster_reg_size() == 1) {
    b = blockIdx.x;
    if (flags[b * NFLAG + 2] == 0) return;
    const int F = rescued_lanes(flags, B);
    if (F <= lo || F > hi) return;
  } else {
    const int F = rescued_lanes(flags, B), j = (int)cluster_reg_id();
    if (F <= lo || F > hi || j >= F) return;
    b = rescued_lane(flags, B, j, reinterpret_cast<int*>(c.red));
  }
  rescue_lane(p, P_, Kinv_, A_, vecs, kpad, ws, count, b, c, stage, dg);
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

// a launch of `clusters` clusters of c CTAs of the rescue prologue (at: its
// one attribute)
static cudaLaunchConfig_t rescue_config(cudaLaunchAttribute* at, int c,
                                        int clusters, size_t smem,
                                        cudaStream_t st) {
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = c;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * c);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of c CTAs of the rescue prologue the card holds at once with
// `smem` bytes of dynamic shared memory each (the occupancy calculator;
// 0 on an error), asked once per (device, c, smem) for the first
// RESCUE_KEYS of them (the splits of ten shapes), then at every call
static int rescue_clusters(int c, size_t smem) {
  static int key_dev[RESCUE_KEYS], key_c[RESCUE_KEYS], known[RESCUE_KEYS];
  static size_t key_smem[RESCUE_KEYS];
  static int used = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  for (int t = 0; t < used; ++t)
    if (key_dev[t] == dev && key_c[t] == c && key_smem[t] == smem)
      return known[t];
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = rescue_config(&at, c, 1, smem, nullptr);
  int k = 0;
  if (cudaOccupancyMaxActiveClusters(
          &k, reinterpret_cast<const void*>(admm_rescue_prologue), &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (used < RESCUE_KEYS) {
    key_dev[used] = dev;
    key_c[used] = c;
    key_smem[used] = smem;
    known[used] = k;
    ++used;
  }
  return k;
}

// the rescue prologue's plan at (n, m) into out[1 + 2 RESCUE_TIERS]: the
// dynamic shared memory of a CTA (bytes), then for each cluster launch its
// split c (rescue_split(n), halved while at least 2) and the most rescued
// lanes hi it takes, one a cluster, all at once (the clusters of c the
// card holds); each takes F in (the last launch's hi, hi], and one CTA a
// lane takes more (pairs of zeros past the launches)
extern "C" int rl_rescue_plan(int n, int m, long long* out) {
  const size_t pro = prologue_smem(n, m);
  int e = set_smem(reinterpret_cast<const void*>(admm_rescue_prologue), pro);
  if (e) return e;
  out[0] = (long long)pro;
  int t = 0, lo = 0;
  for (int c = rescue_split(n); c >= 2 && t < RESCUE_TIERS; c /= 2) {
    const int hi = rescue_clusters(c, pro);
    if (hi <= lo) continue;
    out[1 + 2 * t] = c;
    out[2 + 2 * t] = hi;
    lo = hi;
    ++t;
  }
  for (; t < RESCUE_TIERS; ++t) out[1 + 2 * t] = out[2 + 2 * t] = 0;
  return 0;
}

// rows [out[0], out[1]) of CTA `rank` of a lane's c CTAs at n
extern "C" void rl_rescue_band(int n, int c, int rank, int* out) {
  rescue_band(n, c, rank, out, out + 1);
}

extern "C" int rl_admm_rescue(QPParams p, const float* P, const float* Kinv,
                              const float* A, const float* nvecs,
                              const float* vecs, const float* cinv,
                              const float* kpad, float* xo, float* zo,
                              float* yo, float* stats, int* flags, float* ws,
                              int* count, int layout, int B, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long plan[1 + 2 * RESCUE_TIERS];
  int e = rl_rescue_plan(p.n, p.m, plan);
  if (e) return e;
  const size_t pro = (size_t)plan[0];
  int lo = 0;
  for (int t = 0; t < RESCUE_TIERS && plan[1 + 2 * t] > 0; ++t) {
    // a cluster a rescued lane
    const int c = (int)plan[1 + 2 * t], hi = (int)plan[2 + 2 * t];
    cudaLaunchAttribute at;
    const cudaLaunchConfig_t cfg =
        rescue_config(&at, c, hi < B ? hi : B, pro, st);
    e = static_cast<int>(cudaLaunchKernelEx(&cfg, admm_rescue_prologue, p, P,
                                            Kinv, A, vecs, kpad,
                                            (const int*)flags, ws, count, B,
                                            lo, hi));
    if (e) return e;
    lo = hi;
    if (lo >= B) break;
  }
  if (lo < B)
    admm_rescue_prologue<<<B, NT, pro, st>>>(p, P, Kinv, A, vecs, kpad, flags,
                                             ws, count, B, lo, INT_MAX);
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
// the rescue prologue's clocks into host[FPH_N]; reset: zero them
extern "C" int rl_rescue_phases(long long* host, int reset) {
  if (reset) {
    const long long zero[FPH_N] = {0};
    return static_cast<int>(
        cudaMemcpyToSymbol(rescue_phase, zero, sizeof(zero)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, rescue_phase, FPH_N * sizeof(long long)));
}

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
