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
// every product must keep its fmaf chain, see below). The prologue is
// compute-bound; what held it far from that bound was the issue of its
// operands: on the streamed core below, whose producers copy both
// operands of every product from L2 by 4-byte cp.async, a cell thread
// spent 87% of a product in its multiply loop at ~28% of the FMA issue
// rate while the producers issued all the time (admm_bench.py --phases).
// Two launches, one CTA of 512 threads per scenario in each, so that each
// scenario exits its own Newton-Schulz loop and its own ADMM loop:
//   - the prologue (admm_fused_prologue below, one CTA an SM by shared
//     memory and registers: a batch of 256 runs in two waves of 132). Its
//     K build is qp_common.cuh:product (OP_K) into a per-scenario global
//     workspace. Its Newton-Schulz products take one of two cores, by n
//     alone (fused_resident):
//       * n <= 152, the resident core (rc_* below, B4's alone): X and R
//         live in shared memory for the whole prologue (2 x 88.8 kB at
//         n = 146), so that R = I - K X writes R there and X + X R reads
//         both there and writes X in place (its outputs wait in registers
//         for one barrier). K, the left operand of every R = I - K X and
//         fixed for the prologue, is re-laid once into 16-column slabs in
//         the workspace and streams from L2 by one bulk copy a slab
//         (cp.async.bulk, completing on a full mbarrier) through two
//         buffers, issued by one thread of the last warp once every warp
//         holding cells has arrived on the buffer's empty mbarrier: no
//         CTA barrier between slabs, and the stream runs on from one
//         residual product into the next, so a slab's copy hides behind
//         the product before it. The warps multiply 6 x 8 output cells,
//         ceil(n/6) x ceil(n/8) threads (475 at n = 146: 15 warps), each
//         reading 4 k-values of a row of the left operand as one float4
//         and two float4 of each right-operand row, 192 FMAs per 14
//         shared loads; at n = 146 a product's multiply loop runs at ~63%
//         of the FMA issue rate (15 warps on 4 schedulers: 192 issue
//         cycles per k at best). 152 is the largest n whose cells fit 512
//         threads (the layout then fits shared memory too);
//       * larger n, the streamed core (qp_common.cuh:product, shared with
//         B1's rescue): K, X, Y and R in the workspace (4 n^2 floats:
//         at n = 200, 160 KB each), the whole n x n output in registers as
//         8 x 8 cells, the two operands staged through shared memory in
//         16-deep slabs by cp.async from the warps that hold no cells (the
//         left operand 4 bytes a copy, the right 16 or 8 where n and its
//         alignment allow), double buffered with one barrier a slab.
//     Every output of either core is one fmaf chain over k = 0..kd-1 in
//     order (padded k terms are fmaf(0, 0, acc); the resident core adds
//     the one such term the streamed core's 16-deep padding implies), as
//     in the first port's 64 x 64-tiled GEMM, and the epilogues are its
//     operations pinned with __fmaf_rn / __fadd_rn / __fsub_rn: the
//     refreshed inverse, the Newton-Schulz counts and the warm decisions
//     keep their bits on both cores;
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

// ---------------------------------------------------------------------------
// the resident core (B4's Newton-Schulz products at n <= 152)
// ---------------------------------------------------------------------------
#define RM 6        // rows of an output cell (its 8 columns: two groups of 4)
#define SK 16       // columns of K in a streamed slab
#define SKP 20      // a slab row's pitch in floats
#define NSTAGE 2    // slab buffers (their mbarriers: the 8 floats below)
static_assert(NSTAGE == 2, "the layout's head holds four mbarriers");

// The resident core's geometry at n. Thread t < cr cc holds the cell
// (ci, cj) = (t / cc, t % cc): rows 6 ci .. 6 ci + 5 and columns 4 cj ..
// 4 cj + 3 and 4 cc + 4 cj .. 4 cc + 4 cj + 3. X and R hold `rows` rows of
// pitch ld, their rows and columns past n zero. ld / 4 is odd, so the
// float4 reads of the 2-3 row cells of a warp (6 rows apart) fall on
// distinct banks, as do a slab's (6 SKP = 24 mod 32).
struct RGeo {
  int cc, cr;   // column cells ceil(n / 8), row cells ceil(n / 6)
  int rows;     // rows of X, R and a slab buffer: 6 cr, and at least the
                // k-rows a product reads (n rounded up to 4)
  int ld;       // row pitch of X and R
  int nslab;    // slabs of K: ceil(n / SK)
};

static __host__ __device__ inline RGeo rgeo(int n) {
  RGeo g;
  g.cc = (n + 7) / 8;
  g.cr = (n + RM - 1) / RM;
  g.rows = RM * g.cr > r4(n) ? RM * g.cr : r4(n);
  g.ld = r4(n) + ((r4(n) / 4) % 2 == 0 ? 4 : 0);
  g.nslab = (n + SK - 1) / SK;
  return g;
}

// the core B4's Newton-Schulz products take at n: the resident core where
// its cells fit the CTA's threads (n <= 152; its shared memory then fits
// too), else qp_common.cuh:product
static __host__ __device__ inline bool fused_resident(int n) {
  const RGeo g = rgeo(n);
  return g.cr * g.cc <= NT;
}

// floats of X or R (8 past the last row: the column cells past ld of the
// last row read there)
static __host__ __device__ inline size_t res_mat_floats(int n) {
  const RGeo g = rgeo(n);
  return (size_t)g.rows * g.ld + 8;
}

// dynamic shared memory of the resident prologue (bytes), in order: the
// slab buffers' mbarriers (8 floats), the reductions' scratch (32), the
// Jacobi diagonal, then X, R and the slab buffers, over which the K build
// first lays its context and product slabs
static __host__ __device__ inline size_t res_smem(int n, int m) {
  const RGeo g = rgeo(n);
  const Geo k = geo(n);
  const size_t kbuild =
      ctx_floats(n, m) + (size_t)2 * PK * (k.sa + 8 * k.cells);
  const size_t mats = 2 * res_mat_floats(n) + (size_t)NSTAGE * g.rows * SKP;
  return 4 * (8 + 32 + r4(n) + (kbuild > mats ? kbuild : mats));
}

// floats of a scenario's global workspace: the streamed core's K, X, Y and
// R (4 n^2, as B1's rescue takes it after), or the resident core's K and
// its slabs where that is more
static __host__ __device__ inline size_t fused_ws_floats(int n) {
  const size_t nn = (size_t)n * n;
  const size_t res = ((nn + 3) & ~(size_t)3) + (size_t)rgeo(n).nslab * n * SKP;
  return res > 4 * nn ? res : 4 * nn;
}

// the thread that issues the slab stream's copies: in the last warp, which
// holds no cells up to n = 150
#define ISSUER (NT - 1)

// the stream's j-th copy (thread ISSUER): slab j % nslab of K into buffer
// j % NSTAGE, completing on that buffer's mbarrier
static __device__ void rc_issue(int n, const RGeo& g, const float* Ks,
                                float* kbuf, uint64_t* full, unsigned j) {
  const unsigned buf = j % NSTAGE;
  const uint32_t bytes = (uint32_t)n * SKP * 4;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(full + buf, bytes);
  bulk_load(kbuf + (size_t)buf * g.rows * SKP,
            Ks + (size_t)(j % g.nslab) * n * SKP, bytes, full + buf);
}

// acc[r][q] = fmaf(a(r, k), b(k, q), acc[r][q]) over 4 ng k-values in
// order: a(r, k) = a[r lda + k], a row's 4 k-values one float4; b(k, q) =
// b[k ldb + q] for q < 4, b[k ldb + c2 + q - 4] past
static __device__ __forceinline__ void rc_mac(float (&acc)[RM][8],
                                              const float* a, int lda,
                                              const float* b, int ldb,
                                              int c2, int ng) {
#pragma unroll 1
  for (int gk = 0; gk < ng; ++gk) {
    float4 av[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) av[r] = ld4(a + r * lda);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = ld4(b + kk * ldb), b1 = ld4(b + kk * ldb + c2);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float ar = kk == 0   ? av[r].x
                         : kk == 1 ? av[r].y
                         : kk == 2 ? av[r].z
                                   : av[r].w;
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(ar, bv[q], acc[r][q]);
      }
    }
    a += 4;
    b += 4 * ldb;
  }
}

// the streamed core pads k to a multiple of PK with zero terms: one
// fmaf(0, 0, acc) has their effect (a -0 sum turns +0)
static __device__ __forceinline__ void rc_pad(float (&acc)[RM][8], int kd) {
  if (kd % PK == 0) return;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(0.f, 0.f, acc[r][q]);
}

// v, opaque to the compiler: an epilogue's indices are computed after the
// k-loop, not hoisted into it (held across it, their 48 selects spilled)
static __device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// first column of half h of cell column cj (4 columns each)
static __device__ __forceinline__ int rc_col(const RGeo& g, int cj, int h) {
  return 4 * (h ? g.cc + cj : cj);
}

// R = I - K X over the n x n outputs, K from the slab stream (seq: the
// stream's next copy, block-uniform), X and R in shared memory; returns
// max|R| (block-uniform). A buffer's full barrier completes when its slab
// has landed, its empty barrier when every warp holding cells has read it;
// then the issuer refills it, and no CTA barrier stands between slabs.
static __device__ float rc_resid(int n, const RGeo& g, const float* Ks,
                                 float* kbuf, uint64_t* bars, unsigned& seq,
                                 const float* X, float* R, float* red,
                                 long long* clk) {
  const int tid = threadIdx.x, ci = tid / g.cc, cj = tid % g.cc;
  const bool act = ci < g.cr, cells = tid / 32 < (g.cr * g.cc + 31) / 32;
  uint64_t *full = bars, *empty = bars + NSTAGE;
  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  TSTART
  for (int s = 0; s < g.nslab; ++s, ++seq) {
    const unsigned buf = seq % NSTAGE, par = (seq / NSTAGE) & 1;
    mbar_wait(full + buf, par);
    TMARK(clk, FPH_C_WAIT, tid == 0)
    if (act)
      rc_mac(acc, kbuf + ((size_t)buf * g.rows + RM * ci) * SKP, SKP,
             X + (size_t)s * SK * g.ld + 4 * cj, g.ld, 4 * g.cc,
             min(SK, n - s * SK + 3) / 4);
    TMARK(clk, FPH_C_MATH, tid == 0)
    if (cells) {
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty + buf, 0);
    }
    if (tid == ISSUER) {
      mbar_wait(empty + buf, par);
      TMARK(clk, FPH_P_WAIT, true)
      rc_issue(n, g, Ks, kbuf, full, seq + NSTAGE);
      TMARK(clk, FPH_P_ISSUE, true)
    }
  }
  float mx = 0.f;
  if (act) {
    rc_pad(acc, n);
    const int i0 = RM * opaque(ci), c = opaque(cj);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = i0 + r;
      if (i >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = rc_col(g, c, h);
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = __fsub_rn(i == j + q ? 1.f : 0.f, acc[r][4 * h + q]);
          if (j + q < n) mx = nanmax(mx, fabsf(v[q]));
        }
        float* o = R + (size_t)i * g.ld + j;
        if (j + 3 < n) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (j + q < n) o[q] = v[q];
        }
      }
    }
  }
  float unused = 0.f;
  block_maxsum(mx, unused, red);
  TMARK(clk, FPH_C_EPI, tid == 0)
  return mx;
}

// X = X + X R in place (X, R in shared memory): the outputs wait in
// registers until every cell has read X
static __device__ void rc_update(int n, const RGeo& g, float* X,
                                 const float* R, long long* clk) {
  const int tid = threadIdx.x, ci = tid / g.cc, cj = tid % g.cc;
  const bool act = ci < g.cr;
  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  TSTART
  if (act) {
    rc_mac(acc, X + (size_t)RM * ci * g.ld, g.ld, R + 4 * cj, g.ld,
           4 * g.cc, (n + 3) / 4);
    rc_pad(acc, n);
  }
  TMARK(clk, FPH_C_MATH, tid == 0)
  const int i0 = RM * opaque(ci), c = opaque(cj);
  if (act) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = i0 + r;
      if (i >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = rc_col(g, c, h);
        const float* x = X + (size_t)i * g.ld + j;
        if (j + 3 < n) {
          const float4 e = ld4(x);
          acc[r][4 * h] = __fadd_rn(e.x, acc[r][4 * h]);
          acc[r][4 * h + 1] = __fadd_rn(e.y, acc[r][4 * h + 1]);
          acc[r][4 * h + 2] = __fadd_rn(e.z, acc[r][4 * h + 2]);
          acc[r][4 * h + 3] = __fadd_rn(e.w, acc[r][4 * h + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (j + q < n)
              acc[r][4 * h + q] = __fadd_rn(x[q], acc[r][4 * h + q]);
        }
      }
    }
  }
  __syncthreads();   // every cell has read X
  if (act) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = i0 + r;
      if (i >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = rc_col(g, c, h);
        float* x = X + (size_t)i * g.ld + j;
        if (j + 3 < n) {
          *reinterpret_cast<float4*>(x) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                          acc[r][4 * h + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (j + q < n) x[q] = acc[r][4 * h + q];
        }
      }
    }
  }
  __syncthreads();
  TMARK(clk, FPH_C_EPI, tid == 0)
}

// X = Jacobi init diag(dg) / max(cj, 1) at pitch ld
static __device__ void rc_jacobi(int n, int ld, const float* dg, float cjm,
                                 float* X) {
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int i = e / n, j = e % n;
    X[(size_t)i * ld + j] = i == j ? dg[i] / cjm : 0.f;
  }
  __syncthreads();
}

// qp_common.cuh:ns_run on the resident core: Newton-Schulz passes
// X <- X + X (I - K X) from r = inf while r > tol and it < max, the
// 128-pad block the scalar xp. Returns the last residual and the
// iterations in *iters.
static __device__ float rc_ns_run(const QPParams& p, int n, const RGeo& g,
                                  const float* Ks, float* kbuf,
                                  uint64_t* bars, unsigned& seq, float* X,
                                  float* R, float& xp, float* red,
                                  int* iters, long long* clk) {
  float r = INFINITY;
  int it = 0;
  TSTART
  while (r > p.ns_tol && it < p.ns_max_iters) {
    float mx = rc_resid(n, g, Ks, kbuf, bars, seq, X, R, red, clk);
    TMARK(clk, FPH_NS_RESID, threadIdx.x == 0)
    if (p.n_pad) mx = nanmax(mx, fabsf(1.f - xp));
    rc_update(n, g, X, R, clk);
    TMARK(clk, FPH_NS_UPDATE, threadIdx.x == 0)
    r = mx;
    xp = xp + xp * (1.f - xp);
    ++it;
  }
  *iters = it;
  return r;
}

// The prologue on the resident core: the K build into the workspace (K,
// then its slabs), the Jacobi start, the warm test and both passes, X in
// shared memory throughout.
static __device__ void prologue_resident(
    const QPParams& p, const float* P_, const float* A_, const float* kinv0_,
    const int* warm_ok, const float* vecs, float* kinv_out, float* ns_out,
    float* kpad_out, int* ns_info, float* ws) {
  const int b = blockIdx.x, n = p.n, m = p.m, tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  float* sm = reinterpret_cast<float*>(dyn_smem());
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);   // full, then empty
  float* red = sm + 8;
  float* dg = red + 32;
  float* K = ws + (size_t)b * fused_ws_floats(n);
  if (tid == 0) {
    const RGeo g = rgeo(n);
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(bars + i);
      mbar_init(bars + NSTAGE + i, (g.cr * g.cc + 31) / 32);
    }
  }
  long long* clk = FUSED_CLK;
  TSTART

  // K = A'(rho A) + P + sigma I and its Jacobi init, the K build's context
  // and slabs over X, R and the slab buffers
  float cjm;
  {
    Ctx c = carve(dg + r4(n), n, m);
    const float* rho = vecs + (size_t)b * 5 * m + 2 * m;   // pack_vectors
    for (int i = tid; i < m; i += NT) c.rho[i] = rho[i];
    __syncthreads();
    cjm = k_jacobi(p, c, P_ + (size_t)b * nn, A_ + (size_t)b * m * n, 1.f,
                   K, dg, dg + r4(n) + ctx_floats(n, m), clk);
  }

  // K's slabs, each 16 columns of every row (zero past n) at pitch SKP,
  // for the bulk copies (after a proxy fence); X and R zeroed
  const RGeo g = rgeo(n);
  float* X = dg + r4(n);
  float* R = X + res_mat_floats(n);
  float* kbuf = R + res_mat_floats(n);
  float* Ks = K + ((nn + 3) & ~(size_t)3);
  for (int e = tid; e < g.nslab * n; e += NT) {   // slab s, row i
    const int s = e / n, i = e - s * n, k0 = s * SK;
    const float* src = K + (size_t)i * n + k0;
    float v[SK];
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) v[kk] = k0 + kk < n ? src[kk] : 0.f;
    float4* dst = reinterpret_cast<float4*>(Ks + (size_t)e * SKP);
#pragma unroll
    for (int q = 0; q < SK / 4; ++q)
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  for (size_t e = tid; e < res_mat_floats(n) / 2; e += NT)   // X and R
    reinterpret_cast<float4*>(X)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  unsigned seq = 0;   // the slab stream's next copy to consume
  if (tid == ISSUER)
    for (unsigned j = 0; j < NSTAGE; ++j) rc_issue(n, g, Ks, kbuf, bars, j);
  TMARK(clk, FPH_KBUILD, tid == 0)

  bool use_warm = false;
  if (warm_ok[b]) {
    const float* X0 = kinv0_ + (size_t)b * nn;
    for (int e = tid; e < n * n; e += NT)
      X[(size_t)(e / n) * g.ld + e % n] = X0[e];
    __syncthreads();
    rc_resid(n, g, Ks, kbuf, bars, seq, X, R, red, clk);
    const float r0f = sqrtf(frob_sq(n, R, red, g.ld));
    use_warm = isfinite(r0f) && r0f < 0.9f;
  }
  if (!use_warm) rc_jacobi(n, g.ld, dg, cjm, X);
  TMARK(clk, FPH_WARM, tid == 0)
  // the Jacobi path's pad scalar 1 / cjm, computed where it is taken
  float xp = use_warm ? 1.f : 1.f / cjm;
  int it1 = 0, it2 = 0;
  const float r1 = rc_ns_run(p, n, g, Ks, kbuf, bars, seq, X, R, xp, red,
                             &it1, clk);
  if (!isfinite(r1) || r1 > 50.f * p.ns_tol) {
    rc_jacobi(n, g.ld, dg, cjm, X);
    xp = 1.f / cjm;
  }
  const float ns_resid = rc_ns_run(p, n, g, Ks, kbuf, bars, seq, X, R, xp,
                                   red, &it2, clk);
  TMARK(clk, FPH_NS, tid == 0)

  float* ko = kinv_out + (size_t)b * nn;
  for (int e = tid; e < n * n; e += NT)
    ko[e] = X[(size_t)(e / n) * g.ld + e % n];
  if (tid == 0) {
    ns_out[b] = ns_resid;
    kpad_out[b] = xp;
    ns_info[b * 2 + 0] = use_warm ? 1 : 0;
    ns_info[b * 2 + 1] = it1 + it2;
  }
  // the stream's copies still in flight land before the CTA leaves
  if (tid == ISSUER)
    for (unsigned j = seq; j < seq + NSTAGE; ++j)
      mbar_wait(bars + j % NSTAGE, (j / NSTAGE) & 1);
}

// The prologue on the streamed core (qp_common.cuh:product), K, X, Y and R
// in the workspace.
static __device__ void prologue_streamed(
    const QPParams& p, const float* P_, const float* A_, const float* kinv0_,
    const int* warm_ok, const float* vecs, float* kinv_out, float* ns_out,
    float* kpad_out, int* ns_info, float* ws) {
  const int b = blockIdx.x, n = p.n, m = p.m, tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const float* P = P_ + (size_t)b * nn;
  const float* A = A_ + (size_t)b * m * n;
  float* ctxp = reinterpret_cast<float*>(dyn_smem());
  Ctx c = carve(ctxp, n, m);
  float* stage = ctxp + ctx_floats(n, m);   // the slabs, then the diagonal
  float* dg = stage + 2 * PK * (geo(n).sa + 8 * geo(n).cells);
  float* K = ws + (size_t)b * fused_ws_floats(n);
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

// One CTA per SM by shared memory and registers: the batch runs in waves
// of 132. The core of the Newton-Schulz products follows n alone.
template <bool RES>
__global__ void __launch_bounds__(NT, 1)
admm_fused_prologue(const QPParams p, const float* P, const float* A,
                    const float* kinv0, const int* warm_ok,
                    const float* vecs, float* kinv_out, float* ns_out,
                    float* kpad_out, int* ns_info, float* ws) {
  if constexpr (RES)
    prologue_resident(p, P, A, kinv0, warm_ok, vecs, kinv_out, ns_out,
                      kpad_out, ns_info, ws);
  else
    prologue_streamed(p, P, A, kinv0, warm_ok, vecs, kinv_out, ns_out,
                      kpad_out, ns_info, ws);
}

static const void* prologue_fn(int n) {
  return fused_resident(n)
             ? reinterpret_cast<const void*>(admm_fused_prologue<true>)
             : reinterpret_cast<const void*>(admm_fused_prologue<false>);
}

static size_t fused_smem(int n, int m) {
  return fused_resident(n) ? res_smem(n, m) : prologue_smem(n, m);
}

// dynamic shared memory of the prologue launch
extern "C" long long rl_fused_smem_bytes(int n, int m) {
  return (long long)fused_smem(n, m);
}

// 1 where the prologue's Newton-Schulz products take the resident core
extern "C" int rl_fused_resident(int n) { return fused_resident(n) ? 1 : 0; }

// floats of a scenario's workspace
extern "C" long long rl_fused_ws_floats(int n) {
  return (long long)fused_ws_floats(n);
}

// CTAs per SM the card runs of the prologue kernel (the occupancy
// calculator: shared memory, registers and threads); < 0 on an error
extern "C" int rl_fused_ctas_per_sm(int n, int m) {
  const size_t smem = fused_smem(n, m);
  const void* fn = prologue_fn(n);
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
// iteration precision prec; ws: rl_fused_ws_floats(n) floats a scenario
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
  const size_t smem = fused_smem(p.n, p.m);
  int e = set_smem(prologue_fn(p.n), smem);
  if (e) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fused_resident(p.n))
    admm_fused_prologue<true><<<B, NT, smem, st>>>(
        p, P, A, kinv0, warm_ok, vecs, kinv_out, ns_out, kpad_out, ns_info,
        ws);
  else
    admm_fused_prologue<false><<<B, NT, smem, st>>>(
        p, P, A, kinv0, warm_ok, vecs, kinv_out, ns_out, kpad_out, ns_info,
        ws);
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
