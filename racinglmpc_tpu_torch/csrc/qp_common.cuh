// Device functions shared by the ADMM kernels B1 (cuda_qp.cu) and B4
// (cuda_qp_fused.cu): the per-scenario CTA context in shared memory, the
// streamed matrix-vector products, one ADMM iteration, the residual check,
// the check_every chunks, the main ADMM loop of one scenario, the in-CTA
// tiled float32 GEMM and the Newton-Schulz passes over a global workspace.
// "v.M" products contract M's rows (v @ M, as the Pallas kernels' row
// vectors do); "M v" products contract its columns.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

struct QPParams {
  int n, m, max_iter, check_every, refine_steps, rescue_max_iter,
      ns_max_iters, n_pad;
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel, rescue_rho_scale,
      rescue_trigger, rescue_exit, ns_tol;
};

#define NT 512          // threads per CTA
#define GSPLIT 2        // row groups of the v.M products (NT / 256)
#define TILE 64
#define TK 16

static __device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

static __device__ __forceinline__ float clipf(float v, float lo, float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

struct Ctx {
  float *q, *D, *x, *xt, *rhs, *tn1, *tn2;
  float *l, *u, *rho, *rinv, *Einv, *z, *y, *tm1;
  float *part, *red;
};

static __device__ Ctx carve(float* sm, int n, int m) {
  Ctx c;
  c.q = sm; sm += n;  c.D = sm; sm += n;  c.x = sm; sm += n;
  c.xt = sm; sm += n; c.rhs = sm; sm += n; c.tn1 = sm; sm += n;
  c.tn2 = sm; sm += n;
  c.l = sm; sm += m;  c.u = sm; sm += m;  c.rho = sm; sm += m;
  c.rinv = sm; sm += m; c.Einv = sm; sm += m; c.z = sm; sm += m;
  c.y = sm; sm += m;  c.tm1 = sm; sm += m;
  c.part = sm; sm += NT;
  c.red = sm;
  return c;
}

static __host__ __device__ inline size_t ctx_floats(int n, int m) {
  return (size_t)7 * n + 8 * m + NT + 4 * (NT / 32);
}

// shared memory of a kernel that also runs block_gemm: the context, the
// two GEMM tiles and one n-vector (the Jacobi diagonal)
static __host__ __device__ inline size_t gemm_ctx_floats(int n, int m) {
  return ctx_floats(n, m) + 2 * TILE * TK + n;
}

// out[j] = sum_i v[i] M[i*C + j]   (v.M, C <= any; rows split in GSPLIT)
static __device__ void vecmat(const float* v, const float* M, int R, int C,
                              float* out, float* part) {
  const int g = threadIdx.x / 256, jl = threadIdx.x % 256;
  const int i0 = (R * g) / GSPLIT, i1 = (R * (g + 1)) / GSPLIT;
  for (int j0 = 0; j0 < C; j0 += 256) {
    const int j = j0 + jl;
    float acc = 0.f;
    if (j < C) {
      const float* col = M + j;
#pragma unroll 8
      for (int i = i0; i < i1; ++i) acc = fmaf(v[i], col[(size_t)i * C], acc);
    }
    part[g * 256 + jl] = acc;
    __syncthreads();
    if (g == 0 && j < C) {
      float s = part[jl];
      for (int gg = 1; gg < GSPLIT; ++gg) s += part[gg * 256 + jl];
      out[j] = s;
    }
    __syncthreads();
  }
}

// out[i] = sum_j M[i*C + j] v[j]   (M v: one warp per row)
static __device__ void matvec(const float* M, const float* v, int R, int C,
                              float* out) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = w; i < R; i += NT / 32) {
    const float* row = M + (size_t)i * C;
    float acc = 0.f;
    for (int j = lane; j < C; j += 32) acc = fmaf(row[j], v[j], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[i] = acc;
  }
  __syncthreads();
}

// block-wide max of 4 values (NaN-propagating); result in every thread
static __device__ void block_max4(float v[4], float* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = nanmax(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  if (lane == 0)
    for (int k = 0; k < 4; ++k) red[w * 4 + k] = v[k];
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    float a = red[k];
    for (int i = 1; i < NT / 32; ++i) a = nanmax(a, red[i * 4 + k]);
    v[k] = a;
  }
  __syncthreads();
}

// block-wide (max, sum) of one value; result in every thread
static __device__ void block_maxsum(float& mx, float& sm, float* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    sm += __shfl_xor_sync(0xffffffffu, sm, off);
  }
  if (lane == 0) { red[w * 2] = mx; red[w * 2 + 1] = sm; }
  __syncthreads();
  float a = red[0], s = red[1];
  for (int i = 1; i < NT / 32; ++i) { a = nanmax(a, red[2 * i]); s += red[2 * i + 1]; }
  mx = a;
  sm = s;
  __syncthreads();
}

static __device__ void load_vectors(const QPParams& p, Ctx& c, const float* nv,
                                    const float* vv) {
  const int n = p.n, m = p.m;
  for (int i = threadIdx.x; i < n; i += NT) { c.q[i] = nv[i]; c.D[i] = nv[n + i]; }
  for (int i = threadIdx.x; i < m; i += NT) {
    c.l[i] = vv[i];
    c.u[i] = vv[m + i];
    c.rho[i] = vv[2 * m + i];
    c.rinv[i] = vv[3 * m + i];
    c.Einv[i] = vv[4 * m + i];
  }
}

static __device__ void one_iter(const QPParams& p, Ctx& c, const float* P,
                                const float* A, const float* Kinv) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  for (int i = tid; i < m; i += NT) c.tm1[i] = c.rho[i] * c.z[i] - c.y[i];
  __syncthreads();
  vecmat(c.tm1, A, m, n, c.tn1, c.part);
  for (int j = tid; j < n; j += NT) c.rhs[j] = p.sigma * c.x[j] - c.q[j] + c.tn1[j];
  __syncthreads();
  vecmat(c.rhs, Kinv, n, n, c.xt, c.part);
  for (int r = 0; r < p.refine_steps; ++r) {
    matvec(A, c.xt, m, n, c.tm1);
    for (int i = tid; i < m; i += NT) c.tm1[i] *= c.rho[i];
    __syncthreads();
    vecmat(c.xt, P, n, n, c.tn1, c.part);
    vecmat(c.tm1, A, m, n, c.tn2, c.part);
    for (int j = tid; j < n; j += NT)
      c.tn1[j] = c.rhs[j] - ((c.tn1[j] + p.sigma * c.xt[j]) + c.tn2[j]);
    __syncthreads();
    vecmat(c.tn1, Kinv, n, n, c.tn2, c.part);
    for (int j = tid; j < n; j += NT) c.xt[j] += c.tn2[j];
    __syncthreads();
  }
  matvec(A, c.xt, m, n, c.tm1);
  for (int j = tid; j < n; j += NT)
    c.x[j] = p.alpha * c.xt[j] + p.one_m_alpha * c.x[j];
  for (int i = tid; i < m; i += NT) {
    const float zrel = p.alpha * c.tm1[i] + p.one_m_alpha * c.z[i];
    const float zn = clipf(zrel + c.y[i] * c.rinv[i], c.l[i], c.u[i]);
    c.y[i] = c.y[i] + c.rho[i] * (zrel - zn);
    c.z[i] = zn;
  }
  __syncthreads();
}

// unscaled primal / dual residuals and the tolerance test (block-uniform)
static __device__ bool residuals(const QPParams& p, Ctx& c, const float* P,
                                 const float* A, float c_inv, float& pri,
                                 float& dua) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  matvec(A, c.x, m, n, c.tm1);
  vecmat(c.x, P, n, n, c.tn1, c.part);
  vecmat(c.y, A, m, n, c.tn2, c.part);
  float v[4] = {0.f, 0.f, 0.f, 0.f};   // pri, pri_sc, dua, dua_sc
  for (int i = tid; i < m; i += NT) {
    const float ax = c.tm1[i], e = c.Einv[i];
    const float zc = clipf(ax, c.l[i], c.u[i]);
    v[0] = nanmax(v[0], fabsf((ax - zc) * e));
    v[1] = nanmax(v[1], nanmax(fabsf(ax * e), fabsf(zc * e)));
  }
  for (int j = tid; j < n; j += NT) {
    const float px = c.tn1[j], aty = c.tn2[j], d = c.D[j], q = c.q[j];
    v[2] = nanmax(v[2], fabsf((px + q + aty) * d));
    v[3] = nanmax(v[3], nanmax(nanmax(fabsf(px * d), fabsf(aty * d)),
                               fabsf(q * d)));
  }
  block_max4(v, c.red);
  pri = v[0];
  dua = v[2] * c_inv;
  const float pri_sc = v[1], dua_sc = v[3] * c_inv;
  return pri < p.eps_abs + p.eps_rel * pri_sc &&
         dua < p.eps_abs + p.eps_rel * dua_sc;
}

// chunks of check_every iterations until converged or budget iterations
// ran; returns the iteration count assigned on convergence (else unchanged)
static __device__ void run_chunks(const QPParams& p, Ctx& c, const float* P,
                                  const float* A, const float* Kinv,
                                  float c_inv, int budget, int it_base,
                                  float exit_pri, bool& done, int& iters,
                                  float& pri, float& dua) {
  const int ce = p.check_every;
  const int n_chunks = max((budget + ce - 1) / ce, 1);
  for (int k = 0; k < n_chunks && !done; ++k) {
    const int this_chunk = min(ce, budget - k * ce);
    for (int t = 0; t < this_chunk; ++t) one_iter(p, c, P, A, Kinv);
    bool ok = residuals(p, c, P, A, c_inv, pri, dua);
    ok = ok || pri < exit_pri;
    if (ok) {
      done = true;
      iters = it_base + min((k + 1) * ce, budget);
    }
  }
}

// The main ADMM loop of scenario b (vectors already in the context): the
// entry check, then run_chunks at fixed rho; writes x, z, y, (pri, dua)
// and (iters, done, needs-rescue).
static __device__ void admm_loop(const QPParams& p, Ctx& c, int b,
                                 const float* P, const float* A,
                                 const float* Kinv, float c_inv, float* xo,
                                 float* zo, float* yo, float* stats,
                                 int* flags) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  float pri, dua;
  bool done = residuals(p, c, P, A, c_inv, pri, dua);   // entry check
  int iters = done ? 0 : p.max_iter;
  run_chunks(p, c, P, A, Kinv, c_inv, p.max_iter, 0, -INFINITY, done, iters,
             pri, dua);
  for (int j = tid; j < n; j += NT) xo[(size_t)b * n + j] = c.x[j];
  for (int i = tid; i < m; i += NT) {
    zo[(size_t)b * m + i] = c.z[i];
    yo[(size_t)b * m + i] = c.y[i];
  }
  if (tid == 0) {
    stats[b * 2 + 0] = pri;
    stats[b * 2 + 1] = dua;
    flags[b * 3 + 0] = iters;
    flags[b * 3 + 1] = done ? 1 : 0;
    flags[b * 3 + 2] = (p.rescue_max_iter > 0 && pri > p.rescue_trigger) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// in-CTA tiled GEMM over n x n outputs
// ---------------------------------------------------------------------------
enum { EPI_K2 = 0, EPI_RESID = 1, EPI_UPDATE = 2 };

// C = epi(a . b), a(i,k) = transA ? A[k*lda+i] : A[i*lda+k],
// b(k,j) = Bm[k*n + j] * (bscale ? bscale[k] : 1), i, j < n, k < kd.
//   EPI_K2:     C = (acc * s + E1) + (i == j ? sigma : 0)     (E1 = P)
//   EPI_RESID:  C = (i == j) - acc; returns max|C|, sum C^2 (block-uniform)
//   EPI_UPDATE: C = E1 + acc                                  (E1 = X)
static __device__ void block_gemm(int n, int kd, const float* A, int lda,
                                  bool transA, const float* Bm,
                                  const float* bscale, float* C, int mode,
                                  const float* E1, float s, float sigma,
                                  float* As, float* Bs, float* red,
                                  float& out_max, float& out_sum) {
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;   // 2 rows x 4 cols per thread
  float mx = 0.f, sq = 0.f;
  for (int i0 = 0; i0 < n; i0 += TILE) {
    for (int j0 = 0; j0 < n; j0 += TILE) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < kd; k0 += TK) {
        for (int e = tid; e < TILE * TK; e += NT) {
          int ii, kk;
          if (transA) { kk = e / TILE; ii = e % TILE; }
          else { ii = e / TK; kk = e % TK; }
          const int i = i0 + ii, k = k0 + kk;
          float a = 0.f;
          if (i < n && k < kd)
            a = transA ? A[(size_t)k * lda + i] : A[(size_t)i * lda + k];
          As[kk * TILE + ii] = a;
          const int kb = k0 + e / TILE, jb = j0 + e % TILE;
          float bv = 0.f;
          if (kb < kd && jb < n) {
            bv = Bm[(size_t)kb * n + jb];
            if (bscale) bv *= bscale[kb];
          }
          Bs[e] = bv;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          const float a0 = As[kk * TILE + tr * 2], a1 = As[kk * TILE + tr * 2 + 1];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float bv = Bs[kk * TILE + tc * 4 + cc];
            acc[0][cc] = fmaf(a0, bv, acc[0][cc]);
            acc[1][cc] = fmaf(a1, bv, acc[1][cc]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = i0 + tr * 2 + r, j = j0 + tc * 4 + cc;
          if (i >= n || j >= n) continue;
          const size_t ij = (size_t)i * n + j;
          float val;
          if (mode == EPI_K2) {
            val = (acc[r][cc] * s + E1[ij]) + (i == j ? sigma : 0.f);
          } else if (mode == EPI_RESID) {
            val = (i == j ? 1.f : 0.f) - acc[r][cc];
            mx = nanmax(mx, fabsf(val));
            sq += val * val;
          } else {
            val = E1[ij] + acc[r][cc];
          }
          C[ij] = val;
        }
      }
    }
  }
  __syncthreads();
  if (mode == EPI_RESID) block_maxsum(mx, sq, red);
  out_max = mx;
  out_sum = sq;
}

// K = (A' (rho A)) s + P + sigma I, then the Jacobi diagonal
// dg = 1 / max(diag K, 1e-12); returns max(|I - K diag(dg)|_F, 1)
static __device__ float build_k_jacobi(const QPParams& p, Ctx& c,
                                       const float* P, const float* A,
                                       float s, float* K, float* dg,
                                       float* As, float* Bs) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  float mx, sq;
  block_gemm(n, m, A, n, true, A, c.rho, K, EPI_K2, P, s, p.sigma, As, Bs,
             c.red, mx, sq);
  for (int j = tid; j < n; j += NT) dg[j] = 1.f / fmaxf(K[(size_t)j * n + j], 1e-12f);
  __syncthreads();
  float sumsq = 0.f, dummy = 0.f;
  for (size_t e = tid; e < (size_t)n * n; e += NT) {
    const int i = (int)(e / n), j = (int)(e % n);
    const float v = (i == j ? 1.f : 0.f) - K[e] * dg[j];
    sumsq += v * v;
  }
  block_maxsum(dummy, sumsq, c.red);
  return fmaxf(sqrtf(sumsq), 1.f);
}

// X = Jacobi init diag(dg) / max(cj, 1)
static __device__ void write_jacobi(int n, const float* dg, float cjm,
                                    float* X) {
  for (size_t e = threadIdx.x; e < (size_t)n * n; e += NT) {
    const int i = (int)(e / n), j = (int)(e % n);
    X[e] = i == j ? dg[i] / cjm : 0.f;
  }
  __syncthreads();
}

// Newton-Schulz passes X <- X + X (I - K X) from r = inf while r > tol and
// it < max; the 128-pad block is the scalar xp. Returns the last residual
// (and the iteration count in *iters when given); X / Y are swapped so
// that *X holds the result.
static __device__ float ns_run(const QPParams& p, int n, const float* K2,
                               float*& X, float*& Y, float* R, float& xp,
                               float* As, float* Bs, float* red,
                               int* iters = nullptr) {
  float r = INFINITY;
  int it = 0;
  float mx, sq;
  while (r > p.ns_tol && it < p.ns_max_iters) {
    block_gemm(n, n, K2, n, false, X, nullptr, R, EPI_RESID, nullptr, 0.f,
               0.f, As, Bs, red, mx, sq);
    if (p.n_pad) mx = nanmax(mx, fabsf(1.f - xp));
    block_gemm(n, n, X, n, false, R, nullptr, Y, EPI_UPDATE, X, 0.f, 0.f, As,
               Bs, red, sq, sq);
    float* t = X; X = Y; Y = t;
    r = mx;
    xp = xp + xp * (1.f - xp);
    ++it;
  }
  if (iters) *iters = it;
  return r;
}

static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}
