// Device functions shared by the ADMM kernels B1 (cuda_qp.cu) and B4
// (cuda_qp_fused.cu): the per-scenario CTA context in shared memory, the two
// layouts of the ADMM core (resident: Kinv and the compressed A and P in
// shared memory; stream: Kinv, A and P read from global memory in every
// product), one ADMM iteration, the residual check, the check_every chunks,
// the main ADMM loop of one scenario, the in-CTA tiled float32 GEMM and the
// Newton-Schulz passes over a global workspace.
// "v.M" products contract M's rows (v @ M, as the Pallas kernels' row
// vectors do); "M v" products contract its columns.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

struct QPParams {
  int n, m, max_iter, check_every, refine_steps, rescue_max_iter,
      ns_max_iters, n_pad, nnz_cap;
  float sigma, alpha, one_m_alpha, eps_abs, eps_rel, rescue_rho_scale,
      rescue_trigger, rescue_exit, ns_tol;
};

#define NT 512          // threads per CTA
#define GSPLIT 2        // row groups of the v.M products (NT / 256)
#define TILE 64
#define TK 16
#define LONG_ROW 16     // a row of A with more entries takes a whole warp
#define LMAX 8          // long rows of A listed for warps
#define CU 8            // elements per thread per tile of the compaction
#define NFLAG 4         // flags per scenario: iters, done, needs-rescue,
                        // streamed
#define FULL 0xffffffffu

enum { LAYOUT_STREAM = 0, LAYOUT_RESIDENT = 1 };

// Phase clocks, compiled in only with -DQP_PHASES (runtime/admm_bench.py
// --phases): thread 0 of scenario 0 adds the SM cycles since its last mark
// to the phase's counter (this card has no kernel profiler).
enum { PH_VK, PH_AV, PH_VA, PH_VP_VA, PH_AV_UPDATE, PH_CHECK, PH_PROLOGUE,
       PH_WAIT, PH_N };
#ifdef QP_PHASES
static __device__ long long qp_phase[PH_N];
#define PHASE_START long long qp_t0_ = clock64();
#define PHASE(k)                                      \
  if (threadIdx.x == 0 && blockIdx.x == 0) {          \
    const long long t_ = clock64();                   \
    qp_phase[k] += t_ - qp_t0_;                       \
    qp_t0_ = t_;                                      \
  }
#else
#define PHASE_START
#define PHASE(k)
#endif

static __device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

static __device__ __forceinline__ float clipf(float v, float lo, float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

// the dynamic shared memory of every kernel of the translation unit
static __device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char qp_smem[];
  return qp_smem;
}

static __host__ __device__ inline int r4(int k) { return (k + 3) & ~3; }
static __host__ __device__ inline size_t r16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

struct Ctx {
  float *q, *D, *x, *xt, *rhs, *tn1, *tn2;
  float *l, *u, *rho, *rinv, *Einv, *z, *y, *tm1;
  float *part, *red;
};

// every vector starts on a 16-byte boundary (the resident v.Kinv reads v
// as float4)
static __device__ Ctx carve(float* sm, int n, int m) {
  const int n4 = r4(n), m4 = r4(m);
  Ctx c;
  c.q = sm; sm += n4;  c.D = sm; sm += n4;  c.x = sm; sm += n4;
  c.xt = sm; sm += n4; c.rhs = sm; sm += n4; c.tn1 = sm; sm += n4;
  c.tn2 = sm; sm += n4;
  c.l = sm; sm += m4;  c.u = sm; sm += m4;  c.rho = sm; sm += m4;
  c.rinv = sm; sm += m4; c.Einv = sm; sm += m4; c.z = sm; sm += m4;
  c.y = sm; sm += m4;  c.tm1 = sm; sm += m4;
  c.part = sm; sm += NT;
  c.red = sm;
  return c;
}

static __host__ __device__ inline size_t ctx_floats(int n, int m) {
  return (size_t)7 * r4(n) + 8 * r4(m) + NT + 4 * (NT / 32);
}

// shared memory of a streaming kernel that also runs block_gemm: the
// context, the two GEMM tiles and one n-vector (the Jacobi diagonal)
static __host__ __device__ inline size_t gemm_ctx_floats(int n, int m) {
  return ctx_floats(n, m) + 2 * TILE * TK + r4(n);
}

// ---------------------------------------------------------------------------
// the resident layout: byte offsets in the dynamic shared memory
//   [mbarrier, long-row list (80 B) | context | Kinv slot |
//    pool values | CSC values | pool rows | pool cols | CSC rows |
//    A row ptr | A col ptr | P col ptr]
// The Kinv slot holds n*n floats plus 4 of slack (the copy keeps the
// source's alignment mod 16 bytes); in the rescue and in B4 it holds the
// GEMM tiles and the Jacobi diagonal until the inverse is copied in. The
// pool takes the nonzeros of A then P in row-major order (it is A's CSR);
// the CSC arrays hold A's columns then P's. ops/cuda_qp.py:smem_plan
// mirrors this count.
// ---------------------------------------------------------------------------
struct Resident {
  size_t ctx, slot, pv, cv, pr, pc, ci, arp, acp, pcp, total;
};

static __host__ __device__ inline size_t slot_floats(int n) {
  const size_t a = (size_t)n * n + 4, b = (size_t)2 * TILE * TK + r4(n);
  return (size_t)r4((int)(a > b ? a : b));
}

static __host__ __device__ inline Resident resident_layout(int n, int m,
                                                           int cap) {
  Resident L;
  L.ctx = 80;
  L.slot = L.ctx + 4 * ctx_floats(n, m);
  L.pv = L.slot + 4 * slot_floats(n);
  L.cv = L.pv + (size_t)4 * cap;
  L.pr = L.cv + (size_t)4 * cap;
  L.pc = L.pr + (size_t)2 * cap;
  L.ci = L.pc + (size_t)2 * cap;
  L.arp = L.ci + (size_t)2 * cap;
  L.acp = L.arp + (size_t)2 * (m + 1);
  L.pcp = L.acp + (size_t)2 * (n + 1);
  L.total = L.pv + r16((size_t)14 * cap + 2 * (m + 1 + 2 * (n + 1)));
  return L;
}

struct Sparse {
  float *pv, *cv;
  short *pr, *pc, *ci, *arp, *acp, *pcp;
  int* nlong;    // long rows of A listed (0: none, or more than LMAX)
  short* lng;    // ... their indices
};

static __device__ Sparse carve_sparse(unsigned char* smb, const Resident& L) {
  Sparse s;
  s.nlong = reinterpret_cast<int*>(smb + 16);
  s.lng = reinterpret_cast<short*>(smb + 32);
  s.pv = reinterpret_cast<float*>(smb + L.pv);
  s.cv = reinterpret_cast<float*>(smb + L.cv);
  s.pr = reinterpret_cast<short*>(smb + L.pr);
  s.pc = reinterpret_cast<short*>(smb + L.pc);
  s.ci = reinterpret_cast<short*>(smb + L.ci);
  s.arp = reinterpret_cast<short*>(smb + L.arp);
  s.acp = reinterpret_cast<short*>(smb + L.acp);
  s.pcp = reinterpret_cast<short*>(smb + L.pcp);
  return s;
}

// ---------------------------------------------------------------------------
// the Kinv copy: 1-D bulk copies (bulk_copy.cuh) completing on an mbarrier
// ---------------------------------------------------------------------------
// Starts the copy of nn floats from src (global) into the slot and returns
// where the copy lands: slot + (src's float offset mod 4), so that source
// and destination share their alignment mod 16 bytes. The 16-byte-aligned
// body goes by bulk copies (thread 0 starts them, 32 KB each) on bar; the
// scalar head and tail by plain loads. Every thread must mbar_wait(bar, 0)
// (and a __syncthreads must pass) before reading the slot.
static __device__ float* kinv_copy_start(const float* src, int nn,
                                         float* slot, uint64_t* bar) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* dst = slot + mis;
  const int head = min((4 - mis) & 3, nn);
  const int body = ((nn - head) / 4) * 4;
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)body * 4u;
    mbar_arrive(bar, bytes);
    bulk_load(dst + head, src + head, bytes, bar);
  }
  for (int e = threadIdx.x; e < head; e += NT) dst[e] = src[e];
  for (int e = head + body + threadIdx.x; e < nn; e += NT) dst[e] = src[e];
  return dst;
}

// ---------------------------------------------------------------------------
// compression of A and P into the resident layout
// ---------------------------------------------------------------------------

// Appends the nonzeros of the dense R x C matrix M (global, row-major) to
// the pool at offset base, in row-major order, reading M once, coalesced,
// CU elements per thread per tile (the next tile's loads in flight while
// this one is scanned); returns their count (block-uniform).
// Entries at pool positions >= cap are counted, not written. wsum: scratch
// of CU * NT / 32 + 1 ints.
static __device__ int compact(const float* M, int R, int C, int base,
                              int cap, Sparse& s, int* wsum) {
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  constexpr int NW = NT / 32, NS = CU * NW, PER = NS / 32;
  const size_t total = (size_t)R * C;
  int count = 0;
  float v[CU], nxt[CU];
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    const size_t e = (size_t)u * NT + tid;
    nxt[u] = e < total ? __ldg(M + e) : 0.f;
  }
  for (size_t t0 = 0; t0 < total; t0 += (size_t)NT * CU) {
    unsigned bal[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      v[u] = nxt[u];
      const size_t e = t0 + (size_t)(CU + u) * NT + tid;
      nxt[u] = e < total ? __ldg(M + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      bal[u] = __ballot_sync(FULL, v[u] != 0.f);
      if (lane == 0) wsum[u * NW + w] = __popc(bal[u]);
    }
    __syncthreads();
    if (w == 0) {   // exclusive scan of the NS counts in (u, warp) order
      int loc[PER], acc = 0;
#pragma unroll
      for (int k = 0; k < PER; ++k) { loc[k] = acc; acc += wsum[lane * PER + k]; }
      int inc = acc;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += t;
      }
      const int ex = inc - acc;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < PER; ++k) wsum[lane * PER + k] = ex + loc[k];
      if (lane == 31) wsum[NS] = inc;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (v[u] != 0.f) {
        const int pos = base + count + wsum[u * NW + w] +
                        __popc(bal[u] & ((1u << lane) - 1u));
        if (pos < cap) {
          const size_t e = t0 + (size_t)u * NT + tid;
          s.pv[pos] = v[u];
          s.pr[pos] = (short)(e / C);
          s.pc[pos] = (short)(e % C);
        }
      }
    }
    count += wsum[NS];
    __syncthreads();
  }
  return count;
}

// exclusive scan of cnt[0..len) into out[0..len] starting at start (one
// warp)
static __device__ void warp_scan_ptr(const int* cnt, int len, int start,
                                     short* out) {
  const int lane = threadIdx.x & 31;
  const int per = (len + 31) / 32, k0 = min(lane * per, len),
            k1 = min(k0 + per, len);
  int acc = 0;
  for (int k = k0; k < k1; ++k) acc += cnt[k];
  int inc = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += t;
  }
  int run = start + inc - acc;
  for (int k = k0; k < k1; ++k) { out[k] = (short)run; run += cnt[k]; }
  if (lane == 31) out[len] = (short)(start + inc);
}

// Compresses A (m x n) and P (n x n) into the resident layout: the pool
// (A's CSR, then P's entries), A's row pointers, and the CSC of A and of P
// with each column in row order. scratch: 2 (n + 1) ints, not the pool or
// the slot (the context). Returns false (block-uniform) when the nonzeros
// exceed the cap: the scenario then runs the streaming layout.
static __device__ bool build_sparse(const QPParams& p, const float* A,
                                    const float* P, Sparse& s,
                                    int* scratch) {
  const int n = p.n, m = p.m, cap = p.nnz_cap, tid = threadIdx.x;
  const int nA = compact(A, m, n, 0, cap, s, scratch);
  const int nP = compact(P, n, n, nA, cap, s, scratch);
  if (nA + nP > cap) return false;
  const int tot = nA + nP;
  for (int k = tid; k <= nA; k += NT) {   // A's CSR row pointers
    const int r = k < nA ? s.pr[k] : m;
    const int r0 = k > 0 ? s.pr[k - 1] : -1;
    for (int rr = r0 + 1; rr <= r; ++rr) s.arp[rr] = (short)k;
  }
  int* cnt = scratch;                      // [A columns | P columns]
  for (int j = tid; j < 2 * (n + 1); j += NT) cnt[j] = 0;
  __syncthreads();
  for (int k = tid; k < tot; k += NT)
    atomicAdd(&cnt[(k >= nA ? n + 1 : 0) + s.pc[k]], 1);
  __syncthreads();
  if (tid < 32) warp_scan_ptr(cnt, n, 0, s.acp);
  else if (tid < 64) warp_scan_ptr(cnt + n + 1, n, nA, s.pcp);
  __syncthreads();
  if (tid < 32) {   // the long rows of A, in index order
    int c = 0;
    for (int s0 = 0; s0 < m; s0 += 32) {
      const int q = s0 + tid;
      const bool lg = q < m && s.arp[q + 1] - s.arp[q] > LONG_ROW;
      const unsigned bb = __ballot_sync(FULL, lg);
      const int pos = c + __popc(bb & ((1u << tid) - 1u));
      if (lg && pos < LMAX) s.lng[pos] = (short)q;
      c += __popc(bb);
    }
    // more than LMAX: every row takes the one-thread path
    if (tid == 0) *s.nlong = c <= LMAX ? c : 0;
  }
  for (int j = tid; j < n; j += NT) {      // fill cursors
    cnt[j] = s.acp[j];
    cnt[n + 1 + j] = s.pcp[j];
  }
  __syncthreads();
  for (int k = tid; k < tot; k += NT) {
    const int pos = atomicAdd(&cnt[(k >= nA ? n + 1 : 0) + s.pc[k]], 1);
    s.cv[pos] = s.pv[k];
    s.ci[pos] = s.pr[k];
  }
  __syncthreads();
  // the atomics placed each column's entries in any order: sort by row,
  // so that every sum runs in index order (rows are distinct)
  for (int col = tid; col < 2 * n; col += NT) {
    const short* ptr = col < n ? s.acp : s.pcp;
    const int j = col < n ? col : col - n;
    const int k0 = ptr[j], k1 = ptr[j + 1];
    for (int k = k0 + 1; k < k1; ++k) {
      const short ri = s.ci[k];
      const float vi = s.cv[k];
      int t = k - 1;
      while (t >= k0 && s.ci[t] > ri) {
        s.ci[t + 1] = s.ci[t];
        s.cv[t + 1] = s.cv[t];
        --t;
      }
      s.ci[t + 1] = ri;
      s.cv[t + 1] = vi;
    }
  }
  __syncthreads();
  return true;
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------

// out[j] = sum_i v[i] M[i*C + j]   (v.M, C <= any; rows split in GSPLIT)
static __device__ __forceinline__ void vecmat(const float* v, const float* M, int R, int C,
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

// v.M for M in shared memory, epi(j, (v.M)[j]), in vecmat's order and
// bits: one thread per column over GSPLIT row groups, v (16-byte aligned)
// read as float4 between the groups' scalar ends; neighbouring threads
// read neighbouring words of M (no bank conflicts)
template <class Epi>
static __device__ __forceinline__ void vecmat4(const float* v,
                                               const float* M, int R, int C,
                                               float* part, Epi epi) {
  const int g = threadIdx.x / 256, jl = threadIdx.x % 256;
  const int i0 = (R * g) / GSPLIT, i1 = (R * (g + 1)) / GSPLIT;
  for (int j0 = 0; j0 < C; j0 += 256) {
    const int j = j0 + jl;
    float acc = 0.f;
    if (j < C) {
      const float* col = M + j;
      int i = i0;
      for (; (i & 3) && i < i1; ++i) acc = fmaf(v[i], col[(size_t)i * C], acc);
#pragma unroll 4
      for (; i + 4 <= i1; i += 4) {
        const float4 w = *reinterpret_cast<const float4*>(v + i);
        acc = fmaf(w.x, col[(size_t)i * C], acc);
        acc = fmaf(w.y, col[(size_t)(i + 1) * C], acc);
        acc = fmaf(w.z, col[(size_t)(i + 2) * C], acc);
        acc = fmaf(w.w, col[(size_t)(i + 3) * C], acc);
      }
      for (; i < i1; ++i) acc = fmaf(v[i], col[(size_t)i * C], acc);
    }
    part[g * 256 + jl] = acc;
    __syncthreads();
    if (g == 0 && j < C) {
      float s = part[jl];
      for (int gg = 1; gg < GSPLIT; ++gg) s += part[gg * 256 + jl];
      epi(j, s);
    }
    __syncthreads();
  }
}

// out[i] = sum_j M[i*C + j] v[j]   (M v: one warp per row)
static __device__ __forceinline__ void matvec(const float* M, const float* v, int R, int C,
                              float* out) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = w; i < R; i += NT / 32) {
    const float* row = M + (size_t)i * C;
    float acc = 0.f;
    for (int j = lane; j < C; j += 32) acc = fmaf(row[j], v[j], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) out[i] = acc;
  }
  __syncthreads();
}

// One compressed set: S segments (the rows of A's CSR, or the columns of a
// CSC), entry values and indices; for a CSC, half: the row at which the
// dense v.M splits its sum (its GSPLIT row groups); for the CSR, the long
// rows listed for whole warps (nlong = 0: none).
struct SegSet {
  const short *ptr, *idx, *lng;
  const float* val;
  int S, half, nlong;
};

// Row k0..k1 of a CSR, (A x)_i, in matvec's order: lane L = column mod 32
// sums its columns in order, then the xor tree 16, 8, .., 1 read at lane 0
// (the lanes without an entry add exact zeros), so the sum has the dense
// kernel's bits. The 32 partials are named registers: an array indexed by
// the data-dependent lane would live in local memory.
#define RD_LANES(X) \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) \
  X(13) X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) \
  X(24) X(25) X(26) X(27) X(28) X(29) X(30) X(31)
#define RD_DECL(q) float p##q = 0.f;
#define RD_ADD(q) \
  if (L == q) p##q = fmaf(a, b, p##q);

template <class Gth>
static __device__ __forceinline__ float row_dot(const float* val,
                                                const short* idx, int k0,
                                                int k1, Gth gather) {
  RD_LANES(RD_DECL)
  for (int k = k0; k < k1; ++k) {
    const int c = idx[k], L = c & 31;
    const float a = val[k], b = gather(c);
    RD_LANES(RD_ADD)
  }
  // lane q after the step at offset off: its value + lane (q + off)'s
  p0 += p16; p1 += p17; p2 += p18; p3 += p19; p4 += p20; p5 += p21; p6 += p22;
  p7 += p23; p8 += p24; p9 += p25; p10 += p26; p11 += p27; p12 += p28;
  p13 += p29; p14 += p30; p15 += p31;
  p0 += p8; p1 += p9; p2 += p10; p3 += p11; p4 += p12; p5 += p13; p6 += p14;
  p7 += p15;
  p0 += p4; p1 += p5; p2 += p6; p3 += p7;
  p0 += p2; p1 += p3;
  p0 += p1;
  return p0;
}
#undef RD_DECL
#undef RD_ADD
#undef RD_LANES

// Column k0..k1 of a CSC, (v.M)_j, in vecmat's order: rows below half and
// from half on summed apart, in row order, then added.
template <class Gth>
static __device__ __forceinline__ float col_dot(const float* val,
                                                const short* idx, int k0,
                                                int k1, int half,
                                                Gth gather) {
  float a0 = 0.f, a1 = 0.f;
  for (int k = k0; k < k1; ++k) {
    const int i = idx[k];
    const float t = fmaf(gather(i), val[k], i < half ? a0 : a1);
    if (i < half) a0 = t;
    else a1 = t;
  }
  return a0 + a1;
}

// One pass over the rows of the CSR set r: e(i, (A x)_i) with entries
// gathered by g, a thread per row, the listed long rows a warp each (from
// the last warp down, the ones the short rows leave idle). Ends with a
// __syncthreads.
template <class G, class E>
static __device__ __forceinline__ void rows_pass(const SegSet r, G g, E e) {
  const int tid = threadIdx.x;
  for (int i = tid; i < r.S; i += NT) {
    const int k0 = r.ptr[i], k1 = r.ptr[i + 1];
    if (r.nlong == 0 || k1 - k0 <= LONG_ROW)
      e(i, row_dot(r.val, r.idx, k0, k1, g));
  }
  // a long row: the warp loads 32 entries at a time, and each goes by
  // shuffles, in order, to lane (column mod 32), as in matvec
  const int w = NT / 32 - 1 - (tid >> 5), lane = tid & 31;
  for (int q = w; q < r.nlong; q += NT / 32) {
    const int i = r.lng[q], k1 = r.ptr[i + 1];
    float acc = 0.f;
    for (int kb = r.ptr[i]; kb < k1; kb += 32) {
      const int k = kb + lane;
      const int ck = k < k1 ? r.idx[k] : 0;
      const float ak = k < k1 ? r.val[k] : 0.f, bk = k < k1 ? g(ck) : 0.f;
      for (int t = 0; t < min(32, k1 - kb); ++t) {
        const int c = __shfl_sync(FULL, ck, t);
        const float a = __shfl_sync(FULL, ak, t);
        const float b = __shfl_sync(FULL, bk, t);
        if ((c & 31) == lane) acc = fmaf(a, b, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) e(i, acc);
  }
  __syncthreads();
}

// One pass over the columns of the CSC set c: e(j, (v.M)_j) with entries
// gathered by g, a thread per column. Ends with a __syncthreads.
template <class G, class E>
static __device__ __forceinline__ void cols_pass(const SegSet c, G g, E e) {
  for (int j = threadIdx.x; j < c.S; j += NT)
    e(j, col_dot(c.val, c.idx, c.ptr[j], c.ptr[j + 1], c.half, g));
  __syncthreads();
}

// The same over two CSC sets of equal width: e(j, (v1.M1)_j, (v2.M2)_j).
template <class G1, class G2, class E>
static __device__ __forceinline__ void cols_pass2(const SegSet c1, G1 g1,
                                                  const SegSet c2, G2 g2,
                                                  E e) {
  for (int j = threadIdx.x; j < c1.S; j += NT)
    e(j, col_dot(c1.val, c1.idx, c1.ptr[j], c1.ptr[j + 1], c1.half, g1),
      col_dot(c2.val, c2.idx, c2.ptr[j], c2.ptr[j + 1], c2.half, g2));
  __syncthreads();
}

// The two layouts of the ADMM core's products. Av: A x (m outputs); vA,
// vP, vK: v.A, v.P, v.Kinv (n outputs). Each ends with a __syncthreads.

// stream: dense P, A and Kinv wherever they live (global memory; Kinv also
// in the shared slot, for a scenario whose nonzeros overflow the cap)
struct DenseOps {
  const float *P, *A, *K;
  int n, m;
  __device__ void Av(const float* x, float* out) const {
    matvec(A, x, m, n, out);
  }
  __device__ void vA(const float* v, float* out, float* part) const {
    vecmat(v, A, m, n, out, part);
  }
  __device__ void vP(const float* v, float* out, float* part) const {
    vecmat(v, P, n, n, out, part);
  }
  __device__ void vK(const float* v, float* out, float* part) const {
    vecmat(v, K, n, n, out, part);
  }
};

// resident: Kinv dense in the shared slot, A and P compressed beside it
// (ar: A's rows, ac: A's columns, pc: P's columns); every product has the
// dense kernels' summation order, so both layouts give the same bits
struct SparseOps {
  SegSet ar, ac, pc;
  const float* K;
  __device__ SparseOps(const Sparse& s, const float* K_, int n, int m)
      : ar{s.arp, s.pc, s.lng, s.pv, m, 0, *s.nlong},
        ac{s.acp, s.ci, nullptr, s.cv, n, m / GSPLIT, 0},
        pc{s.pcp, s.ci, nullptr, s.cv, n, n / GSPLIT, 0},
        K(K_) {}
  __device__ void Av(const float* x, float* out) const {
    rows_pass(ar, [=](int j) { return x[j]; },
              [=](int i, float v) { out[i] = v; });
  }
  __device__ void vA(const float* v, float* out, float*) const {
    cols_pass(ac, [=](int i) { return v[i]; },
              [=](int j, float w) { out[j] = w; });
  }
  __device__ void vP(const float* v, float* out, float*) const {
    cols_pass(pc, [=](int i) { return v[i]; },
              [=](int j, float w) { out[j] = w; });
  }
};

// ---------------------------------------------------------------------------
// the ADMM core
// ---------------------------------------------------------------------------

// block-wide max of 4 values (NaN-propagating); result in every thread
static __device__ __forceinline__ void block_max4(float v[4], float* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = nanmax(v[k], __shfl_xor_sync(FULL, v[k], off));
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
    mx = nanmax(mx, __shfl_xor_sync(FULL, mx, off));
    sm += __shfl_xor_sync(FULL, sm, off);
  }
  if (lane == 0) { red[w * 2] = mx; red[w * 2 + 1] = sm; }
  __syncthreads();
  float a = red[0], s = red[1];
  for (int i = 1; i < NT / 32; ++i) { a = nanmax(a, red[2 * i]); s += red[2 * i + 1]; }
  mx = a;
  sm = s;
  __syncthreads();
}

static __device__ __forceinline__ void load_vectors(const QPParams& p, Ctx& c, const float* nv,
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

// the vectors and the iterates (x, z, y) of scenario b
static __device__ __forceinline__ void load_state(const QPParams& p, Ctx& c, int b,
                                  const float* nvecs, const float* vecs,
                                  const float* x0, const float* z0,
                                  const float* y0) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  load_vectors(p, c, nvecs + (size_t)b * 2 * n, vecs + (size_t)b * 5 * m);
  for (int j = tid; j < n; j += NT) c.x[j] = x0[(size_t)b * n + j];
  for (int i = tid; i < m; i += NT) {
    c.z[i] = z0[(size_t)b * m + i];
    c.y[i] = y0[(size_t)b * m + i];
  }
  __syncthreads();
}

template <class Ops>
static __device__ __forceinline__ void one_iter(const QPParams& p, Ctx& c, const Ops& op) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  for (int i = tid; i < m; i += NT) c.tm1[i] = c.rho[i] * c.z[i] - c.y[i];
  __syncthreads();
  op.vA(c.tm1, c.tn1, c.part);
  for (int j = tid; j < n; j += NT) c.rhs[j] = p.sigma * c.x[j] - c.q[j] + c.tn1[j];
  __syncthreads();
  op.vK(c.rhs, c.xt, c.part);
  for (int r = 0; r < p.refine_steps; ++r) {
    op.Av(c.xt, c.tm1);
    for (int i = tid; i < m; i += NT) c.tm1[i] *= c.rho[i];
    __syncthreads();
    op.vP(c.xt, c.tn1, c.part);
    op.vA(c.tm1, c.tn2, c.part);
    for (int j = tid; j < n; j += NT)
      c.tn1[j] = c.rhs[j] - ((c.tn1[j] + p.sigma * c.xt[j]) + c.tn2[j]);
    __syncthreads();
    op.vK(c.tn1, c.tn2, c.part);
    for (int j = tid; j < n; j += NT) c.xt[j] += c.tn2[j];
    __syncthreads();
  }
  op.Av(c.xt, c.tm1);
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

// The same iteration on the resident layout, with each elementwise step
// folded into the pass before or after it (8 barriers instead of ~17; the
// same arithmetic and bits): A'(rho z - y) with rhs as its epilogue;
// rhs.Kinv; rho A xt; xt.P and A'(rho A xt) in one pass with the
// refinement residual; xt += (.).Kinv; then A xt with the z, y updates (x
// beside it).
static __device__ __forceinline__ void one_iter(const QPParams& p, Ctx& c,
                                                const SparseOps& op) {
  const int n = p.n, tid = threadIdx.x;
  const float sigma = p.sigma, alpha = p.alpha, oma = p.one_m_alpha;
  // the context's pointers by value, so that the closures hold registers
  float *x = c.x, *xt = c.xt, *rhs = c.rhs, *tn1 = c.tn1, *tm1 = c.tm1,
        *z = c.z, *y = c.y;
  const float *q = c.q, *rho = c.rho, *rinv = c.rinv, *l = c.l, *u = c.u;
  PHASE_START
  cols_pass(op.ac, [=](int i) { return rho[i] * z[i] - y[i]; },
            [=](int j, float s) { rhs[j] = sigma * x[j] - q[j] + s; });
  PHASE(PH_VA)
  vecmat4(rhs, op.K, n, n, c.part, [=](int j, float s) { xt[j] = s; });
  PHASE(PH_VK)
  for (int r = 0; r < p.refine_steps; ++r) {
    rows_pass(op.ar, [=](int j) { return xt[j]; },
              [=](int i, float s) { tm1[i] = s * rho[i]; });
    PHASE(PH_AV)
    cols_pass2(op.pc, [=](int i) { return xt[i]; }, op.ac,
               [=](int i) { return tm1[i]; }, [=](int j, float px, float s) {
                 tn1[j] = rhs[j] - ((px + sigma * xt[j]) + s);
               });
    PHASE(PH_VP_VA)
    vecmat4(tn1, op.K, n, n, c.part, [=](int j, float s) { xt[j] += s; });
    PHASE(PH_VK)
  }
  for (int j = tid; j < n; j += NT) x[j] = alpha * xt[j] + oma * x[j];
  rows_pass(op.ar, [=](int j) { return xt[j]; }, [=](int i, float s) {
    const float zrel = alpha * s + oma * z[i];
    const float zn = clipf(zrel + y[i] * rinv[i], l[i], u[i]);
    y[i] = y[i] + rho[i] * (zrel - zn);
    z[i] = zn;
  });
  PHASE(PH_AV_UPDATE)
}

// unscaled primal / dual residuals and the tolerance test (block-uniform)
template <class Ops>
static __device__ __forceinline__ bool residuals(const QPParams& p, Ctx& c, const Ops& op,
                                 float c_inv, float& pri, float& dua) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  op.Av(c.x, c.tm1);
  op.vP(c.x, c.tn1, c.part);
  op.vA(c.y, c.tn2, c.part);
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
// ran; sets iters on convergence (else leaves it unchanged)
template <class Ops>
static __device__ __forceinline__ void run_chunks(const QPParams& p, Ctx& c, const Ops& op,
                                  float c_inv, int budget, int it_base,
                                  float exit_pri, bool& done, int& iters,
                                  float& pri, float& dua) {
  const int ce = p.check_every;
  const int n_chunks = max((budget + ce - 1) / ce, 1);
  for (int k = 0; k < n_chunks && !done; ++k) {
    const int this_chunk = min(ce, budget - k * ce);
    for (int t = 0; t < this_chunk; ++t) one_iter(p, c, op);
    PHASE_START
    bool ok = residuals(p, c, op, c_inv, pri, dua);
    PHASE(PH_CHECK)
    ok = ok || pri < exit_pri;
    if (ok) {
      done = true;
      iters = it_base + min((k + 1) * ce, budget);
    }
  }
}

// writes scenario b's iterates x, z, y from the context
static __device__ __forceinline__ void store_iterates(const QPParams& p, const Ctx& c, int b,
                                      float* xo, float* zo, float* yo) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  for (int j = tid; j < n; j += NT) xo[(size_t)b * n + j] = c.x[j];
  for (int i = tid; i < m; i += NT) {
    zo[(size_t)b * m + i] = c.z[i];
    yo[(size_t)b * m + i] = c.y[i];
  }
}

// The main ADMM loop of scenario b (vectors already in the context): the
// entry check, then run_chunks at fixed rho; writes x, z, y, (pri, dua),
// (iters, done, needs-rescue) and the streamed flag, counting a streamed
// scenario in *streamed.
template <class Ops>
static __device__ __forceinline__ void admm_loop(const QPParams& p, Ctx& c, int b,
                                 const Ops& op, float c_inv, bool stream,
                                 float* xo, float* zo, float* yo,
                                 float* stats, int* flags, int* streamed) {
  float pri, dua;
  bool done = residuals(p, c, op, c_inv, pri, dua);   // entry check
  int iters = done ? 0 : p.max_iter;
  run_chunks(p, c, op, c_inv, p.max_iter, 0, -INFINITY, done, iters, pri,
             dua);
  store_iterates(p, c, b, xo, zo, yo);
  if (threadIdx.x == 0) {
    stats[b * 2 + 0] = pri;
    stats[b * 2 + 1] = dua;
    flags[b * NFLAG + 0] = iters;
    flags[b * NFLAG + 1] = done ? 1 : 0;
    flags[b * NFLAG + 2] =
        (p.rescue_max_iter > 0 && pri > p.rescue_trigger) ? 1 : 0;
    flags[b * NFLAG + 3] = stream ? 1 : 0;
    if (stream) atomicAdd(streamed, 1);
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
