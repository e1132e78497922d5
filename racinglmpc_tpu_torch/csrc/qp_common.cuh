// Device functions shared by the ADMM kernels B1 (cuda_qp.cu) and B4
// (cuda_qp_fused.cu): the per-scenario CTA context in shared memory, the two
// layouts of the ADMM core (resident: Kinv and the compressed A and P in
// shared memory; stream: Kinv, A and P read from global memory in every
// product), one ADMM iteration, the residual check, the check_every chunks,
// the main ADMM loop of one scenario, and the Newton-Schulz prologue (its
// product core and passes over a global workspace).
// "v.M" products contract M's rows (v @ M, as the Pallas kernels' row
// vectors do); "M v" products contract its columns.
// The main loop is instantiated at an iteration precision (PREC_*): the
// products of one iteration run in float32 ("highest"), as three bf16
// products ("bf16x3") or as one bf16 pass ("default"); the residual checks,
// the rescue and the Newton-Schulz prologue always run in float32.
#pragma once
#include <cuda_bf16.h>
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
#define PK 16           // k-values of a staged slab of the product core
#define LONG_ROW 16     // a row of A with more entries takes a whole warp
#define LMAX 8          // long rows of A listed for warps
#define CU 8            // elements per thread per tile of the compaction
#define NFLAG 4         // flags per scenario: iters, done, needs-rescue,
                        // streamed
#define FULL 0xffffffffu

enum { LAYOUT_STREAM = 0, LAYOUT_RESIDENT = 1 };

// iteration precisions (ops/cuda_qp.py:ITER_PRECISIONS; the reference's
// SolverConfig.pallas_iter_precision)
enum { PREC_HIGHEST = 0, PREC_BF16X3 = 1, PREC_DEFAULT = 2 };

// Phase clocks, compiled in only with -DQP_PHASES (runtime/admm_bench.py
// --phases): thread 0 of scenario 0 adds the SM cycles since its last mark
// to the phase's counter (this card has no kernel profiler).
enum { PH_VK, PH_AV, PH_VA, PH_VP_VA, PH_AV_UPDATE, PH_CHECK, PH_PROLOGUE,
       PH_WAIT, PH_N };
// B4's prologue clocks (cuda_qp_fused.cu, admm_bench.py --kernel b4
// --phases), into the array a kernel hands to the product core: SM cycles
// of thread 0 of scenario 0 in the K build (with the Jacobi init), the
// warm test, the residual and the update products of both Newton-Schulz
// passes and the passes as a whole; then, summed over every product,
// thread 0's (a cell thread's) cycles waiting at the slab barriers,
// multiplying, and in the epilogues, and the first producer's cycles
// issuing slabs and waiting for them
enum { FPH_KBUILD, FPH_WARM, FPH_NS_RESID, FPH_NS_UPDATE, FPH_NS,
       FPH_C_WAIT, FPH_C_MATH, FPH_C_EPI, FPH_P_ISSUE, FPH_P_WAIT, FPH_N };
#ifdef QP_PHASES
static __device__ long long qp_phase[PH_N];
#define PHASE_START long long qp_t0_ = clock64();
#define PHASE(k)                                      \
  if (threadIdx.x == 0 && blockIdx.x == 0) {          \
    const long long t_ = clock64();                   \
    qp_phase[k] += t_ - qp_t0_;                       \
    qp_t0_ = t_;                                      \
  }
// B4's prologue clocks (cuda_qp_fused.cu): thread `who` of scenario 0
// adds the cycles since its last TMARK (or TSTART) to clk[k], where clk is
// given
#define TSTART long long tm_ = clock64();
#define TMARK(clk, k, who)                                     \
  if ((clk) && (who) && blockIdx.x == 0) {                     \
    const long long t_ = clock64();                            \
    (clk)[k] += t_ - tm_;                                      \
    tm_ = t_;                                                  \
  }
#else
#define PHASE_START
#define PHASE(k)
#define TSTART
#define TMARK(clk, k, who)
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

// the product core's geometry at n over a band of `rows` output rows (its
// outputs in 8 x 8 cells, one per thread; see product() below)
struct Geo {
  int cells;    // column cells (n / 8 rounded up): 8 cells columns
  int cr;       // row cells of a pass
  int passes;
  int sa;       // row stride of a staged slab of the left operand (floats)
};

static __host__ __device__ inline Geo geo(int n, int rows) {
  Geo g;
  g.cells = (n + 7) / 8;
  const int rc = (rows + 7) / 8;
  const int per = (NT - 32) / g.cells;   // at least one producer warp
  g.passes = (rc + per - 1) / per;
  g.cr = (rc + g.passes - 1) / g.passes;
  // 8 cr floats padded to 4 mod 32: the transposing stores of a slab
  // (16 k-values of a row from neighbouring threads) hit distinct banks
  // two at a time
  g.sa = 8 * g.cr + (36 - (8 * g.cr) % 32) % 32;
  return g;
}

static __host__ __device__ inline Geo geo(int n) { return geo(n, n); }

// B1's rescue prologue spread over a thread-block cluster: a lane's CTAs
// (at most 8, the portable cluster size, one per 8-row cell of the output
// at small n) each compute a band of whole 8-row cells of every product's
// rows, as even as can be
static __host__ __device__ inline int rescue_split(int n) {
  const int cells = (n + 7) / 8;
  return cells < 8 ? cells : 8;
}

// rows [*r0, *r1) of CTA `rank` of `c` over n rows
static __host__ __device__ inline void rescue_band(int n, int c, int rank,
                                                   int* r0, int* r1) {
  const int cells = (n + 7) / 8;
  const int a = 8 * (rank * cells / c), b = 8 * ((rank + 1) * cells / c);
  *r0 = a < n ? a : n;
  *r1 = b < n ? b : n;
}

// floats of the Newton-Schulz prologue's shared memory (B4, B1's rescue):
// the product core's two slab buffers (left operand, then right) and the
// Jacobi diagonal
static __host__ __device__ inline size_t prologue_floats(int n) {
  const Geo g = geo(n);
  return (size_t)2 * PK * (g.sa + 8 * g.cells) + r4(n);
}

// ---------------------------------------------------------------------------
// the resident layout: byte offsets in the dynamic shared memory
//   [mbarrier, long-row list (80 B) | context | Kinv slot |
//    pool values | CSC values | pool rows | pool cols | CSC rows |
//    A row ptr | A col ptr | P col ptr]
// The Kinv slot holds n*n floats plus 4 of slack (the copy keeps the
// source's alignment mod 16 bytes). The
// pool takes the nonzeros of A then P in row-major order (it is A's CSR);
// the CSC arrays hold A's columns then P's. ops/cuda_qp.py:smem_plan
// mirrors this count.
// ---------------------------------------------------------------------------
struct Resident {
  size_t ctx, slot, pv, cv, pr, pc, ci, arp, acp, pcp, total;
};

static __host__ __device__ inline size_t slot_floats(int n) {
  return (size_t)r4(n * n + 4);
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

// dynamic shared memory of a Newton-Schulz prologue launch (B4's; B1's
// rescue's): the context (rho and the reductions' scratch) and the
// product core's slabs and Jacobi diagonal
static __host__ __device__ inline size_t prologue_smem(int n, int m) {
  return 4 * (ctx_floats(n, m) + prologue_floats(n));
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
// products, at an iteration precision PR
// ---------------------------------------------------------------------------
// At PREC_HIGHEST every output is one float32 fmaf chain in the product's k
// order. At a lowered precision (PREC_BF16X3 or PREC_DEFAULT) the operands
// are split on the fly as they are read: a matrix entry costs two roundings
// and a subtraction, a vector entry the same where it is gathered, or
// nothing where the loop split it into a packed word once per product
// (pack_split). Every output then keeps its float32 accumulators (Acc:
// three at bf16x3), each one fmaf chain in the product's k order; products
// of bf16 values are exact in float32. The lowered sparse loops are not
// unrolled: unrolled, the bf16x3 resident instantiation spilled.

// x rounded to bfloat16, nearest even (the reference's astype(bfloat16)),
// as a float
static __device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// highest: hi = x, lo = 0; bf16x3: hi = bf16(x), lo = bf16(x - hi);
// default: hi = bf16(x), lo = 0
template <int PR>
static __device__ __forceinline__ void bf16_split(float x, float& hi,
                                                  float& lo) {
  if constexpr (PR == PREC_HIGHEST) {
    hi = x;
    lo = 0.f;
  } else {
    hi = bf16_rn(x);
    lo = PR == PREC_BF16X3 ? bf16_rn(__fsub_rn(x, hi)) : 0.f;
  }
}

// the split of x in one 32-bit word: hi's 16 high bits, then lo's (both
// are bf16 values: their low 16 bits are zero); read back by
// unpack_split. At PREC_HIGHEST, x itself.
template <int PR>
static __device__ __forceinline__ float pack_split(float x) {
  if constexpr (PR == PREC_HIGHEST) return x;
  float hi, lo;
  bf16_split<PR>(x, hi, lo);
  return __uint_as_float((__float_as_uint(hi) & 0xffff0000u) |
                         (__float_as_uint(lo) >> 16));
}

static __device__ __forceinline__ void unpack_split(float w, float& hi,
                                                    float& lo) {
  const unsigned u = __float_as_uint(w);
  hi = __uint_as_float(u & 0xffff0000u);
  lo = __uint_as_float(u << 16);
}

// The accumulator of one output at PR. At PREC_HIGHEST, hh alone: one
// float32 fmaf chain. At bf16x3, hh, hl, lh = v_hi M_hi, v_hi M_lo,
// v_lo M_hi, combined as hh + (hl + lh), the reference's association,
// pinned; at default, hh alone over the rounded operands.
template <int PR>
struct Acc {
  float hh = 0.f, hl = 0.f, lh = 0.f;
  // v split as (vh, vl), the matrix entry m split here
  __device__ __forceinline__ void add(float vh, float vl, float m) {
    float mh, ml;
    bf16_split<PR>(m, mh, ml);
    hh = fmaf(vh, mh, hh);
    if (PR == PREC_BF16X3) {
      hl = fmaf(vh, ml, hl);
      lh = fmaf(vl, mh, lh);
    }
  }
  // both operands split here
  __device__ __forceinline__ void add(float v, float m) {
    float vh, vl;
    bf16_split<PR>(v, vh, vl);
    add(vh, vl, m);
  }
  // this chain's sum with another's (this + o, per accumulator)
  __device__ __forceinline__ void merge(const Acc& o) {
    hh = __fadd_rn(hh, o.hh);
    hl = __fadd_rn(hl, o.hl);
    lh = __fadd_rn(lh, o.lh);
  }
  // the xor tree 16, 8, .., 1 over a warp's lanes, per accumulator
  __device__ __forceinline__ void warp_sum() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hh += __shfl_xor_sync(FULL, hh, off);
      if (PR == PREC_BF16X3) {
        hl += __shfl_xor_sync(FULL, hl, off);
        lh += __shfl_xor_sync(FULL, lh, off);
      }
    }
  }
  __device__ __forceinline__ float sum() const {
    return PR == PREC_BF16X3 ? __fadd_rn(hh, __fadd_rn(hl, lh)) : hh;
  }
};

// The v.M products' two row groups, merged as group 0's + group 1's, per
// accumulator: at PREC_HIGHEST as the dense kernels did, both groups' sums
// through part; at a lowered precision group 1's (two floats a column, in
// two rounds at bf16x3). Every thread calls it; group 0 ends with the
// merged sums.
template <int PR>
static __device__ __forceinline__ void merge_groups(Acc<PR>& a,
                                                    float* part) {
  static_assert(GSPLIT == 2, "two row groups");
  const int g = threadIdx.x / 256, jl = threadIdx.x % 256;
  if constexpr (PR == PREC_HIGHEST) {
    part[g * 256 + jl] = a.hh;
    __syncthreads();
    a.hh = part[jl] + part[256 + jl];
    return;
  }
  if (g == 1) {
    part[jl] = a.hh;
    part[256 + jl] = a.hl;
  }
  __syncthreads();
  if (g == 0) {
    a.hh = __fadd_rn(a.hh, part[jl]);
    a.hl = __fadd_rn(a.hl, part[256 + jl]);
  }
  if (PR == PREC_BF16X3) {
    __syncthreads();
    if (g == 1) part[jl] = a.lh;
    __syncthreads();
    if (g == 0) a.lh = __fadd_rn(a.lh, part[jl]);
  }
}

// out[j] = sum_i v[i] M[i*C + j]   (v.M, C <= any; rows split in GSPLIT)
template <int PR>
static __device__ __forceinline__ void vecmat(const float* v, const float* M,
                                              int R, int C, float* out,
                                              float* part) {
  const int g = threadIdx.x / 256, jl = threadIdx.x % 256;
  const int i0 = (R * g) / GSPLIT, i1 = (R * (g + 1)) / GSPLIT;
  for (int j0 = 0; j0 < C; j0 += 256) {
    const int j = j0 + jl;
    Acc<PR> a;
    if (j < C) {
      const float* col = M + j;
#pragma unroll (PR == PREC_HIGHEST ? 8 : 4)
      for (int i = i0; i < i1; ++i) a.add(v[i], col[(size_t)i * C]);
    }
    merge_groups(a, part);
    if (g == 0 && j < C) out[j] = a.sum();
    __syncthreads();
  }
}

// v.M for M in shared memory, epi(j, (v.M)[j]), in vecmat's order and
// bits: one thread per column over GSPLIT row groups; neighbouring threads
// read neighbouring words of M (no bank conflicts). At PREC_HIGHEST v
// (16-byte aligned) is read as float4 between the groups' scalar ends; at
// a lowered precision v holds packed splits (pack_split), read one entry
// at a time (with four in flight, read as a float4, the bf16x3
// instantiation spilled: -Xptxas -v).
template <int PR, class Epi>
static __device__ __forceinline__ void vecmat4(const float* v,
                                               const float* M, int R, int C,
                                               float* part, Epi epi) {
  const int g = threadIdx.x / 256, jl = threadIdx.x % 256;
  const int i0 = (R * g) / GSPLIT, i1 = (R * (g + 1)) / GSPLIT;
  for (int j0 = 0; j0 < C; j0 += 256) {
    const int j = j0 + jl;
    Acc<PR> a;
    if (j < C) {
      const float* col = M + j;
      if constexpr (PR == PREC_HIGHEST) {
        int i = i0;
        for (; (i & 3) && i < i1; ++i) a.add(v[i], col[(size_t)i * C]);
#pragma unroll 4
        for (; i + 4 <= i1; i += 4) {
          const float4 w = *reinterpret_cast<const float4*>(v + i);
          a.add(w.x, col[(size_t)i * C]);
          a.add(w.y, col[(size_t)(i + 1) * C]);
          a.add(w.z, col[(size_t)(i + 2) * C]);
          a.add(w.w, col[(size_t)(i + 3) * C]);
        }
        for (; i < i1; ++i) a.add(v[i], col[(size_t)i * C]);
      } else {
        float vh, vl;
        for (int i = i0; i < i1; ++i) {
          unpack_split(v[i], vh, vl);
          a.add(vh, vl, col[(size_t)i * C]);
        }
      }
    }
    merge_groups(a, part);
    if (g == 0 && j < C) epi(j, a.sum());
    __syncthreads();
  }
}

// out[i] = sum_j M[i*C + j] v[j]   (M v: one warp per row, lane = column
// mod 32, then the xor tree)
template <int PR>
static __device__ __forceinline__ void matvec(const float* M, const float* v,
                                              int R, int C, float* out) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = w; i < R; i += NT / 32) {
    const float* row = M + (size_t)i * C;
    Acc<PR> a;
    for (int j = lane; j < C; j += 32) a.add(v[j], row[j]);
    a.warp_sum();
    if (lane == 0) out[i] = a.sum();
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

// Column k0..k1 of a CSC, (v.M)_j, in vecmat's order: the rows below half
// and from half on summed apart, in row order, then added. At
// PREC_HIGHEST one loop picks each entry's chain by its row; at a lowered
// precision two loops (each column's rows are sorted).
template <int PR, class Gth>
static __device__ __forceinline__ float col_dot(const float* val,
                                                const short* idx, int k0,
                                                int k1, int half,
                                                Gth gather) {
  Acc<PR> a0, a1;
  if constexpr (PR == PREC_HIGHEST) {
    for (int k = k0; k < k1; ++k) {
      const int i = idx[k];
      const float t = fmaf(gather(i), val[k], i < half ? a0.hh : a1.hh);
      if (i < half) a0.hh = t;
      else a1.hh = t;
    }
  } else {
    int k = k0;
#pragma unroll 1
    for (; k < k1 && idx[k] < half; ++k) a0.add(gather(idx[k]), val[k]);
#pragma unroll 1
    for (; k < k1; ++k) a1.add(gather(idx[k]), val[k]);
  }
  a0.merge(a1);
  return a0.sum();
}

// One pass over the rows of the CSR set r: e(i, (A x)_i) with entries
// gathered by g, a thread per row, the listed long rows a warp each (from
// the last warp down, the ones the short rows leave idle). At
// PREC_HIGHEST in matvec's order (row_dot; a long row's warp loads 32
// entries at a time, each going by shuffles, in order, to lane = column
// mod 32); at a lowered precision a short row sums its entries in column
// order, and a long row's lane = entry mod 32. Then the xor tree. Ends
// with a __syncthreads.
template <int PR, class G, class E>
static __device__ __forceinline__ void rows_pass(const SegSet r, G g, E e) {
  const int tid = threadIdx.x;
  for (int i = tid; i < r.S; i += NT) {
    const int k0 = r.ptr[i], k1 = r.ptr[i + 1];
    if (r.nlong == 0 || k1 - k0 <= LONG_ROW) {
      if constexpr (PR == PREC_HIGHEST) {
        e(i, row_dot(r.val, r.idx, k0, k1, g));
      } else {
        Acc<PR> a;
#pragma unroll 1
        for (int k = k0; k < k1; ++k) a.add(g(r.idx[k]), r.val[k]);
        e(i, a.sum());
      }
    }
  }
  const int w = NT / 32 - 1 - (tid >> 5), lane = tid & 31;
  for (int q = w; q < r.nlong; q += NT / 32) {
    const int i = r.lng[q], k1 = r.ptr[i + 1];
    Acc<PR> a;
    if constexpr (PR == PREC_HIGHEST) {
      for (int kb = r.ptr[i]; kb < k1; kb += 32) {
        const int k = kb + lane;
        const int ck = k < k1 ? r.idx[k] : 0;
        const float ak = k < k1 ? r.val[k] : 0.f, bk = k < k1 ? g(ck) : 0.f;
        for (int t = 0; t < min(32, k1 - kb); ++t) {
          const int c = __shfl_sync(FULL, ck, t);
          const float av = __shfl_sync(FULL, ak, t);
          const float bv = __shfl_sync(FULL, bk, t);
          if ((c & 31) == lane) a.add(bv, av);
        }
      }
    } else {
#pragma unroll 1
      for (int k = r.ptr[i] + lane; k < k1; k += 32)
        a.add(g(r.idx[k]), r.val[k]);
    }
    a.warp_sum();
    if (lane == 0) e(i, a.sum());
  }
  __syncthreads();
}

// One pass over the columns of the CSC set c: e(j, (v.M)_j) with entries
// gathered by g, a thread per column. Ends with a __syncthreads.
template <int PR, class G, class E>
static __device__ __forceinline__ void cols_pass(const SegSet c, G g, E e) {
  for (int j = threadIdx.x; j < c.S; j += NT)
    e(j, col_dot<PR>(c.val, c.idx, c.ptr[j], c.ptr[j + 1], c.half, g));
  __syncthreads();
}

// The same over two CSC sets of equal width: e(j, (v1.M1)_j, (v2.M2)_j).
template <int PR, class G1, class G2, class E>
static __device__ __forceinline__ void cols_pass2(const SegSet c1, G1 g1,
                                                  const SegSet c2, G2 g2,
                                                  E e) {
  for (int j = threadIdx.x; j < c1.S; j += NT)
    e(j, col_dot<PR>(c1.val, c1.idx, c1.ptr[j], c1.ptr[j + 1], c1.half, g1),
      col_dot<PR>(c2.val, c2.idx, c2.ptr[j], c2.ptr[j + 1], c2.half, g2));
  __syncthreads();
}

// The two layouts of the ADMM core's products. Av: A x (m outputs); vA,
// vP, vK: v.A, v.P, v.Kinv (n outputs). Each ends with a __syncthreads.

// stream: dense P, A and Kinv wherever they live (global memory; Kinv also
// in the shared slot, for a scenario whose nonzeros overflow the cap); at
// an iteration precision PR (the checks: PREC_HIGHEST)
struct DenseOps {
  const float *P, *A, *K;
  int n, m;
  template <int PR = PREC_HIGHEST>
  __device__ void Av(const float* x, float* out) const {
    matvec<PR>(A, x, m, n, out);
  }
  template <int PR = PREC_HIGHEST>
  __device__ void vA(const float* v, float* out, float* part) const {
    vecmat<PR>(v, A, m, n, out, part);
  }
  template <int PR = PREC_HIGHEST>
  __device__ void vP(const float* v, float* out, float* part) const {
    vecmat<PR>(v, P, n, n, out, part);
  }
  template <int PR = PREC_HIGHEST>
  __device__ void vK(const float* v, float* out, float* part) const {
    vecmat<PR>(v, K, n, n, out, part);
  }
};

// resident: Kinv dense in the shared slot, A and P compressed beside it
// (ar: A's rows, ac: A's columns, pc: P's columns); every product has the
// dense kernels' summation order, so both layouts give the same bits.
// These are the checks' products; one_iter calls the passes itself.
struct SparseOps {
  SegSet ar, ac, pc;
  const float* K;
  __device__ SparseOps(const Sparse& s, const float* K_, int n, int m)
      : ar{s.arp, s.pc, s.lng, s.pv, m, 0, *s.nlong},
        ac{s.acp, s.ci, nullptr, s.cv, n, m / GSPLIT, 0},
        pc{s.pcp, s.ci, nullptr, s.cv, n, n / GSPLIT, 0},
        K(K_) {}
  __device__ void Av(const float* x, float* out) const {
    rows_pass<PREC_HIGHEST>(ar, [=](int j) { return x[j]; },
                            [=](int i, float v) { out[i] = v; });
  }
  __device__ void vA(const float* v, float* out, float*) const {
    cols_pass<PREC_HIGHEST>(ac, [=](int i) { return v[i]; },
                            [=](int j, float w) { out[j] = w; });
  }
  __device__ void vP(const float* v, float* out, float*) const {
    cols_pass<PREC_HIGHEST>(pc, [=](int i) { return v[i]; },
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

// One ADMM iteration, its products at PR (stream layout: DenseOps)
template <int PR, class Ops>
static __device__ __forceinline__ void one_iter(const QPParams& p, Ctx& c, const Ops& op) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  for (int i = tid; i < m; i += NT) c.tm1[i] = c.rho[i] * c.z[i] - c.y[i];
  __syncthreads();
  op.template vA<PR>(c.tm1, c.tn1, c.part);
  for (int j = tid; j < n; j += NT) c.rhs[j] = p.sigma * c.x[j] - c.q[j] + c.tn1[j];
  __syncthreads();
  op.template vK<PR>(c.rhs, c.xt, c.part);
  for (int r = 0; r < p.refine_steps; ++r) {
    op.template Av<PR>(c.xt, c.tm1);
    for (int i = tid; i < m; i += NT) c.tm1[i] *= c.rho[i];
    __syncthreads();
    op.template vP<PR>(c.xt, c.tn1, c.part);
    op.template vA<PR>(c.tm1, c.tn2, c.part);
    for (int j = tid; j < n; j += NT)
      c.tn1[j] = c.rhs[j] - ((c.tn1[j] + p.sigma * c.xt[j]) + c.tn2[j]);
    __syncthreads();
    op.template vK<PR>(c.tn1, c.tn2, c.part);
    for (int j = tid; j < n; j += NT) c.xt[j] += c.tn2[j];
    __syncthreads();
  }
  op.template Av<PR>(c.xt, c.tm1);
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
// beside it). The two .Kinv products read their vector as vr, vt: at
// PREC_HIGHEST rhs and the refinement residual (tn1) themselves; at a
// lowered PR their packed splits (pack_split), which the epilogues that
// make the vectors write into tn2, which this layout's iteration leaves
// free.
template <int PR>
static __device__ __forceinline__ void one_iter(const QPParams& p, Ctx& c,
                                                const SparseOps& op) {
  const int n = p.n, tid = threadIdx.x;
  const float sigma = p.sigma, alpha = p.alpha, oma = p.one_m_alpha;
  // the context's pointers by value, so that the closures hold registers
  float *x = c.x, *xt = c.xt, *rhs = c.rhs, *tn1 = c.tn1, *tm1 = c.tm1,
        *z = c.z, *y = c.y;
  const float *q = c.q, *rho = c.rho, *rinv = c.rinv, *l = c.l, *u = c.u;
  float* vr = PR == PREC_HIGHEST ? rhs : c.tn2;
  float* vt = PR == PREC_HIGHEST ? tn1 : c.tn2;
  PHASE_START
  cols_pass<PR>(op.ac, [=](int i) { return rho[i] * z[i] - y[i]; },
                [=](int j, float s) {
                  const float r = sigma * x[j] - q[j] + s;
                  rhs[j] = r;
                  vr[j] = pack_split<PR>(r);
                });
  PHASE(PH_VA)
  vecmat4<PR>(vr, op.K, n, n, c.part, [=](int j, float s) { xt[j] = s; });
  PHASE(PH_VK)
  for (int r = 0; r < p.refine_steps; ++r) {
    rows_pass<PR>(op.ar, [=](int j) { return xt[j]; },
                  [=](int i, float s) { tm1[i] = s * rho[i]; });
    PHASE(PH_AV)
    cols_pass2<PR>(op.pc, [=](int i) { return xt[i]; }, op.ac,
                   [=](int i) { return tm1[i]; },
                   [=](int j, float px, float s) {
                     const float t = rhs[j] - ((px + sigma * xt[j]) + s);
                     tn1[j] = t;
                     vt[j] = pack_split<PR>(t);
                   });
    PHASE(PH_VP_VA)
    vecmat4<PR>(vt, op.K, n, n, c.part, [=](int j, float s) { xt[j] += s; });
    PHASE(PH_VK)
  }
  for (int j = tid; j < n; j += NT) x[j] = alpha * xt[j] + oma * x[j];
  rows_pass<PR>(op.ar, [=](int j) { return xt[j]; }, [=](int i, float s) {
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

// chunks of check_every iterations (their products at PR) until converged
// or budget iterations ran; sets iters on convergence (else leaves it
// unchanged)
template <int PR, class Ops>
static __device__ __forceinline__ void run_chunks(const QPParams& p, Ctx& c, const Ops& op,
                                  float c_inv, int budget, int it_base,
                                  float exit_pri, bool& done, int& iters,
                                  float& pri, float& dua) {
  const int ce = p.check_every;
  const int n_chunks = max((budget + ce - 1) / ce, 1);
  for (int k = 0; k < n_chunks && !done; ++k) {
    const int this_chunk = min(ce, budget - k * ce);
    for (int t = 0; t < this_chunk; ++t) one_iter<PR>(p, c, op);
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
// entry check, then run_chunks at fixed rho, its products at PR; writes x,
// z, y, (pri, dua), (iters, done, needs-rescue) and the streamed flag,
// counting a streamed scenario in *streamed.
template <int PR, class Ops>
static __device__ __forceinline__ void admm_loop(const QPParams& p, Ctx& c, int b,
                                 const Ops& op, float c_inv, bool stream,
                                 float* xo, float* zo, float* yo,
                                 float* stats, int* flags, int* streamed) {
  float pri, dua;
  bool done = residuals(p, c, op, c_inv, pri, dua);   // entry check
  int iters = done ? 0 : p.max_iter;
  run_chunks<PR>(p, c, op, c_inv, p.max_iter, 0, -INFINITY, done, iters,
                 pri, dua);
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
// the Newton-Schulz prologue's product core (B4; B1's rescue)
// ---------------------------------------------------------------------------
// A CTA computes an n x n product over the whole output in registers: the
// output is cut into 8 x 8 cells, one per thread, each cell's rows and
// columns two groups of four (4 ci.. and 4 cr + 4 ci.. rows, 4 cj.. and
// 4 cells + 4 cj.. columns), so that a thread reads its operands as four
// float4 per k and neighbouring threads read neighbouring 16 bytes. The
// rows come in passes of cr row cells, as many as 15 warps hold (one pass
// up to n = 168: at n = 146, 19 x 19 cells, 361 threads, 152 x 152
// outputs). The warps past the cells' are the producers: they stage the
// contraction in slabs of PK k-values into shared memory by 4-byte
// cp.async (any alignment, zero-filled out of range), in two buffers, so
// slab s + 1 loads while the cell warps multiply slab s, one barrier per
// slab; the cell warps keep no load state in their registers. Every output
// is one fmaf chain over k = 0..kd-1 in order (padded k terms are
// fmaf(0, 0, acc)), as in the 64 x 64-tiled GEMM this core replaced, whose
// epilogue operations it keeps (pinned below), so the products keep its
// bits.
static __device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                                 bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes (L2 only) and 8 bytes: both ends aligned to their size
static __device__ __forceinline__ void cp_async16(float* dst,
                                                  const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

static __device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                                 bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

static __device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

enum { OP_K = 0, OP_RESID = 1, OP_UPDATE = 2 };

static __device__ __forceinline__ unsigned cluster_reg_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

static __device__ __forceinline__ unsigned cluster_reg_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

static __device__ __forceinline__ unsigned cluster_reg_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// every thread of the cluster: what each wrote before (global or shared
// memory) is seen by every thread after
static __device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at p in the shared memory of the cluster's CTA `rank`
static __device__ __forceinline__ float cluster_ld(const float* p,
                                                  unsigned rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

// The Newton-Schulz prologue's functions below take a CTA's share of each
// product from the cluster it runs in: the whole matrix outside a cluster
// (B4, and B1's rescue at one CTA a lane), on a cluster of c CTAs (B1's
// rescue) the rows [*r0, *r1) of rescue_band (returns c).
static __device__ __forceinline__ int cta_band(int n, int* r0, int* r1) {
  const int c = (int)cluster_reg_size();
  rescue_band(n, c, (int)cluster_reg_rank(), r0, r1);
  return c;
}

// after a band's product: on a cluster, a barrier so that the next product
// of every CTA reads the whole output (one CTA: the product's own closing
// barrier does)
static __device__ __forceinline__ void band_sync() {
  if (cluster_reg_size() > 1) cluster_sync();
}

// max|R| of the whole matrix from each CTA's band max mx (nanmax: any
// order gives the same value), behind the barrier that completes R; red:
// the block reductions' scratch, whose float 2 NT / 32 (past
// block_maxsum's) carries the band's max to the cluster
static __device__ __forceinline__ float band_max(float mx, float* red) {
  const int c = (int)cluster_reg_size();
  if (c == 1) return mx;
  float* slot = red + 2 * (NT / 32);
  if (threadIdx.x == 0) *slot = mx;
  cluster_sync();
  float a = cluster_ld(slot, 0);
  for (int r = 1; r < c; ++r) a = nanmax(a, cluster_ld(slot, r));
  return a;
}

// C = epi(a . b) over the n x n outputs (the rows of the CTA's band,
// cta_band), k < kd:
//   OP_K:      a(i,k) = L[k n + i], b(k,j) = Rm[k n + j] * rho[k],
//              C = (acc * s + E1) + (i == j ? sigma : 0)     (E1 = P)
//   OP_RESID:  a(i,k) = L[i n + k], b(k,j) = Rm[k n + j],
//              C = (i == j) - acc; returns the band's max|C|
//              (block-uniform)
//   OP_UPDATE: the same operands, C = E1 + acc                (E1 = X)
// stage: prologue_floats(n) of shared memory; clk (phase builds): B4's
// clocks (FPH_*), or nullptr.
template <int OP>
static __device__ float product(int n, int kd, const float* L,
                                const float* Rm, const float* rho, float s,
                                const float* E1, float sigma, float* C,
                                float* stage, float* red, long long* clk) {
  int rbeg, rend;
  cta_band(n, &rbeg, &rend);
  const Geo g = geo(n, rend - rbeg);
  const int tid = threadIdx.x, np = 8 * g.cells, mb = 8 * g.cr;
  const int busy = g.cr * g.cells, p0 = (busy + 31) & ~31;
  const int nslab = (kd + PK - 1) / PK;
  const int buf = PK * (g.sa + np);
  float mx = 0.f;
  TSTART
  if (tid >= p0) {
    // producers: slab sl into buffer sl & 1, each thread every nprod-th
    // element (stepping, no division per element); the right operand's
    // rows in copies of vec floats where n and Rm allow
    const int pt = tid - p0, nprod = NT - p0;
    const uintptr_t ra = reinterpret_cast<uintptr_t>(Rm);
    const int vec = n % 4 == 0 && (ra & 15) == 0  ? 4
                    : n % 2 == 0 && (ra & 7) == 0 ? 2
                                                  : 1;
    for (int pass = 0; pass < g.passes; ++pass) {
      const int r0 = rbeg + pass * mb;
      __syncthreads();   // the last product's outputs are written
      for (int sl = 0; sl <= nslab; ++sl) {
        if (sl > 0) {
          cp_async_wait_all();
          __syncthreads();   // slab sl - 1 landed; buffer sl & 1 is free
          TMARK(clk, FPH_P_WAIT, tid == p0)
        }
        if (sl == nslab) break;
        float* as = stage + (sl & 1) * buf;
        float* bs = as + PK * g.sa;
        const int k0 = sl * PK;
        if (OP == OP_K) {   // rows of A, as they lie
          int kk = pt / mb, i = pt % mb;
          for (int e = pt; e < PK * mb; e += nprod) {
            const int row = r0 + i, k = k0 + kk;
            const bool ok = row < rend && k < kd;
            cp_async4(as + kk * g.sa + i, ok ? L + (size_t)k * n + row : L,
                      ok);
            for (i += nprod; i >= mb; i -= mb) ++kk;
          }
        } else {            // 16 k-values of a row, transposed
          for (int e = pt; e < PK * mb; e += nprod) {
            const int i = e / PK, kk = e % PK, row = r0 + i, k = k0 + kk;
            const bool ok = row < rend && k < kd;
            cp_async4(as + kk * g.sa + i, ok ? L + (size_t)row * n + k : L,
                      ok);
          }
        }
        if (vec > 1) {   // vec floats a copy: n and np are multiples
          for (int e = vec * pt; e < PK * np; e += vec * nprod) {
            const int kk = e / np, j = e - kk * np, k = k0 + kk;
            const bool ok = j < n && k < kd;
            const float* src = ok ? Rm + (size_t)k * n + j : Rm;
            if (vec == 4)
              cp_async16(bs + e, src, ok);
            else
              cp_async8(bs + e, src, ok);
          }
        } else {
          int kk = pt / np, j = pt % np;
          for (int e = pt; e < PK * np; e += nprod) {
            const int k = k0 + kk;
            const bool ok = j < n && k < kd;
            cp_async4(bs + e, ok ? Rm + (size_t)k * n + j : Rm, ok);
            for (j += nprod; j >= np; j -= np) ++kk;
          }
        }
        cp_async_commit();
        TMARK(clk, FPH_P_ISSUE, tid == p0)
      }
    }
  } else {
    // consumers: the cells (threads of the last cell warp past busy idle)
    const int ci = tid / g.cells, cj = tid % g.cells;
    const bool act = tid < busy;
    for (int pass = 0; pass < g.passes; ++pass) {
      const int r0 = rbeg + pass * mb;
      __syncthreads();
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
      for (int sl = 0; sl < nslab; ++sl) {
        __syncthreads();   // slab sl landed
        TMARK(clk, FPH_C_WAIT, tid == 0)
        if (!act) continue;
        const float* as = stage + (sl & 1) * buf + 4 * ci;
        const float* bs = stage + (sl & 1) * buf + PK * g.sa + 4 * cj;
        // not unrolled: an unrolled slab's addresses and fragments spill
        // the 64 accumulators' neighbours (-Xptxas -v), for no gain
#pragma unroll 1
        for (int kk = 0; kk < PK; ++kk) {
          const float4 a0 = ld4(as), a1 = ld4(as + 4 * g.cr);
          float4 b0 = ld4(bs), b1 = ld4(bs + 4 * g.cells);
          as += g.sa;
          bs += np;
          if (OP == OP_K) {
            const int k = sl * PK + kk;
            const float rk = k < kd ? rho[k] : 0.f;
            b0 = make_float4(__fmul_rn(b0.x, rk), __fmul_rn(b0.y, rk),
                             __fmul_rn(b0.z, rk), __fmul_rn(b0.w, rk));
            b1 = make_float4(__fmul_rn(b1.x, rk), __fmul_rn(b1.y, rk),
                             __fmul_rn(b1.z, rk), __fmul_rn(b1.w, rk));
          }
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              acc[r][q] = fmaf(a[r], bv[q], acc[r][q]);
        }
        TMARK(clk, FPH_C_MATH, tid == 0)
      }
      if (!act) continue;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = r0 + (r < 4 ? 4 * ci + r : 4 * g.cr + 4 * ci + r - 4);
        if (i >= rend) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = q < 4 ? 4 * cj + q : 4 * g.cells + 4 * cj + q - 4;
          if (j >= n) continue;
          const size_t ij = (size_t)i * n + j;
          float v;
          if (OP == OP_K) {
            v = __fadd_rn(__fmaf_rn(acc[r][q], s, E1[ij]),
                          i == j ? sigma : 0.f);
          } else if (OP == OP_RESID) {
            v = __fsub_rn(i == j ? 1.f : 0.f, acc[r][q]);
            mx = nanmax(mx, fabsf(v));
          } else {
            v = __fadd_rn(E1[ij], acc[r][q]);
          }
          C[ij] = v;
        }
      }
      TMARK(clk, FPH_C_EPI, tid == 0)
    }
  }
  if (OP == OP_RESID) {
    float unused = 0.f;
    block_maxsum(mx, unused, red);
  } else {
    __syncthreads();
  }
  return mx;
}

// sum of the squares of R (n x n at row pitch ld) in the replaced GEMM's
// order: each thread its 2 x 4 entries of every 64 x 64 tile, fused as
// sq += v * v, then block_maxsum; the warm tests' Frobenius norms keep
// their bits
static __device__ float frob_sq(int n, const float* R, float* red, int ld) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float mx = 0.f, sq = 0.f;
  for (int i0 = 0; i0 < n; i0 += 64)
    for (int j0 = 0; j0 < n; j0 += 64)
      for (int r = 0; r < 2; ++r)
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + tr * 2 + r, j = j0 + tc * 4 + q;
          if (i >= n || j >= n) continue;
          const float v = R[(size_t)i * ld + j];
          sq = __fmaf_rn(v, v, sq);
        }
  block_maxsum(mx, sq, red);
  return sq;
}

static __device__ float frob_sq(int n, const float* R, float* red) {
  return frob_sq(n, R, red, n);
}

// K = (A' (rho A)) s + P + sigma I (the band's rows), then the Jacobi
// diagonal dg = 1 / max(diag K, 1e-12); returns max(|I - K diag(dg)|_F,
// 1). The diagonal and the Frobenius sum are each CTA's own, over the
// whole K in one thread order, so every CTA of a cluster holds the same.
static __device__ float k_jacobi(const QPParams& p, Ctx& c, const float* P,
                                 const float* A, float s, float* K, float* dg,
                                 float* stage, long long* clk) {
  const int n = p.n, m = p.m, tid = threadIdx.x;
  product<OP_K>(n, m, A, A, c.rho, s, P, p.sigma, K, stage, c.red, clk);
  band_sync();
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

// X = Jacobi init diag(dg) / max(cj, 1), the band's rows
static __device__ void write_jacobi(int n, const float* dg, float cjm,
                                    float* X) {
  int r0, r1;
  cta_band(n, &r0, &r1);
  for (size_t e = (size_t)r0 * n + threadIdx.x; e < (size_t)r1 * n;
       e += NT) {
    const int i = (int)(e / n), j = (int)(e % n);
    X[e] = i == j ? dg[i] / cjm : 0.f;
  }
  __syncthreads();
  band_sync();
}

// Newton-Schulz passes X <- X + X (I - K X) from r = inf while r > tol and
// it < max; the 128-pad block is the scalar xp. Returns the last residual
// and the iterations in *iters; X / Y are swapped so that X holds the
// result. clk (phase builds): B4's clocks, or nullptr. On a cluster each
// CTA writes its band of R and of the update, and all take the same r.
static __device__ float ns_run(const QPParams& p, int n, const float* K,
                               float*& X, float*& Y, float* R, float& xp,
                               float* stage, float* red, int* iters,
                               long long* clk) {
  float r = INFINITY;
  int it = 0;
  TSTART
  while (r > p.ns_tol && it < p.ns_max_iters) {
    float mx = product<OP_RESID>(n, n, K, X, nullptr, 1.f, nullptr, 0.f, R,
                                 stage, red, clk);
    mx = band_max(mx, red);
    TMARK(clk, FPH_NS_RESID, threadIdx.x == 0)
    if (p.n_pad) mx = nanmax(mx, fabsf(1.f - xp));
    product<OP_UPDATE>(n, n, X, R, nullptr, 1.f, X, 0.f, Y, stage, red, clk);
    band_sync();
    TMARK(clk, FPH_NS_UPDATE, threadIdx.x == 0)
    float* t = X; X = Y; Y = t;
    r = mx;
    xp = xp + xp * (1.f - xp);
    ++it;
  }
  *iters = it;
  return r;
}

static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}
