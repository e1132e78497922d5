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
// (64 KB at K=4, T=512), read once, and every query takes a distance to
// each valid row (~N x K x T x 16 flops): a few us of HBM traffic for the
// batch. What
// sets the time is the latency of the per-query work on the SM, so the
// design cuts the dependent steps and fits the batch into one wave:
// - one CTA per scenario, one warp per horizon query; at most 64
//   registers a thread (the launch bound), so two CTAs of 14 warps share
//   an SM and 256 scenarios run in one wave on 132 SMs;
// - each stored lap (x and u, T x 8 floats) is staged once per CTA by
//   bulk asynchronous copies on an mbarrier, into one of two buffers, so
//   lap k+1 lands while lap k is searched; the 14 warps read the lap from
//   shared memory;
// - selection without rescans: each lane keeps the sorted top-knn of its
//   T/32 candidates (distance, then index) in registers, and each of the
//   knn rounds is two warp-wide min-reductions over the lanes' heads
//   (distance, then index among equal distances); the winner's lane pops
//   its head. Once no finite distance is left, a round takes row 0 at
//   distance +inf, as the arg-min over all-infinite distances does
//   (a NaN distance never wins);
// - the normal equations are split over the lanes: lane i sums entries i
//   and i + 32 of the 45 (two 5x5 upper triangles and three right-hand
//   sides) over the picks in the same order (lap 0 round 0 ... lap K-1
//   round knn-1) with the same unfused multiplies and adds, reading a
//   per-warp record of the picks (lane r gathers round r's row and its
//   successor from the staged lap);
// - Gauss-Jordan runs on the 65 entries of the two augmented systems in
//   shared memory, an entry (or three) per lane, each with the one-thread
//   elimination's operations; lane 0 then writes the kinematic rows.
// So every output has the bits of the one-warp-per-query kernel before
// it (the output checksums of runtime/kernel_bench.py --load).
//
// knn_max above RL_MAX_KNN (a lane's list could run dry) takes a second
// instance of the same kernel, sysid_kernel<true>: each round rescans the
// lane's candidates for the smallest (distance, index) after the last pick,
// which selects the same rows in the same order, and the picks are
// recorded and summed in chunks of 32 rounds (a warp's scratch holds 32
// records).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "rl_phases.cuh"

#define RL_MAX_SEG 16
#define RL_MAX_KNN 7                      // the picks a lane's list holds
#define RL_WARP_FLOATS (RL_MAX_KNN * 10)  // a warp's scratch (>= 65)
#define RL_CHUNK 32                       // rounds a rescan records at once
#define FULL 0xffffffffu

// phases of warp 0 of scenario 0 (-DRL_PHASES)
enum { SP_STAGE, SP_DIST, SP_SELECT, SP_ACCUM, SP_GJ, SP_KIN, SP_N };
RL_PHASE_DECL(rl_sysid_phase, SP_N)

struct SysidParams {
  int K, T, N, knn, empty, nseg, nbuf;
  float h, reg, dt, L;
  float scal[5];
  float s0[RL_MAX_SEG];
  float curv[RL_MAX_SEG];
};

// ---------------------------------------------------------------------------
// dynamic shared memory, in bytes (ops/cuda_sysid.py:plan mirrors it):
//   [2 mbarriers (16) | segment table s0, curv (128) | 16 spare]
//   [nbuf lap buffers of T x 8 floats: x (T x 6) then u (T x 2)]
//   [N x warp_floats(knn): each warp's picks of a lap (weight and the nine
//    features of each), then its two augmented systems, Mv (5x6) and
//    Ml (5x7)]
// ---------------------------------------------------------------------------
struct SysidSmem {
  size_t lap, gj, total;
};

// a warp's scratch: RL_MAX_KNN records, or a rescan's chunk of records
static __host__ __device__ inline int warp_floats(int knn) {
  return knn <= RL_MAX_KNN ? RL_WARP_FLOATS
                           : 10 * (knn < RL_CHUNK ? knn : RL_CHUNK);
}

static __host__ __device__ inline SysidSmem sysid_smem(int T, int N,
                                                        int nbuf, int knn) {
  SysidSmem s;
  s.lap = 160;
  s.gj = s.lap + (size_t)nbuf * T * 8 * sizeof(float);
  s.total = s.gj + (size_t)N * warp_floats(knn) * sizeof(float);
  return s;
}

// one thread: lap k of scenario b (x: T x 6, u: T x 2 floats; 16-byte
// aligned because T is even and the store is) into buf, completing on bar
static __device__ void lap_copy(float* buf, const float* sx, const float* su,
                                int b, int k, int K, int T, uint64_t* bar) {
  const uint32_t xb = (uint32_t)T * 24u, ub = (uint32_t)T * 8u;
  // the buffer's last reads (generic proxy) come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(bar, xb + ub);
  const size_t lap = (size_t)b * K + k;
  bulk_load(buf, sx + lap * T * 6, xb, bar);
  bulk_load(buf + (size_t)T * 6, su + lap * T * 2, ub, bar);
}

// ---- selection ------------------------------------------------------------
// insert (d, t) into the ascending list (ld, lt), dropping its last entry;
// t exceeds every index already listed, so d goes after equal distances.
// +inf and NaN never enter.
template <int L>
static __device__ __forceinline__ void insert(float (&ld)[L], int (&lt)[L],
                                              float d, int t) {
#pragma unroll
  for (int i = L - 1; i > 0; --i) {
    const bool below = d < ld[i - 1], here = d < ld[i];
    ld[i] = below ? ld[i - 1] : (here ? d : ld[i]);
    lt[i] = below ? lt[i - 1] : (here ? t : lt[i]);
  }
  const bool here = d < ld[0];
  ld[0] = here ? d : ld[0];
  lt[0] = here ? t : lt[0];
}

template <int L>
static __device__ __forceinline__ void pop(float (&ld)[L], int (&lt)[L]) {
#pragma unroll
  for (int i = 0; i + 1 < L; ++i) {
    ld[i] = ld[i + 1];
    lt[i] = lt[i + 1];
  }
  ld[L - 1] = INFINITY;
}

// ---- normal equations -----------------------------------------------------
// Entry e of the 45: Qv (e < 15) and Ql (e < 30), the upper triangles
// (a <= c) of the vx and lateral normal matrices; bv (e < 35) and bl (the
// two lateral right-hand sides, interleaved). Its term per pick is
// (w * feature f1) * feature f2, and it lands at m1 (and its mirror m2) of
// the warp's Mv (5x6) / Ml (5x7, from float 30). Features of a pick (row
// t, successor sc), at 1 + f of its record (the weight at 0): 0-2 vx, vy,
// wz of t; 3-4 delta, a of t; 5 the constant 1; 6-8 vx, vy, wz of sc.
// mv = [vx, vy, wz, a, 1], ml = [vx, vy, wz, delta, 1].
struct Entry {
  int f1, f2, m1, m2;
  bool mat, diag;   // a normal-matrix entry; on its diagonal
};

static __device__ __forceinline__ int tri0(int a) {  // tri(a, a)
  return a * 5 - a * (a - 1) / 2;
}

static __device__ Entry entry_of(int e) {
  Entry n;
  n.mat = e < 30;
  n.diag = false;
  if (n.mat) {
    const bool v = e < 15;
    const int i = v ? e : e - 15;
    int a = 0;
    while (i >= tri0(a + 1)) ++a;
    const int c = a + i - tri0(a);
    n.f1 = v ? (a < 3 ? a : a + 1) : (a < 4 ? a : 5);
    n.f2 = v ? (c < 3 ? c : c + 1) : (c < 4 ? c : 5);
    const int W = v ? 6 : 7, base = v ? 0 : 30;
    n.m1 = base + a * W + c;
    n.m2 = base + c * W + a;
    n.diag = a == c;
  } else if (e < 35) {
    const int a = e - 30;
    n.f1 = a < 3 ? a : a + 1;
    n.f2 = 6;
    n.m1 = n.m2 = a * 6 + 5;
  } else {
    const int a = (e - 35) / 2, y = (e - 35) % 2;
    n.f1 = a < 4 ? a : 5;
    n.f2 = 7 + y;
    n.m1 = n.m2 = 30 + a * 7 + 5 + y;
  }
  return n;
}

// scaled-L1 distance of row t of the staged lap (lx, lu) to the query z
static __device__ __forceinline__ float dist_of(const float* lx,
                                                const float* lu, int t,
                                                const float (&z)[5],
                                                const float (&scal)[5]) {
  const float2 xy = *reinterpret_cast<const float2*>(lx + t * 6);
  const float2 du = *reinterpret_cast<const float2*>(lu + t * 2);
  const float f[5] = {xy.x, xy.y, lx[t * 6 + 2], du.x, du.y};
  float dist = 0.f;
#pragma unroll
  for (int j = 0; j < 5; ++j)
    dist = __fadd_rn(dist, fabsf(__fmul_rn(f[j] - z[j], scal[j])));
  return dist;
}

// a pick's record: its weight and nine features (row, successor)
static __device__ __forceinline__ void record(float* rec, const float* lx,
                                              const float* lu, int sel_t,
                                              float sel_d, int T, float h) {
  const float q = sel_d / h;
  const float wgt = sel_d < h
      ? __fmul_rn(0.75f, __fsub_rn(1.0f, __fmul_rn(q, q))) : 0.0f;
  const int sc = sel_t + 1 < T ? sel_t + 1 : T - 1;
  rec[0] = wgt;
  rec[1] = lx[sel_t * 6 + 0];
  rec[2] = lx[sel_t * 6 + 1];
  rec[3] = lx[sel_t * 6 + 2];
  rec[4] = lu[sel_t * 2 + 0];
  rec[5] = lu[sel_t * 2 + 1];
  rec[6] = 1.0f;
  rec[7] = lx[sc * 6 + 0];
  rec[8] = lx[sc * 6 + 1];
  rec[9] = lx[sc * 6 + 2];
}

// this lane's entries summed over the n records in round order, with
// unfused multiplies and adds: the plain version's rounding, operation for
// operation (these 5x5 systems are near singular when stored laps repeat,
// so contraction differences would be amplified)
static __device__ __forceinline__ void accumulate(float& acc0, float& acc1,
                                                  const float* gw, int n,
                                                  const Entry& e0,
                                                  const Entry& e1, bool two) {
  for (int r = 0; r < n; ++r) {
    const float* rec = gw + r * 10;
    acc0 = __fadd_rn(acc0, __fmul_rn(__fmul_rn(rec[0], rec[1 + e0.f1]),
                                     rec[1 + e0.f2]));
    if (two)
      acc1 = __fadd_rn(acc1, __fmul_rn(__fmul_rn(rec[0], rec[1 + e1.f1]),
                                       rec[1 + e1.f2]));
  }
}

template <bool RESCAN>
__global__ void __launch_bounds__(1024, 1)
sysid_kernel(const SysidParams p, const float* __restrict__ sx,
             const float* __restrict__ su, const int* __restrict__ steps,
             const float* __restrict__ xq, const float* __restrict__ uq,
             float* __restrict__ outA, float* __restrict__ outB,
             float* __restrict__ outC) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int T = p.T, K = p.K, nbuf = p.nbuf;
  const SysidSmem lay = sysid_smem(T, p.N, nbuf, p.knn);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* ts0 = reinterpret_cast<float*>(sm + 16);
  float* tcv = ts0 + RL_MAX_SEG;
  float* laps = reinterpret_cast<float*>(sm + lay.lap);
  const int b = blockIdx.x;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* gw = reinterpret_cast<float*>(sm + lay.gj) +
              w * (RESCAN ? warp_floats(p.knn) : RL_WARP_FLOATS);
  RL_PHASE_START(b == 0 && threadIdx.x == 0)

  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  if (threadIdx.x < RL_MAX_SEG) {
    ts0[threadIdx.x] = p.s0[threadIdx.x];
    tcv[threadIdx.x] = p.curv[threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < nbuf && k < K; ++k)
      lap_copy(laps + (size_t)k * T * 8, sx, su, b, k, K, T, &bar[k]);

  const float* xqq = xq + ((size_t)b * p.N + w) * 6;
  const float* uqq = uq + ((size_t)b * p.N + w) * 2;
  const float z[5] = {xqq[0], xqq[1], xqq[2], uqq[0], uqq[1]};
  float scal[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) scal[j] = p.scal[j];
  const Entry e0 = entry_of(lane);
  const bool two = lane + 32 < 45;
  const Entry e1 = entry_of(two ? lane + 32 : lane);
  float acc0 = 0.f, acc1 = 0.f;

  for (int k = 0; k < K; ++k) {
    const float* lx = laps + (size_t)(k % nbuf) * T * 8;
    const float* lu = lx + (size_t)T * 6;
    mbar_wait(&bar[k % nbuf], (uint32_t)(k / nbuf) & 1u);
    RL_PHASE(rl_sysid_phase, SP_STAGE, lx[lane])

    const int st = steps[b * K + k];
    const int nvalid = st < p.empty ? (st < T ? st : T) - 1 : 0;
    if (!RESCAN) {
      // distances of this lane's candidates t = lane, lane + 32, ... into
      // its sorted list; the invalid ones (rows steps-1 on, empty laps)
      // would enter at +inf, which never enters
      float ld[RL_MAX_KNN];
      int lt[RL_MAX_KNN];
#pragma unroll
      for (int i = 0; i < RL_MAX_KNN; ++i) {
        ld[i] = INFINITY;
        lt[i] = 0;
      }
      for (int t = lane; t < nvalid; t += 32)
        insert(ld, lt, dist_of(lx, lu, t, z, scal), t);
      RL_PHASE(rl_sysid_phase, SP_DIST, ld[0])

      // knn rounds: the smallest head (distance bits, non-negative floats
      // order as unsigned), then the smallest index among equal heads;
      // lane r keeps round r's pick
      int sel_t = 0;
      float sel_d = INFINITY;
      for (int r = 0; r < p.knn; ++r) {
        const unsigned hd = __float_as_uint(ld[0]);
        const unsigned md = __reduce_min_sync(FULL, hd);
        int pick = 0;
        if (md < 0x7f800000u) {
          pick = (int)__reduce_min_sync(FULL, hd == md ? (unsigned)lt[0]
                                                       : 0xffffffffu);
          if (lane == (pick & 31)) pop(ld, lt);
        }
        if (lane == r) {
          sel_t = pick;
          sel_d = __uint_as_float(md);
        }
      }
      RL_PHASE(rl_sysid_phase, SP_SELECT, sel_d)

      // lane r < knn gathers round r's record from the staged lap
      if (lane < p.knn) record(gw + lane * 10, lx, lu, sel_t, sel_d, T, p.h);
      __syncwarp();
      accumulate(acc0, acc1, gw, p.knn, e0, e1, two);
    } else {
      // each round: every lane's smallest (distance, index) after the last
      // pick (pd, pt), then the same two warp-wide min-reductions; after
      // the last finite distance, row 0 at +inf as above
      float pd = -1.0f;
      int pt = -1;
      for (int r0 = 0; r0 < p.knn; r0 += RL_CHUNK) {
        const int n = p.knn - r0 < RL_CHUNK ? p.knn - r0 : RL_CHUNK;
        int sel_t = 0;
        float sel_d = INFINITY;
        for (int r = 0; r < n; ++r) {
          float bd = INFINITY;
          int bt = 0;
          for (int t = lane; t < nvalid; t += 32) {
            const float d = dist_of(lx, lu, t, z, scal);
            if ((d > pd || (d == pd && t > pt)) && d < bd) {
              bd = d;
              bt = t;
            }
          }
          const unsigned hd = __float_as_uint(bd);
          const unsigned md = __reduce_min_sync(FULL, hd);
          int pick = 0;
          if (md < 0x7f800000u)
            pick = (int)__reduce_min_sync(FULL, hd == md ? (unsigned)bt
                                                         : 0xffffffffu);
          pd = __uint_as_float(md);
          pt = pick;
          if (lane == r) {
            sel_t = pick;
            sel_d = pd;
          }
        }
        // lane r < n records round r0 + r; the chunk is summed before the
        // next one overwrites the records
        if (lane < n) record(gw + lane * 10, lx, lu, sel_t, sel_d, T, p.h);
        __syncwarp();
        accumulate(acc0, acc1, gw, n, e0, e1, two);
        __syncwarp();
      }
    }
    RL_PHASE(rl_sysid_phase, SP_ACCUM, acc0 + acc1)
    __syncthreads();   // every warp is done with this buffer
    if (threadIdx.x == 0 && k + nbuf < K)
      lap_copy(laps + (size_t)(k % nbuf) * T * 8, sx, su, b, k + nbuf, K, T,
               &bar[k % nbuf]);
  }

  // the two augmented systems: normal matrix + ridge on the diagonal,
  // right-hand sides in the last columns
  const float v0 = e0.mat ? acc0 + (e0.diag ? p.reg : 0.f) : acc0;
  gw[e0.m1] = v0;
  gw[e0.m2] = v0;
  if (two) {
    const float v1 = e1.mat ? acc1 + (e1.diag ? p.reg : 0.f) : acc1;
    gw[e1.m1] = v1;
    gw[e1.m2] = v1;
  }
  __syncwarp();

  // Gauss-Jordan, diagonal pivots, the reference's elimination order:
  // lane i updates entries i, i + 32, i + 64 of [Mv | Ml]
  for (int k = 0; k < 5; ++k) {
    float nv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int e = lane + 32 * i;
      if (e >= 65) continue;
      const int base = e < 30 ? 0 : 30, W = e < 30 ? 6 : 7;
      const int r = (e - base) / W, c = (e - base) % W;
      const float* M = gw + base;
      const float row = M[k * W + c] / M[k * W + k];
      nv[i] = r == k ? row
                     : __fsub_rn(M[r * W + c], __fmul_rn(M[r * W + k], row));
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int e = lane + 32 * i;
      if (e < 65) gw[e] = nv[i];
    }
    __syncwarp();
  }
  RL_PHASE(rl_sysid_phase, SP_GJ, gw[lane])

  if (lane != 0) return;
  const float(*Mv)[6] = reinterpret_cast<const float(*)[6]>(gw);
  const float(*Ml)[7] = reinterpret_cast<const float(*)[7]>(gw + 30);
  float xv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xv[i] = xqq[i];
  // kinematic rows (constant-curvature Jacobian at the query)
  const float vx = xv[0], vy = xv[1], wz = xv[2], epsi = xv[3], s = xv[4], ey = xv[5];
  const float sw = s > p.L ? s - p.L * floorf(s / p.L) : s;
  int idx = -1;
  for (int i = 0; i < p.nseg; ++i) idx += (ts0[i] <= sw) ? 1 : 0;
  idx = idx < 0 ? 0 : (idx > p.nseg - 1 ? p.nseg - 1 : idx);
  const float cur = tcv[idx];
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
  RL_PHASE(rl_sysid_phase, SP_KIN, C[5])
}

// raises the instance's dynamic shared-memory limit to smem, once per size
// and device (each setting is a round trip to the CUDA runtime)
template <bool RESCAN>
static cudaError_t allow(size_t smem) {
  static size_t allowed[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  size_t& ok = allowed[dev & 15];
  if (smem <= ok) return cudaSuccess;
  e = cudaFuncSetAttribute(sysid_kernel<RESCAN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) ok = smem;
  return e;
}

template <bool RESCAN>
static int ctas_per_sm(int N, size_t smem) {
  int ctas = 0;
  if (allow<RESCAN>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, sysid_kernel<RESCAN>, N * 32, smem) != cudaSuccess)
    return -1;
  return ctas;
}

template <bool RESCAN>
static int launch(const SysidParams& p, const float* sx, const float* su,
                  const int* steps, const float* xq, const float* uq,
                  float* A, float* Bm, float* C, int B, void* stream) {
  const size_t smem = sysid_smem(p.T, p.N, p.nbuf, p.knn).total;
  const cudaError_t e = allow<RESCAN>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sysid_kernel<RESCAN><<<B, p.N * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, sx, su, steps, xq, uq, A, Bm, C);
  return static_cast<int>(cudaGetLastError());
}

// the dynamic shared memory of a launch, as the kernel counts it
extern "C" long long rl_sysid_smem_bytes(int T, int N, int nbuf, int knn) {
  return (long long)sysid_smem(T, N, nbuf, knn).total;
}

// CTAs per SM by the card's occupancy calculator (shared memory,
// registers, threads) for the instance knn takes
extern "C" int rl_sysid_ctas_per_sm(int T, int N, int nbuf, int knn) {
  const size_t smem = sysid_smem(T, N, nbuf, knn).total;
  return knn > RL_MAX_KNN ? ctas_per_sm<true>(N, smem)
                          : ctas_per_sm<false>(N, smem);
}

extern "C" int rl_sysid(SysidParams p, const float* sx, const float* su,
                        const int* steps, const float* xq, const float* uq,
                        float* A, float* Bm, float* C, int B, void* stream) {
  if (B <= 0) return 0;
  return p.knn > RL_MAX_KNN
             ? launch<true>(p, sx, su, steps, xq, uq, A, Bm, C, B, stream)
             : launch<false>(p, sx, su, steps, xq, uq, A, Bm, C, B, stream);
}

RL_PHASE_EXPORT(rl_sysid_phases, rl_sysid_phase, SP_N)
