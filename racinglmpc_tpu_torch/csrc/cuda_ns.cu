// The Newton-Schulz inverse of the QP prologue, one CTA per lane
// (ops/cuda_ns.py, called from ops/qp.py:_ns_inverse).
//
// Replaces no Pallas kernel: the reference leaves this loop to XLA's
// while_loop (racinglmpc_tpu/ops/qp.py:_ns_inverse), and the port ran it
// as a host loop of cuBLAS GEMMs, one nonzero() sync a pass. Here every
// lane runs its whole inverse on the device and exits on its own, with the
// plain version's gates (ops/cuda_ns.py:ns_inverse_plain):
//   Jacobi init d = 1 / max(diag K, 1e-12), Xj = diag(d) / max(|I - K d|_F, 1);
//   where warm_ok, R0 = I - K X0 and 12 power-iteration steps from 1/sqrt(n):
//     warm start where |R0 v| is finite and < 0.9 and max|R0| is finite;
//   runs of X <- X + X (I - K X) while r > level, r < 1e6, it < max_iters
//     (it reset at each level: max(0.3, tol), max(3e-2, tol), tol staged);
//   a restart from Jacobi where the first run ends non-finite or above
//     50 tol; the final squaring R2 = I - K X2, X2 + X2 R2 in float64,
//     taken where max|R2| (rounded to float32) is finite and < 1.
//
// Bound on this card. The work is the products: 4 n^3 operations a
// lane-iteration in float32 (full FMAs on the CUDA cores: the
// configuration states TF32 off, and no tensor-core split emulates it),
// ~3.3 ms a step at the main path's counts (n = 200, 256 lanes, ~25
// lane-iterations each) over 67 TFLOP/s; the bytes (K, X0 in, X out) are
// ~0.1 ms. Design:
//   - one CTA of 256 threads per lane (two warps a scheduler, so a thread
//     may hold 255 registers); each thread keeps 20 x 8 outputs of every
//     product in registers, so the whole n x n output is one pass, up to
//     n = 200 (every matrix padded to a multiple of 40, a compile-time
//     size, so the loops' offsets are immediates); the k loop runs over
//     slabs of 8 rows staged by cp.async three deep; per k, 7
//     shared-memory vector loads feed 160 FMAs;
//   - K^T stays in shared memory for the whole inverse (160 KB at
//     n = 200), so R = I - K X streams only X, and X + X R streams X^T and
//     R: every operand slab is a run of whole rows. X, X^T and R live in a
//     global workspace with zero padding the padded outputs keep zero; the
//     update writes X^T a row group at a time through shared memory (its
//     scattered 16-byte stores cost a third of the update);
//   - the warm gate's 12 power-iteration steps read R0's tile from
//     registers; max|R| and every gate are block reductions, so all
//     threads of a lane take the same branches: one launch an inverse, no
//     host sync;
//   - the float64 squaring stages its operands as doubles, in three passes
//     over the thread's row groups.
// The block scheduler hands a freed SM the next lane, so lanes of 20 and 80
// iterations share the card without a host round trip; a step lasts at
// least as long as its slowest lane. Sums run in k order per output
// (cuBLAS sums in another); NaN propagates through max|R| as in torch's
// amax.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the kernel's scalars (ops/cuda_ns.py:_Params)
struct NsParams {
  int n, max_iters, n_levels;
  float levels[3];   // each run's exit levels, as float32 compares them
  float bad;         // 50 tol: above it a first run restarts from Jacobi
  float v0;          // 1 / sqrt(n), the power iteration's start
};

namespace {

constexpr int KS = 8;        // k-values of a staged slab
constexpr int STAGES = 3;    // float32 slabs in flight (float64: two)
constexpr int RT = 20;       // rows of a thread's tile: 5 groups of 4
constexpr int NMAX = 200;    // 10 x 25 tiles of 20 x 8 at n = 200
constexpr int MAXT = 256;    // two warps a scheduler: 255 registers each

// every matrix of a lane is padded to np x np, np a multiple of 40
__host__ __device__ __forceinline__ int pad(int n) {
  return (n + 39) / 40 * 40;
}

// a lane's geometry: np (a multiple of 40, known at compile time, so every
// offset of the product loops is an immediate), n and this thread's tile:
// rows row0 + a + h q (a < 4, q < 5), columns col0 + c + w d (c < 4, d < 2)
template <int NP>
struct Geo {
  static constexpr int tj_n = NP / 8;              // column tiles
  static constexpr int h = NP / 5, w = NP / 2;     // group strides
  static constexpr int tiles = (NP / RT) * tj_n;
  static constexpr int threads = (tiles + 31) & ~31;
  static constexpr int slabs = NP / KS;
  int n;
  int tj;            // this thread's column tile
  int row0, col0;    // this thread's tile origin
  bool on;           // this thread owns a tile
};

template <int NP>
__device__ __forceinline__ Geo<NP> make_geo(int n) {
  Geo<NP> g;
  g.n = n;
  const int t = threadIdx.x;
  g.on = t < g.tiles;
  g.tj = g.on ? t % g.tj_n : 0;
  g.row0 = g.on ? 4 * (t / g.tj_n) : 0;
  g.col0 = 4 * g.tj;
  return g;
}

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ double nanmax64(double a, double b) {
  return (a != a || b != b) ? (double)NAN : fmax(a, b);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// block-wide reductions; every thread gets the result
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(~0u, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = nanmax(r, red[i]);
  return r;
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r += red[i];
  return r;
}

__device__ double block_max64(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax64(v, __shfl_xor_sync(~0u, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = nanmax64(r, red[i]);
  return r;
}

// ---- the products ----------------------------------------------------------
// Operands stream through shared memory in slabs of KS rows: A given
// transposed (row k holds column k of A; K^T resident in shared memory, or
// X^T from the workspace), B by rows; every row has np entries.

// ROWS rows of row_bytes each from src to dst, both rows row_bytes apart
template <int ROWS>
__device__ __forceinline__ void copy_rows(void* dst, const void* src,
                                          int row_bytes) {
  const int q = row_bytes >> 4;
  for (int c = threadIdx.x; c < ROWS * q; c += blockDim.x)
    cp_async16(static_cast<char*>(dst) + 16 * c,
               static_cast<const char*>(src) + 16 * c);
}

// slabs 0..slabs-1 in STG buffers: slab t + STG - 1 is copied while slab t
// is used; load(buffer, slab) starts its copies, use(buffer, slab) reads it
template <int STG, class Load, class Use>
__device__ __forceinline__ void pipeline(int slabs, Load load, Use use) {
#pragma unroll
  for (int s = 0; s < STG - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<STG - 2>();
    __syncthreads();
    const int tn = t + STG - 1;
    if (tn < slabs) load(tn % STG, tn);
    cp_async_commit();
    use(t % STG, t);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int NP>
__device__ __forceinline__ void mac_slab(const Geo<NP>& g, const float* as,
                                         const float* bs,
                                         float (&acc)[RT][8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    float a[RT], b[8];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float4 v = *reinterpret_cast<const float4*>(
          bs + kk * NP + g.col0 + d * g.w);
      b[4 * d] = v.x;
      b[4 * d + 1] = v.y;
      b[4 * d + 2] = v.z;
      b[4 * d + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          as + kk * NP + g.row0 + q * g.h);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
#pragma unroll
      for (int i = 4 * q; i < 4 * q + 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc = A B in float32, the thread's 20 x 8 outputs; At: K^T resident in
// shared memory (A_RES) or X^T in the workspace
template <bool A_RES, int NP>
__device__ __forceinline__ void gemm32(const Geo<NP>& g, const float* At,
                                       const float* Bg, float* stage,
                                       float (&acc)[RT][8]) {
  constexpr int sa = A_RES ? 0 : KS * NP;   // A's floats in a buffer
  constexpr int sf = sa + KS * NP;
  constexpr int rb = NP * (int)sizeof(float);
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  pipeline<STAGES>(
      g.slabs,
      [&](int s, int t) {
        float* st = stage + s * sf;
        if (!A_RES) copy_rows<KS>(st, At + (size_t)t * KS * NP, rb);
        copy_rows<KS>(st + sa, Bg + (size_t)t * KS * NP, rb);
      },
      [&](int s, int t) {
        const float* st = stage + s * sf;
        if (g.on)
          mac_slab(g, A_RES ? At + (size_t)t * KS * NP : st, st + sa, acc);
      });
}

// R = I - K X (padding 0) into the workspace, its tile left in acc;
// returns max|R| over the n x n block
template <int NP>
__device__ __forceinline__ float residual(const Geo<NP>& g, const float* KTs,
                                          const float* X, float* R,
                                          float* stage, float* red,
                                          float (&acc)[RT][8]) {
  gemm32<true>(g, KTs, X, stage, acc);
  float mx = 0.f;
  if (g.on) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = g.row0 + (i & 3) + (i >> 2) * g.h;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int col = g.col0 + d * g.w;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = (row == col + c) ? 1.f : 0.f;
          acc[i][4 * d + c] =
              (row < g.n && col + c < g.n) ? e - acc[i][4 * d + c] : 0.f;
          mx = nanmax(mx, fabsf(acc[i][4 * d + c]));
        }
        *reinterpret_cast<float4*>(R + (size_t)row * NP + col) =
            make_float4(acc[i][4 * d], acc[i][4 * d + 1], acc[i][4 * d + 2],
                        acc[i][4 * d + 3]);
      }
    }
  }
  return block_max(mx, red);
}

// Xn = X + X R and its transpose (padding 0). X^T goes out a row group at a
// time through shared memory, so both stores are whole rows.
template <int NP>
__device__ __forceinline__ void update(const Geo<NP>& g, const float* X,
                                       const float* XT, const float* R,
                                       float* Xn, float* XTn, float* stage) {
  constexpr int h = Geo<NP>::h, ts = h + 1;   // a staged column's stride
  float acc[RT][8];
  gemm32<false>(g, XT, R, stage, acc);
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    if (g.on) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int col = g.col0 + d * g.w;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int row = g.row0 + a + q * h;
          const float4 x =
              *reinterpret_cast<const float4*>(X + (size_t)row * NP + col);
          const float xv[4] = {x.x, x.y, x.z, x.w};
          float o[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            o[c] = (row < g.n && col + c < g.n)
                       ? xv[c] + acc[4 * q + a][4 * d + c]
                       : 0.f;
            stage[(col + c) * ts + g.row0 + a] = o[c];
          }
          *reinterpret_cast<float4*>(Xn + (size_t)row * NP + col) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NP * (h / 4); e += blockDim.x) {
      const int col = e / (h / 4), r4 = 4 * (e - col * (h / 4));
      const float* t = stage + col * ts + r4;
      *reinterpret_cast<float4*>(XTn + (size_t)col * NP + q * h + r4) =
          make_float4(t[0], t[1], t[2], t[3]);
    }
    __syncthreads();
  }
}

// acc = A B in float64 over G row groups from q0 (4 G x 8 of the thread's
// outputs): A float (K^T resident, or X^T staged), B float (X) or double
// (R2), converted as they are read; two buffers
template <bool A_RES, bool B64, int G, int NP>
__device__ __forceinline__ void gemm64_pass(const Geo<NP>& g, const float* At,
                                            const void* Bg, float* stage,
                                            int q0, double (&acc)[4 * G][8]) {
  constexpr int rb = NP * (int)sizeof(float);
  constexpr int bb = B64 ? 2 * rb : rb;
  constexpr int sa = A_RES ? 0 : KS * NP;            // floats
  constexpr int sf = sa + (B64 ? 2 : 1) * KS * NP;   // floats of a buffer
#pragma unroll
  for (int a = 0; a < 4 * G; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[a][j] = 0.0;
  pipeline<2>(
      g.slabs,
      [&](int s, int t) {
        float* st = stage + s * sf;
        if (!A_RES) copy_rows<KS>(st, At + (size_t)t * KS * NP, rb);
        copy_rows<KS>(st + sa,
                      static_cast<const char*>(Bg) + (size_t)t * KS * bb, bb);
      },
      [&](int s, int t) {
        if (!g.on) return;
        const float* st = stage + s * sf;
        const float* as = A_RES ? At + (size_t)t * KS * NP : st;
#pragma unroll 2
        for (int kk = 0; kk < KS; ++kk) {
          double a[4 * G], b[8];
#pragma unroll
          for (int gq = 0; gq < G; ++gq) {
            const float4 v = *reinterpret_cast<const float4*>(
                as + kk * NP + g.row0 + (q0 + gq) * g.h);
            a[4 * gq] = v.x;
            a[4 * gq + 1] = v.y;
            a[4 * gq + 2] = v.z;
            a[4 * gq + 3] = v.w;
          }
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int c0 = g.col0 + d * g.w;
            if (B64) {
              const double* bs = reinterpret_cast<const double*>(st + sa);
              const double2 u =
                  *reinterpret_cast<const double2*>(bs + kk * NP + c0);
              const double2 v =
                  *reinterpret_cast<const double2*>(bs + kk * NP + c0 + 2);
              b[4 * d] = u.x;
              b[4 * d + 1] = u.y;
              b[4 * d + 2] = v.x;
              b[4 * d + 3] = v.y;
            } else {
              const float4 v =
                  *reinterpret_cast<const float4*>(st + sa + kk * NP + c0);
              b[4 * d] = v.x;
              b[4 * d + 1] = v.y;
              b[4 * d + 2] = v.z;
              b[4 * d + 3] = v.w;
            }
          }
#pragma unroll
          for (int i = 0; i < 4 * G; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fma(a[i], b[j], acc[i][j]);
        }
      });
}

// the float64 squaring's two products over row groups {0, 1}, {2, 3}, {4}:
// epi(q0, acc) takes each pass's outputs
template <bool A_RES, bool B64, int NP, class Epi>
__device__ __forceinline__ void gemm64(const Geo<NP>& g, const float* At,
                                       const void* Bg, float* stage,
                                       Epi epi) {
  {
    double acc[8][8];
    gemm64_pass<A_RES, B64, 2>(g, At, Bg, stage, 0, acc);
    epi(0, acc);
  }
  {
    double acc[8][8];
    gemm64_pass<A_RES, B64, 2>(g, At, Bg, stage, 2, acc);
    epi(2, acc);
  }
  {
    double acc[4][8];
    gemm64_pass<A_RES, B64, 1>(g, At, Bg, stage, 4, acc);
    epi(4, acc);
  }
}

}  // namespace

// outside the anonymous namespace, so that profilers name it
template <int NP>
__global__ void __launch_bounds__(MAXT, 1)
ns_inverse_kernel(const NsParams p, const float* __restrict__ K,
                  const float* __restrict__ X0, const bool* warm_ok,
                  float* __restrict__ Xout, float* __restrict__ resid,
                  int* stats, float* __restrict__ ws, int* count) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float d_s[NMAX], v_s[NMAX], w_s[NMAX];
  __shared__ float red[32];
  __shared__ double red64[32];

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const Geo<NP> g = make_geo<NP>(p.n);
  const int n = g.n;
  constexpr size_t nn = (size_t)NP * NP;
  float* KTs = smem;
  float* stage = smem + nn;
  float* R = ws + (size_t)b * 5 * nn;
  // slot s: X at R + (1 + 2 s) nn, X^T right after it
  auto Xs = [&](int s) { return R + (1 + 2 * s) * nn; };
  auto XTs = [&](int s) { return R + (2 + 2 * s) * nn; };
  const float* Kb = K + (size_t)b * n * n;

  // Jacobi diagonal, K^T into shared memory, |I - K diag(d)|_F
  for (int i = tid; i < n; i += nt)
    d_s[i] = 1.f / clamp_min(Kb[(size_t)i * n + i], 1e-12f);
  __syncthreads();
  float part = 0.f;
  for (int i = warp; i < NP; i += nw)
    for (int j = lane; j < NP; j += 32) {
      const bool in = i < n && j < n;
      const float kv = in ? Kb[(size_t)i * n + j] : 0.f;
      KTs[(size_t)j * NP + i] = kv;
      if (in) {
        const float e = __fsub_rn(i == j ? 1.f : 0.f, __fmul_rn(kv, d_s[j]));
        part += __fmul_rn(e, e);
      }
    }
  const float cj = clamp_min(sqrtf(block_sum(part, red)), 1.f);

  // the Jacobi start over slot 0's X and X^T: diag(d) / cj written as
  // (I * d) / cj, so a NaN cj or d fills the lane with NaN as the plain
  // version's does
  auto jacobi = [&]() {
    float* X = Xs(0);
    float* XT = XTs(0);
    for (int i = warp; i < NP; i += nw)
      for (int j = lane; j < NP; j += 32) {
        const bool in = i < n && j < n;
        const float e = i == j ? 1.f : 0.f;
        X[(size_t)i * NP + j] = in ? e * d_s[j] / cj : 0.f;
        XT[(size_t)i * NP + j] = in ? e * d_s[i] / cj : 0.f;
      }
    __syncthreads();
  };

  int cur = 0;
  float r = 1e5f;
  bool have_r = false;   // R holds I - K X of the current X
  int use_warm = 0;
  const bool try_warm = warm_ok[b];
  if (try_warm) {
    const float* Xw = X0 + (size_t)b * n * n;
    float* X = Xs(0);
    for (int i = warp; i < NP; i += nw)
      for (int j = lane; j < NP; j += 32)
        X[(size_t)i * NP + j] = (i < n && j < n) ? Xw[(size_t)i * n + j] : 0.f;
    __syncthreads();
    float acc[RT][8];
    const float r0 = residual(g, KTs, X, R, stage, red, acc);
    // 12 power-iteration steps w = R0 v from the tile in registers: each
    // thread's partial sums over its 8 columns, then each row's np / 8
    // partials in column-tile order
    float* part_s = stage;   // np / 8 x np partials
    for (int i = tid; i < NP; i += nt) v_s[i] = i < n ? p.v0 : 0.f;
    __syncthreads();
    float nrm = 0.f;
    for (int step = 0; step < 12; ++step) {
      if (g.on) {
        float vc[8];
#pragma unroll
        for (int d = 0; d < 2; ++d)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            vc[4 * d + c] = v_s[g.col0 + d * g.w + c];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) s = fmaf(acc[i][j], vc[j], s);
          part_s[g.tj * NP + g.row0 + (i & 3) + (i >> 2) * g.h] = s;
        }
      }
      __syncthreads();
      float sq = 0.f;
      for (int i = tid; i < NP; i += nt) {
        float s = 0.f;
        for (int t = 0; t < g.tj_n; ++t) s += part_s[t * NP + i];
        w_s[i] = s;
        sq = fmaf(s, s, sq);
      }
      nrm = sqrtf(block_sum(sq, red));
      const float den = clamp_min(nrm, 1e-30f);
      for (int i = tid; i < NP; i += nt) v_s[i] = w_s[i] / den;
      __syncthreads();
    }
    use_warm = isfinite(nrm) && nrm < 0.9f && isfinite(r0);
    if (use_warm) {
      r = r0;
      have_r = true;
      float* XT = XTs(0);
      for (int i = warp; i < NP; i += nw)
        for (int j = lane; j < NP; j += 32)
          XT[(size_t)j * NP + i] = X[(size_t)i * NP + j];
      __syncthreads();
    }
  }
  if (!use_warm) jacobi();

  // one run: its levels in turn, the iteration budget reset at each
  auto run = [&]() {
    int total = 0;
    for (int l = 0; l < p.n_levels; ++l) {
      const float level = p.levels[l];
      int it = 0;
      while (r > level && r < 1e6f && it < p.max_iters) {
        float acc[RT][8];
        const float rn =
            have_r ? r : residual(g, KTs, Xs(cur), R, stage, red, acc);
        have_r = false;
        update(g, Xs(cur), XTs(cur), R, Xs(cur ^ 1), XTs(cur ^ 1), stage);
        cur ^= 1;
        r = rn;
        ++it;
      }
      total += it;
    }
    return total;
  };

  const int it_first = run();
  const bool bad = !isfinite(r) || r > p.bad;
  if (bad) {
    cur = 0;
    jacobi();
    r = 1e5f;
    have_r = false;
  }
  const int it_restart = run();

  // the final squaring in float64: R2 = I - K X2 into the free slot
  double* R64 = reinterpret_cast<double*>(Xs(cur ^ 1));
  const float* X2 = Xs(cur);
  double mx = 0.0;
  gemm64<true, false>(g, KTs, X2, stage, [&](int q0, auto& acc) {
    if (!g.on) return;
#pragma unroll
    for (int i = 0; i < (int)(sizeof(acc) / sizeof(acc[0])); ++i) {
      const int row = g.row0 + (i & 3) + (q0 + (i >> 2)) * g.h;
#pragma unroll
      for (int d = 0; d < 2; ++d)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = g.col0 + d * g.w + c;
          const double e = (row == col) ? 1.0 : 0.0;
          const double v = (row < n && col < n) ? e - acc[i][4 * d + c] : 0.0;
          mx = nanmax64(mx, fabs(v));
          R64[(size_t)row * NP + col] = v;
        }
    }
  });
  const float r2 = __double2float_rn(block_max64(mx, red64));
  const bool ok2 = isfinite(r2) && r2 < 1.f;
  float* Xo = Xout + (size_t)b * n * n;
  if (ok2) {
    gemm64<false, true>(g, XTs(cur), R64, stage, [&](int q0, auto& acc) {
      if (!g.on) return;
#pragma unroll
      for (int i = 0; i < (int)(sizeof(acc) / sizeof(acc[0])); ++i) {
        const int row = g.row0 + (i & 3) + (q0 + (i >> 2)) * g.h;
#pragma unroll
        for (int d = 0; d < 2; ++d)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = g.col0 + d * g.w + c;
            if (row < n && col < n)
              Xo[(size_t)row * n + col] = __double2float_rn(
                  (double)X2[(size_t)row * NP + col] + acc[i][4 * d + c]);
          }
      }
    });
  } else {
    for (int i = warp; i < n; i += nw)
      for (int j = lane; j < n; j += 32)
        Xo[(size_t)i * n + j] = X2[(size_t)i * NP + j];
  }
  if (tid == 0) {
    float out = r;
    if (ok2) out = (r != r) ? r : fminf(r, r2);
    resid[b] = out;
    if (stats) {
      int* s = stats + 4 * b;
      s[0] = use_warm;
      s[1] = it_first;
      s[2] = it_restart;
      s[3] = bad;
    }
    if (count) {   // ops/cuda_ns.py:work's fields
      atomicAdd(count + 0, 1);
      atomicAdd(count + 1, try_warm ? 1 : 0);
      atomicAdd(count + 2, it_first);
      atomicAdd(count + 3, it_restart);
      atomicAdd(count + 4, 1);
      atomicAdd(count + 5, 1);
    }
  }
}

namespace {

// K^T, then the slab buffers: the float32 products' STAGES (A and B), the
// float64 passes' two (A float, B double), the power iteration's partials
// or the transposed row group of X (np x (np / 5 + 1)), whichever is most
size_t smem_bytes(int n) {
  const size_t np = pad(n);
  const size_t sizes[4] = {(size_t)STAGES * 2 * KS * np,
                           2 * 3 * (size_t)KS * np, np / 8 * np,
                           np * (np / 5 + 1)};
  size_t st = 0;
  for (size_t v : sizes) st = v > st ? v : st;
  return (np * np + st) * sizeof(float);
}

template <int NP>
int launch(const NsParams& p, const float* K, const float* X0,
           const bool* warm_ok, float* Xout, float* resid, int* stats,
           float* ws, int* count, int B, cudaStream_t st) {
  const size_t smem = smem_bytes(p.n);
  const cudaError_t e = cudaFuncSetAttribute(
      ns_inverse_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ns_inverse_kernel<NP><<<B, Geo<NP>::threads, smem, st>>>(
      p, K, X0, warm_ok, Xout, resid, stats, ws, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rl_ns_max_n() { return NMAX; }

// floats of one lane's workspace: R, then X and X^T twice, np x np each
extern "C" long long rl_ns_ws_floats(int n) {
  const long long np = pad(n);
  return 5 * np * np;
}

extern "C" int rl_ns_inverse(NsParams p, const float* K, const float* X0,
                             const bool* warm_ok, float* Xout, float* resid,
                             int* stats, float* ws, int* count, int B,
                             void* stream) {
  if (B <= 0) return 0;
  if (p.n < 1 || p.n > NMAX || p.n_levels < 1 || p.n_levels > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pad(p.n)) {
    case 40:
      return launch<40>(p, K, X0, warm_ok, Xout, resid, stats, ws, count, B,
                        st);
    case 80:
      return launch<80>(p, K, X0, warm_ok, Xout, resid, stats, ws, count, B,
                        st);
    case 120:
      return launch<120>(p, K, X0, warm_ok, Xout, resid, stats, ws, count, B,
                         st);
    case 160:
      return launch<160>(p, K, X0, warm_ok, Xout, resid, stats, ws, count, B,
                         st);
    default:
      return launch<200>(p, K, X0, warm_ok, Xout, resid, stats, ws, count, B,
                         st);
  }
}
