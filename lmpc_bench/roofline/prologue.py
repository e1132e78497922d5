"""The QP prologue of the port's kernel path (``ops/qp.py:admm_inputs``):
warm Ruiz scaling, the K build and the Newton-Schulz inverse, PyTorch ops
and cuBLAS GEMMs on the device.

Operations per lane, from the tracer's counters of the profiled solves
(``runtime/tracing.py``; n variables, m constraints):

- each Ruiz sweep (``ruiz.lane_sweeps``, frozen lanes included, as the
  sweep runs on them): the column and row maxima of |P| and |A|, the
  scalings d P d, e A d, the cost maximum and its scaling:
  5 n^2 + 5 m n + 8 (n + m);
- the K build, P + sigma I + A' diag(rho) A: what the FTOCP's structural
  pattern needs (:func:`k_build_ops`: 2 nnz(row)^2 over A's rows, and n^2
  for the sum), once a solve;
- the warm gate (``ns.warm_gate_lanes``): I - K X0 (2 n^3 + n^2), its
  maximum (n^2) and 12 power-iteration products (12 (2 n^2 + 3 n));
- each Newton-Schulz lane-iteration (``ns.first.lane_iters``,
  ``ns.restart.lane_iters``): R = I - K X and X + X R (4 n^3 + 2 n^2) and
  max|R| (n^2), float32;
- the final squaring (``ns.final.lane_iters``): the same two products in
  float64 (4 n^3 + 2 n^2) and max|R| (n^2).

Bytes per solve-lane: the inputs read once (P, A, the carried inverse,
q, l, u, the carried D, E, c and the warm start) and the outputs written
once (the scaled P, A, q, l, u, D, E, c, rho, x, z, y and the inverse),
float32.

The float64 peak is NVIDIA's H100 SXM data sheet's FP64 Tensor Core rate
(67 TFLOP/s, dense, 700 W), which cuBLAS's float64 GEMM runs on.
"""
from __future__ import annotations

import functools

import numpy as np

from lmpc_bench.reference import ref_ftocp
from lmpc_bench.roofline.peaks import PEAKS

FLOAT64_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}


@functools.lru_cache(maxsize=None)
def k_build_ops(N: int, K: int) -> int:
    """Operations of A' diag(rho) A + P + sigma I on the LMPC FTOCP's
    structural pattern (the one ``roofline/admm.py`` counts nonzeros of):
    each row of A with k nonzeros adds k^2 products, each a multiply and
    an add, then the two n x n sums (with P and with sigma I)."""
    A = np.zeros((6, 6))
    A[:3, :3] = 1.0
    A[3] = [1, 1, 1, 1, 0, 1]
    A[4] = [1, 1, 0, 1, 1, 1]
    A[5] = [1, 1, 0, 1, 0, 1]
    B = np.zeros((6, 2))
    B[0, 1] = B[1, 0] = B[2, 0] = 1.0
    p = ref_ftocp.build_ftocp(
        N, np.zeros(6), np.zeros(2), np.ones(2), np.zeros(6), (1.0, 1.0),
        np.zeros(6), 1.0, 1.0, 1.0, [A] * N, [B] * N, [np.ones(6)] * N,
        np.ones(6), np.ones(2), K=K, q_terminal_slack=1.0,
        ss_points=np.ones((6, K)), qfun_sel=np.ones(K))
    rows = np.concatenate([(p["G"] != 0).sum(1), (p["F"] != 0).sum(1)])
    n = p["H"].shape[0]
    return int(2 * (rows.astype(np.int64) ** 2).sum() + 2 * n * n)


def work(c: dict, n: int, m: int, N: int, K: int):
    """(float32 operations, float64 operations, bytes) of the profiled
    solves' prologues; ``c``: the tracer's counters."""
    lanes = c.get("ns.lanes", 0)
    ns_iters = c.get("ns.first.lane_iters", 0) + c.get(
        "ns.restart.lane_iters", 0)
    f32 = (c.get("ruiz.lane_sweeps", 0) * (5 * n * n + 5 * m * n
                                           + 8 * (n + m))
           + lanes * k_build_ops(N, K)
           + c.get("ns.warm_gate_lanes", 0) * (2 * n ** 3 + 2 * n * n
                                               + 12 * (2 * n * n + 3 * n))
           + ns_iters * (4 * n ** 3 + 3 * n * n))
    f64 = c.get("ns.final.lane_iters", 0) * (4 * n ** 3 + 3 * n * n)
    words = (2 * n * n + m * n + 2 * n + 3 * m + 1 + n + m
             + 2 * n * n + m * n + 3 * n + 6 * m + 1)
    return float(f32), float(f64), 4.0 * words * lanes


def least_seconds(f32: float, f64: float, nbytes: float, card: str):
    """The least time of mixed-precision work, and which bound sets it."""
    t_ops = f32 / PEAKS[card]["float32_flops"] + f64 / FLOAT64_FLOPS[card]
    t_bytes = nbytes / PEAKS[card]["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
