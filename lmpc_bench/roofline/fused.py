"""B4 (``ops/cuda_qp_fused.py``), its prologue launch
``admm_fused_prologue``: per scenario the K build, the Jacobi start, the
warm test and the two Newton-Schulz passes, one CTA a scenario.

The least work of the prologue, counted at the QP's own n and m (the
LTV-MPC FTOCP: n = 146, m = 202 at N = 14), not at the kernel's padded
size, so that any implementation is read against the same work. Float32
operations of one lane:

- the K build, P + sigma I + A' diag(rho) A, on the FTOCP's structural
  pattern (:func:`k_build_ops`): each row of A with k nonzeros adds k^2
  products, each a multiply and an add; then P's nonzeros and sigma on
  the diagonal;
- the Jacobi start: d = 1 / diag K (n), I - K diag(d) and its Frobenius
  norm (3 n^2), X = diag(d) / c (n);
- the warm test where it runs (the lanes handed a valid inverse): I - K X0
  (2 n^3 + n) and its Frobenius norm (2 n^2);
- each Newton-Schulz lane-iteration, both passes: R = I - K X and X + X R,
  two dense n x n products (4 n^3 + n^2 + n), and max|R| (n^2).

Bytes of one lane: P, A and the carried inverse read once, the refreshed
inverse written once, float32. The ADMM loop and the rescue that follow in
B4 are B1's launches, not read here.
"""
from __future__ import annotations

import functools

import numpy as np

from lmpc_bench.reference import ref_ftocp


@functools.lru_cache(maxsize=None)
def _k_build(N: int, Q: tuple, R: tuple, dR: tuple, Qf: tuple,
             q_slack: tuple) -> int:
    # the local models' structural pattern: regressed rows 0-2 on
    # (vx, vy, wz) and one input each, the kinematic rows 3-5
    A = np.zeros((6, 6))
    A[:3, :3] = 1.0
    A[3] = [1, 1, 1, 1, 0, 1]
    A[4] = [1, 1, 0, 1, 1, 1]
    A[5] = [1, 1, 0, 1, 0, 1]
    B = np.zeros((6, 2))
    B[0, 1] = B[1, 0] = B[2, 0] = 1.0
    p = ref_ftocp.build_ftocp(
        N, np.asarray(Q), np.asarray(R), np.asarray(dR), np.asarray(Qf),
        q_slack, np.zeros(6), 1.0, 1.0, 1.0, [A] * N, [B] * N,
        [np.ones(6)] * N, np.ones(6), np.ones(2))
    rows = np.concatenate([(p["G"] != 0).sum(1), (p["F"] != 0).sum(1)])
    n = p["H"].shape[0]
    return int(2 * (rows.astype(np.int64) ** 2).sum()
               + int((p["H"] != 0).sum()) + n)


def k_build_ops(w: dict) -> int:
    """Operations of one lane's K build at the configuration's weights."""
    return _k_build(int(w["N"]), *(tuple(float(v) for v in w[k]) for k in
                                   ("Q", "R", "dR", "Qf", "Qslack")))


def work(w: dict):
    """(operations, bytes) of the profiled launches; ``w``: n, m, N, the
    weights, and the counts ``lanes``, ``warm_tests``,
    ``ns_lane_iters``."""
    n, m = int(w["n"]), int(w["m"])
    lanes = float(w["lanes"])
    ops = (lanes * (k_build_ops(w) + 3 * n * n + 2 * n)
           + float(w["warm_tests"]) * (2 * n ** 3 + 2 * n * n + n)
           + float(w["ns_lane_iters"]) * (4 * n ** 3 + 2 * n * n + n))
    return ops, 4.0 * lanes * (3 * n * n + m * n)
