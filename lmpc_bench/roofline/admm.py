"""B1 (``ops/cuda_qp.py``): the ADMM loop and its rescue, one CTA a
scenario.

Operations, float32, of one iteration on a QP of n variables and m
constraints (``refine_steps`` = r): the right-hand side's v.A (2 nnz(A)),
the solve rhs.Kinv (2 n^2), each refinement round's xt.P, A xt and (.).A
and r.Kinv (2 nnz(P) + 4 nnz(A) + 2 n^2), z's A xt (2 nnz(A)), and the
vector updates (9 (n + m)); each residual check (one on entry, one after
every ``check_every`` iterations): A x, x.P, y.A and its maxima
(4 nnz(A) + 2 nnz(P) + 10 (n + m)). The products count the nonzeros the
kernel keeps, the FTOCP's structural pattern (:func:`nonzeros`). Iterations
are the solver's own count for every scenario of every launch, the
rescue's included; the rescue's K build and Newton-Schulz inverse are not
counted, so where scenarios take the rescue the share is a lower bound.

Bytes: each input read once (P, Kinv, A dense; q, D, x0; l, u, rho, E, z0,
y0; c) and each output written once (x, z, y, the residuals and flags),
float32, for every scenario of every launch.
"""
from __future__ import annotations

import functools

import numpy as np

from lmpc_bench.reference import ref_ftocp


@functools.lru_cache(maxsize=None)
def nonzeros(N: int, K: int):
    """(n, m, nnz(A), nnz(P)) of the LMPC FTOCP with N steps and K
    safe-set points: the sys-ID's rows fill the velocity block and the
    kinematic rows' Jacobian pattern, every terminal point is nonzero."""
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
    n = p["H"].shape[0]
    m = p["G"].shape[0] + p["F"].shape[0]
    nnz_a = int((p["G"] != 0).sum() + (p["F"] != 0).sum())
    return n, m, nnz_a, int((p["H"] != 0).sum())


def work(w: dict):
    """(operations, bytes) of the profiled launches; ``w``: N, K,
    refine_steps, check_every, lanes (scenario-launches), iters, checks."""
    n, m, nnz_a, nnz_p = nonzeros(int(w["N"]), int(w["K"]))
    r = int(w["refine_steps"])
    per_iter = (2 * n * n * (1 + r) + 2 * nnz_a * (2 + 2 * r)
                + 2 * nnz_p * r + 9 * (n + m))
    per_check = 4 * nnz_a + 2 * nnz_p + 10 * (n + m)
    ops = float(w["iters"]) * per_iter + float(w["checks"]) * per_check
    words = 2 * n * n + m * n + 3 * n + 6 * m + 1 + n + 2 * m + 6
    return ops, 4.0 * words * float(w["lanes"])
