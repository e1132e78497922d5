"""Vendored float64 dense convex-QP oracle (Mehrotra predictor-corrector).

This environment has neither OSQP nor CVXOPT (the reference's native solvers,
`PredictiveControllers.py:11` / `PredictiveModel.py:1-3`), so parity tests
validate the batched TPU ADMM solver against this small, trusted primal-dual
interior-point method, itself sanity-checked on problems with closed-form
KKT solutions.

Problem form:  min 1/2 z'Hz + q'z   s.t.  G z = g,  F z <= b.
"""
import numpy as np


def solve_qp(H, q, G=None, g=None, F=None, b=None, tol=1e-10, max_iter=100):
    """Returns (z, y_eq, lam_ineq, converged)."""
    H = np.asarray(H, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n = H.shape[0]
    me = 0 if G is None else G.shape[0]
    mi = 0 if F is None else F.shape[0]
    G = np.zeros((0, n)) if G is None else np.asarray(G, dtype=np.float64)
    g = np.zeros(0) if g is None else np.asarray(g, dtype=np.float64)
    F = np.zeros((0, n)) if F is None else np.asarray(F, dtype=np.float64)
    b = np.zeros(0) if b is None else np.asarray(b, dtype=np.float64)

    z = np.zeros(n)
    y = np.zeros(me)
    lam = np.ones(mi)
    s = np.ones(mi)

    def kkt_solve(lam, s, r_d, r_p, r_i, r_c):
        # eliminate (dlam, ds):   dlam = (lam*(r_i + F dz) - r_c)/s  ... derived:
        #   S dlam + LAM ds = -r_c ;  F dz + ds = -r_i
        # => dlam = S^{-1}(-r_c + lam*(r_i + F dz))
        w = lam / s
        M = np.zeros((n + me, n + me))
        M[:n, :n] = H + F.T @ (w[:, None] * F)
        M[:n, n:] = G.T
        M[n:, :n] = G
        M[n:, n:] = -1e-14 * np.eye(me)
        rhs = np.concatenate([
            -r_d + F.T @ ((r_c - lam * r_i) / s) if mi else -r_d,
            -r_p,
        ])
        sol = np.linalg.solve(M, rhs)
        dz, dy = sol[:n], sol[n:]
        if mi:
            ds = -r_i - F @ dz
            dlam = -(r_c + lam * ds) / s
        else:
            ds = np.zeros(0)
            dlam = np.zeros(0)
        return dz, dy, dlam, ds

    converged = False
    for _ in range(max_iter):
        r_d = H @ z + q + G.T @ y + F.T @ lam
        r_p = G @ z - g
        r_i = F @ z + s - b
        mu = (lam @ s / mi) if mi else 0.0
        if (
            np.linalg.norm(r_d, np.inf) < tol
            and (me == 0 or np.linalg.norm(r_p, np.inf) < tol)
            and (mi == 0 or np.linalg.norm(r_i, np.inf) < tol)
            and mu < tol
        ):
            converged = True
            break

        # affine (predictor) step
        r_c = lam * s
        dz_a, dy_a, dlam_a, ds_a = kkt_solve(lam, s, r_d, r_p, r_i, r_c)

        def max_step(v, dv):
            neg = dv < 0
            return min(1.0, (-v[neg] / dv[neg]).min()) if neg.any() else 1.0

        if mi:
            a_aff = min(max_step(s, ds_a), max_step(lam, dlam_a))
            mu_aff = (lam + a_aff * dlam_a) @ (s + a_aff * ds_a) / mi
            sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0
            # corrector
            r_c = lam * s + dlam_a * ds_a - sigma * mu
        dz, dy, dlam, ds = kkt_solve(lam, s, r_d, r_p, r_i, r_c)
        alpha = 1.0
        if mi:
            alpha = 0.99 * min(max_step(s, ds), max_step(lam, dlam))
        z += alpha * dz
        y += alpha * dy
        lam += alpha * dlam
        s += alpha * ds

    return z, y, lam, converged
