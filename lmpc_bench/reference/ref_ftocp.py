"""Float64 NumPy oracle for the FTOCP matrices.

Independent re-implementation of the QP the reference assembles per control
step (`RacingLMPC src/fnc/controller/PredictiveControllers.py:166-257`
+ LMPC terminal blocks `:340-362`), written stage-by-stage with explicit
loops (deliberately different structure from the vectorized JAX assembly in
``racinglmpc_tpu.controllers.ocp``, which it cross-checks).

Problem form returned:  min ½ zᵀHz + qᵀz  s.t.  G z = E x0 + L,  F z ≤ b
with z = [x_0..x_N | u_0..u_{N-1} | slack (2N) | (λ | termSlack)].
"""
import numpy as np


def build_ftocp(
    N, Q, R, dR, Qf, q_slack, x_ref, ey_max, delta_max, a_max,
    A_seq, B_seq, C_seq, x0, u_old,
    K=0, q_terminal_slack=0.0, ss_points=None, qfun_sel=None,
):
    n, d, nc = 6, 2, 2
    Q, R, dR, Qf = (np.asarray(v, float) for v in (Q, R, dR, Qf))
    x_ref = np.asarray(x_ref, float)
    nz = (N + 1) * n + N * d + nc * N + (K + n if K else 0)
    ou = (N + 1) * n
    osl = ou + N * d
    ola = osl + nc * N
    ots = ola + K

    # cost
    H = np.zeros((nz, nz))
    q = np.zeros(nz)
    for k in range(N + 1):
        W = Qf if k == N else Q
        H[k * n:(k + 1) * n, k * n:(k + 1) * n] = np.diag(W)
        q[k * n:(k + 1) * n] = -2.0 * W * x_ref
    for k in range(N):
        i0 = ou + k * d
        H[i0:i0 + d, i0:i0 + d] += np.diag(R)
        # rate cost ||u_k - u_{k-1}||_dR for k = 1..N-1 plus ||u_0 - u_old||_dR
        H[i0:i0 + d, i0:i0 + d] += np.diag(dR)
        if k + 1 < N:
            j0 = ou + (k + 1) * d
            H[i0:i0 + d, i0:i0 + d] += np.diag(dR)
            H[i0:i0 + d, j0:j0 + d] -= np.diag(dR)
            H[j0:j0 + d, i0:i0 + d] -= np.diag(dR)
    q[ou:ou + d] = -2.0 * dR * np.asarray(u_old, float)
    H[osl:osl + nc * N, osl:osl + nc * N] = q_slack[0] * np.eye(nc * N)
    q[osl:osl + nc * N] = q_slack[1]
    if K:
        H[ots:ots + n, ots:ots + n] = q_terminal_slack * np.eye(n)
        q[ola:ola + K] = np.asarray(qfun_sel, float)
    H = 2.0 * H

    # equalities
    me = (N + 1) * n + (n + 1 if K else 0)
    G = np.zeros((me, nz))
    E = np.zeros((me, n))
    L = np.zeros(me)
    G[:n, :n] = np.eye(n)
    E[:n, :n] = np.eye(n)
    for k in range(N):
        r0 = (k + 1) * n
        G[r0:r0 + n, r0:r0 + n] = np.eye(n)
        G[r0:r0 + n, k * n:k * n + n] = -np.asarray(A_seq[k], float)
        G[r0:r0 + n, ou + k * d:ou + (k + 1) * d] = -np.asarray(B_seq[k], float)
        L[r0:r0 + n] = np.asarray(C_seq[k], float)
    if K:
        tr = (N + 1) * n
        G[tr:tr + n, N * n:(N + 1) * n] = np.eye(n)
        G[tr:tr + n, ola:ola + K] = -np.asarray(ss_points, float)
        G[tr:tr + n, ots:ots + n] = np.eye(n)
        G[tr + n, ola:ola + K] = 1.0
        L[tr + n] = 1.0

    # inequalities
    mi = nc * N + 4 * N + nc * N + K
    F = np.zeros((mi, nz))
    b = np.zeros(mi)
    r = 0
    for k in range(N):
        for sgn, sl in ((1.0, 0), (-1.0, 1)):
            F[r, k * n + 5] = sgn
            F[r, osl + k * nc + sl] = -1.0
            b[r] = ey_max
            r += 1
    for k in range(N):
        for col, bound in ((0, delta_max), (1, a_max)):
            F[r, ou + k * d + col] = 1.0
            b[r] = bound
            r += 1
            F[r, ou + k * d + col] = -1.0
            b[r] = bound
            r += 1
    F[r:r + nc * N, osl:osl + nc * N] = -np.eye(nc * N)
    r += nc * N
    if K:
        F[r:r + K, ola:ola + K] = -np.eye(K)
        r += K

    g_eq = E @ np.asarray(x0, float) + L
    return dict(H=H, q=q, G=G, E=E, L=L, F=F, b=b, g_eq=g_eq)
