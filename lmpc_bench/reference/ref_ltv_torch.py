"""One step of the upstream LTV-MPC controller, plain PyTorch, float64, CPU.

RacingLMPC (Rosolia & Borrelli), lap 3 of ``src/main.py:86-95``: an MPC
whose model is identified anew at every step by local regression over a
stored lap (``src/fnc/controller/PredictiveModel.py:48-197``) at the N
points of its linearization trajectory, the FTOCP of
``PredictiveControllers.py:166-257`` with the MPC weights of
``src/initControllerParameters.py``, and after the solve the trajectory
rolled forward (``PredictiveControllers.py:56-164``). Given the carried
state (the plant state x0, the linearization trajectory x_lin, u_lin and
the last input u_old) and the sys-ID store, :func:`step` returns the
applied input, the prediction and the state carried to the next step.

This file is the benchmark's reference for the ``ltv`` stage: it imports
torch and numpy only, no code of the program and none of the NumPy
oracles beside it, and it reads the settings by the upstream's names.
Every tensor is float64 on the CPU, TF32 off.

- **kNN** (``computeIndices``, :180-197): per stored lap the candidate
  rows 0..T-2, the L1 distance of [vx, vy, wz, delta, a] scaled by
  [0.1, 1, 1, 1, 1]; the rows under ``h``, or the ``MaxNumPoint``
  nearest where that many lie under it; Epanechnikov weights
  0.75 (1 - (d/h)^2), not clamped (every row kept lies under h).
- **Regression** (``RegressionAndLinearization``, :141-178): weighted
  least squares with lambda 0 for row 0 (vx) on [vx, vy, wz, a, 1] and
  rows 1-2 (vy, wz) on [vx, vy, wz, delta, 1], the successors of the kept
  rows as targets; the constant-curvature rows 3-5 (epsi, s, ey)
  analytic (:99-135).
- **FTOCP** (``buildIneqConstr``, ``buildCost``, ``buildEqConstr``,
  :166-257): z = [x_0..x_N | u_0..u_{N-1} | slack (2N)]; cost
  (x - x_ref)'Q(x - x_ref) stage by stage, Qf on x_N, R and the rate cost
  dR (with u_old before u_0), slack Qslack[0] s^2 + Qslack[1] s; the
  dynamics x_{k+1} = A_k x_k + B_k u_k + C_k from x_0 = x0; |ey_k| <= bx
  softened by the slacks for k < N, the input box bu, slacks >= 0.
- **QP**: a primal-dual interior-point method (Mehrotra's predictor and
  corrector) to residuals and complementarity below 1e-10, then the
  equality-constrained KKT system of the constraints it found active,
  solved exactly and kept where its answer is feasible and its
  multipliers are of the right sign.
- **Step**: the input u_0 clipped to the input box, then the roll
  x_lin <- [x_pred[1:], x_pred[N]], u_lin <- [u_pred[1:], u_pred[N-1]],
  u_old <- the applied input.

Departures from the upstream, each with its reason:

- the QP is solved by the method above, not by OSQP or CVXOPT (neither
  is available); both find the same optimum of a convex QP, to their
  tolerances;
- the curvature lookup takes the segment whose start is the last one at
  or below s (s wrapped into [0, L) when s >= L, left at the first
  segment when s < 0), where the upstream subtracts L while s > L and
  raises for s < 0 or at s = L exactly;
- kNN ties are broken by the lower row (a stable sort; the upstream
  leaves them to numpy's ``argsort``);
- the applied input is clipped to the input box, and u_old is that
  input, as the program does; the upstream's OldInput is the unclipped
  u_pred[0], which lies within the box up to the solver's tolerance;
- the regression is solved by ``torch.linalg.solve``, where the upstream
  calls CVXOPT's unconstrained ``qp(Q, b)``, which solves the same
  normal equations.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
NX, NU = 6, 2
SCALING = (0.1, 1.0, 1.0, 1.0, 1.0)   # PredictiveModel.py:22-26
TOL = 1e-10


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64)


class Settings(NamedTuple):
    """The controller's settings, from the configuration's ``upstream``."""
    N: int
    dt: float
    Q: torch.Tensor        # (6,) diagonal of the state weight
    R: torch.Tensor        # (2,)
    dR: torch.Tensor       # (2,) input-rate weight
    Qf: torch.Tensor       # (6,)
    q_slack: Tuple[float, float]   # Qslack: quadratic, linear
    x_ref: torch.Tensor    # (6,) [vt, 0, 0, 0, 0, 0]
    bx: Tuple[float, float]        # ey <= bx[0], -ey <= bx[1]
    bu: Tuple[float, float, float, float]  # delta <=, -delta <=, a <=, -a <=
    h: float
    max_pts: int
    used_it: int


def settings(upstream: dict) -> Settings:
    sid = upstream["sysid"]
    return Settings(
        N=int(upstream["N"]), dt=float(upstream["dt"]), Q=_t(upstream["Q"]),
        R=_t(upstream["R"]), dR=_t(upstream["dR"]), Qf=_t(upstream["Qf"]),
        q_slack=tuple(float(v) for v in upstream["Qslack"]),
        x_ref=_t([upstream["vt"], 0, 0, 0, 0, 0]),
        bx=tuple(float(v) for v in upstream["bx"]),
        bu=tuple(float(v) for v in upstream["bu"]), h=float(sid["h"]),
        max_pts=int(sid["MaxNumPoint"]), used_it=int(sid["usedIt"]))


class Track(NamedTuple):
    s0: torch.Tensor    # (S,) arc length at each segment's start
    curv: torch.Tensor  # (S,) signed curvature
    L: float


def track(s0, curv, L) -> Track:
    return Track(_t(s0), _t(curv), float(L))


def curvature(trk: Track, s: float) -> float:
    s = float(s)
    if s >= trk.L:
        s -= trk.L * np.floor(s / trk.L)
    i = int(torch.searchsorted(trk.s0, torch.tensor([s], dtype=F64),
                               right=True)[0]) - 1
    return float(trk.curv[min(max(i, 0), len(trk.curv) - 1)])


# ---- local regression (PredictiveModel.py) ---------------------------------

def neighbors(lap_x: torch.Tensor, lap_u: torch.Tensor, z: torch.Tensor,
              st: Settings):
    """computeIndices on one stored lap: the kept rows and their weights."""
    feats = torch.cat([lap_x[:-1, :3], lap_u[:-1]], 1)
    d = ((feats - z) * _t(SCALING)).abs().sum(1)
    under = torch.nonzero(d < st.h)[:, 0]
    if under.numel() >= st.max_pts:
        idx = torch.sort(d, stable=True).indices[:st.max_pts]
    else:
        idx = under
    return idx, 0.75 * (1.0 - (d[idx] / st.h) ** 2)


def regression(laps, x: torch.Tensor, u: torch.Tensor, trk: Track,
               st: Settings):
    """(A, B, C) with x_{k+1} ~ A x + B u + C at (x, u)."""
    z = torch.cat([x[:3], u])
    sel = [neighbors(lx, lu, z, st) for lx, lu in laps[:st.used_it]]

    def fit(col: int, ys: List[int]) -> torch.Tensor:
        M = torch.cat([torch.cat([lx[idx, :3], lu[idx, col:col + 1],
                                  torch.ones((len(idx), 1), dtype=F64)], 1)
                       for (lx, lu), (idx, _) in zip(laps, sel)])
        Y = torch.cat([lx[idx + 1][:, ys] for (lx, _), (idx, _) in
                       zip(laps, sel)])
        w = torch.cat([wt for _, wt in sel])
        Mw = M.T * w
        return torch.linalg.solve(Mw @ M, Mw @ Y)

    A = torch.zeros((NX, NX), dtype=F64)
    B = torch.zeros((NX, NU), dtype=F64)
    C = torch.zeros(NX, dtype=F64)
    th = fit(1, [0])
    A[0, :3], B[0, 1], C[0] = th[:3, 0], th[3, 0], th[4, 0]
    th = fit(0, [1, 2])
    A[1, :3], B[1, 0], C[1] = th[:3, 0], th[3, 0], th[4, 0]
    A[2, :3], B[2, 0], C[2] = th[:3, 1], th[3, 1], th[4, 1]

    vx, vy, wz, epsi, s, ey = (float(v) for v in x)
    h = st.dt
    cur = curvature(trk, s)
    den = 1.0 - cur * ey
    ce, se = np.cos(epsi), np.sin(epsi)
    v_s = vx * ce - vy * se
    A[3] = _t([-h * ce / den * cur, h * se / den * cur, h,
               1 - h * (-vx * se - vy * ce) / den * cur, 0.0,
               h * v_s / den ** 2 * cur * (-cur)])
    A[4] = _t([h * ce / den, -h * se / den, 0.0,
               h * (-vx * se - vy * ce) / den, 1.0,
               -h * v_s / den ** 2 * (-cur)])
    A[5] = _t([h * se, h * ce, 0.0, h * v_s, 0.0, 1.0])
    f = _t([epsi + h * (wz - v_s / den * cur), s + h * v_s / den,
            ey + h * (vx * se + vy * ce)])
    C[3:] = f - A[3:] @ x
    return A, B, C


# ---- the FTOCP (PredictiveControllers.py:166-257) --------------------------

class QP(NamedTuple):
    H: torch.Tensor   # min 1/2 z'Hz + q'z
    q: torch.Tensor
    G: torch.Tensor   # G z = g
    g: torch.Tensor
    F: torch.Tensor   # F z <= b
    b: torch.Tensor


def ftocp(st: Settings, dyn, x0: torch.Tensor, u_old: torch.Tensor) -> QP:
    N = st.N
    ou = (N + 1) * NX                 # first input
    osl = ou + N * NU                 # first slack
    nz = osl + 2 * N
    H = torch.zeros((nz, nz), dtype=F64)
    q = torch.zeros(nz, dtype=F64)
    for k in range(N + 1):
        W = st.Qf if k == N else st.Q
        H[k * NX:(k + 1) * NX, k * NX:(k + 1) * NX] = torch.diag(W)
        q[k * NX:(k + 1) * NX] = -2.0 * W * st.x_ref
    for k in range(N):
        # R, and the rate cost sum_k |u_k - u_{k-1}|_dR with u_{-1} = u_old
        a = ou + k * NU
        last = k == N - 1
        H[a:a + NU, a:a + NU] = torch.diag(st.R + (1 if last else 2) * st.dR)
        if not last:
            H[a:a + NU, a + NU:a + 2 * NU] = -torch.diag(st.dR)
            H[a + NU:a + 2 * NU, a:a + NU] = -torch.diag(st.dR)
    q[ou:ou + NU] = -2.0 * st.dR * u_old
    H[osl:, osl:] = st.q_slack[0] * torch.eye(2 * N, dtype=F64)
    q[osl:] = st.q_slack[1]
    H = 2.0 * H

    G = torch.zeros(((N + 1) * NX, nz), dtype=F64)
    g = torch.zeros((N + 1) * NX, dtype=F64)
    G[:NX, :NX] = torch.eye(NX, dtype=F64)
    g[:NX] = x0
    for k, (A, B, C) in enumerate(dyn):
        r = (k + 1) * NX
        G[r:r + NX, r:r + NX] = torch.eye(NX, dtype=F64)
        G[r:r + NX, k * NX:(k + 1) * NX] = -A
        G[r:r + NX, ou + k * NU:ou + (k + 1) * NU] = -B
        g[r:r + NX] = C

    F = torch.zeros((8 * N, nz), dtype=F64)
    b = torch.zeros(8 * N, dtype=F64)
    r = 0
    for k in range(N):                # |ey_k| <= bx, softened
        for j, sgn in enumerate((1.0, -1.0)):
            F[r, k * NX + 5] = sgn
            F[r, osl + 2 * k + j] = -1.0
            b[r] = st.bx[j]
            r += 1
    for k in range(N):                # the input box
        for j, (col, sgn) in enumerate(((0, 1.0), (0, -1.0), (1, 1.0),
                                        (1, -1.0))):
            F[r, ou + k * NU + col] = sgn
            b[r] = st.bu[j]
            r += 1
    F[r:, osl:] = -torch.eye(2 * N, dtype=F64)   # slacks >= 0
    return QP(H, q, G, g, F, b)


# ---- the QP ----------------------------------------------------------------

def _step_to_boundary(v: torch.Tensor, dv: torch.Tensor) -> float:
    neg = dv < 0
    return min(1.0, float((-v[neg] / dv[neg]).min())) if bool(neg.any()) \
        else 1.0


def interior_point(p: QP, tol: float = TOL, max_iter: int = 200):
    """Mehrotra's predictor-corrector; returns (z, y, lam, converged)."""
    n, me, mi = p.H.shape[0], p.G.shape[0], p.F.shape[0]
    z = torch.zeros(n, dtype=F64)
    y = torch.zeros(me, dtype=F64)
    lam = torch.ones(mi, dtype=F64)
    s = torch.ones(mi, dtype=F64)
    Ft = p.F.T

    def newton(r_d, r_p, r_i, r_c):
        # S dlam + Lam ds = -r_c and F dz + ds = -r_i eliminated
        K = torch.zeros((n + me, n + me), dtype=F64)
        K[:n, :n] = p.H + Ft @ ((lam / s)[:, None] * p.F)
        K[:n, n:] = p.G.T
        K[n:, :n] = p.G
        rhs = torch.cat([-r_d + Ft @ ((r_c - lam * r_i) / s), -r_p])
        sol = torch.linalg.solve(K, rhs)
        dz, dy = sol[:n], sol[n:]
        ds = -r_i - p.F @ dz
        return dz, dy, -(r_c + lam * ds) / s, ds

    for _ in range(max_iter):
        r_d = p.H @ z + p.q + p.G.T @ y + Ft @ lam
        r_p = p.G @ z - p.g
        r_i = p.F @ z + s - p.b
        mu = float(lam @ s) / mi
        if max(float(r_d.abs().max()), float(r_p.abs().max()),
               float(r_i.abs().max()), mu) < tol:
            return z, y, lam, True
        dz, dy, dlam, ds = newton(r_d, r_p, r_i, lam * s)
        a = min(_step_to_boundary(s, ds), _step_to_boundary(lam, dlam))
        mu_aff = float((lam + a * dlam) @ (s + a * ds)) / mi
        sigma = (mu_aff / mu) ** 3
        dz, dy, dlam, ds = newton(r_d, r_p, r_i,
                                  lam * s + dlam * ds - sigma * mu)
        a = 0.99 * min(_step_to_boundary(s, ds), _step_to_boundary(lam, dlam))
        z, y, lam, s = z + a * dz, y + a * dy, lam + a * dlam, s + a * ds
    return z, y, lam, False


def active_set_solve(p: QP, z_ip: torch.Tensor, lam_ip: torch.Tensor,
                     tol: float = 1e-9):
    """The KKT system of the equalities and the inequalities the
    interior point left active, solved exactly; None where its answer is
    infeasible or a multiplier has the wrong sign."""
    act = lam_ip > (p.b - p.F @ z_ip)
    Fa = p.F[act]
    n, me, ma = p.H.shape[0], p.G.shape[0], Fa.shape[0]
    K = torch.zeros((n + me + ma, n + me + ma), dtype=F64)
    K[:n, :n] = p.H
    K[:n, n:n + me] = p.G.T
    K[:n, n + me:] = Fa.T
    K[n:n + me, :n] = p.G
    K[n + me:, :n] = Fa
    rhs = torch.cat([-p.q, p.g, p.b[act]])
    try:
        sol = torch.linalg.solve(K, rhs)
    except RuntimeError:        # singular: the active set is degenerate
        return None
    z, lam_a = sol[:n], sol[n + me:]
    if not bool(torch.isfinite(sol).all()):
        return None
    if float((p.F @ z - p.b).max()) > tol:
        return None
    if ma and float(lam_a.min()) < -tol:
        return None
    return z


def solve_qp(p: QP):
    """(z, converged): the interior point's answer, made exact on its
    active set where that is consistent."""
    z, _, lam, conv = interior_point(p)
    exact = active_set_solve(p, z, lam) if conv else None
    return (z if exact is None else exact), conv


# ---- one step --------------------------------------------------------------

class Step(NamedTuple):
    u: torch.Tensor       # (2,) the applied input
    x_pred: torch.Tensor  # (N+1, 6)
    u_pred: torch.Tensor  # (N, 2)
    x_lin: torch.Tensor   # (N+1, 6) carried to the next step
    u_lin: torch.Tensor   # (N, 2)
    u_old: torch.Tensor   # (2,)
    converged: bool


def step(st: Settings, laps: Sequence[Tuple[torch.Tensor, torch.Tensor]],
         trk: Track, x0, x_lin, u_lin, u_old) -> Step:
    """One LTV-MPC step. ``laps``: the stored laps (x (T, 6), u (T, 2)),
    fastest first (the upstream's store keeps them sorted by length);
    x0 (6,), x_lin (N+1, 6), u_lin (N, 2), u_old (2,)."""
    N = st.N
    laps = [(_t(x), _t(u)) for x, u in laps]
    x0, x_lin, u_lin, u_old = (_t(a) for a in (x0, x_lin, u_lin, u_old))
    dyn = [regression(laps, x_lin[k], u_lin[k], trk, st) for k in range(N)]
    z, conv = solve_qp(ftocp(st, dyn, x0, u_old))
    x_pred = z[:(N + 1) * NX].reshape(N + 1, NX)
    u_pred = z[(N + 1) * NX:(N + 1) * NX + N * NU].reshape(N, NU)
    lo = _t([-st.bu[1], -st.bu[3]])   # the box's rows: +delta, -delta,
    hi = _t([st.bu[0], st.bu[2]])     # +a, -a

    u = torch.minimum(torch.maximum(u_pred[0], lo), hi)
    return Step(u=u, x_pred=x_pred, u_pred=u_pred,
                x_lin=torch.cat([x_pred[1:], x_pred[-1:]]),
                u_lin=torch.cat([u_pred[1:], u_pred[-1:]]), u_old=u.clone(),
                converged=conv)
