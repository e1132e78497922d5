"""Float64 NumPy closed-loop oracle with the reference's *controller* semantics.

Chains the existing oracles (``ref_plant`` plant, ``ref_ftocp`` FTOCP
matrices, ``qp_ip`` interior-point QP) with loop-style re-implementations of
the reference's control path, so the BASELINE acceptance criteria —
"control sequences match the reference solution within tolerance" and
"lap times within 1%" — can be demonstrated end-to-end without OSQP/CVXOPT:

- :class:`RefPredictiveModel` — local system-ID
  (`RacingLMPC src/fnc/controller/PredictiveModel.py:11-197`): sorted
  lap store, per-lap scaled-L1 kNN with Epanechnikov weights, weighted LS for
  the velocity rows (cvxopt's unconstrained ``qp(Q,b)`` == ``solve(Q,-b)``),
  analytic constant-curvature Jacobian rows.
- :class:`RefMPC` — the LTI/LTV solve loop
  (`PredictiveControllers.py:56-164`): per-step re-identification, FTOCP
  solve, linearization-trajectory roll, ``OldInput`` threading.
- :class:`RefLMPC` — the safe-set machinery (`PredictiveControllers.py:286-513`):
  ``addTrajectory``/``computeCost`` backward DP, ``addPoint`` cross-lap
  appends, ``selectPoints`` windows with the Qfun lap-crossing corrections,
  s-wrap of ``zt``/``xLin`` (including, faithfully, the reference's
  ``xLin[4,-1]`` indexing slip — harmless there because ``xLin`` row N is
  never consumed before being overwritten by the roll), λ-successor ``zt``
  update, per-lap bookkeeping.
- :func:`run_lap` — the closed-loop simulator semantics
  (`SysModel.py:22-54`): solve -> (addPoint) -> plant step, exit at
  ``s > TrackLength``, s-wrapped final state, crossing state excluded from
  the returned trajectory.

Everything is float64, noise-free, and deliberately loop-structured (the JAX
framework is vectorized/masked; this is an independent transcription of the
reference's math, not of its code).
"""
import numpy as np

from lmpc_bench.reference import ref_ftocp, ref_plant
from lmpc_bench.reference.qp_ip import solve_qp

N_STATE, N_INPUT = 6, 2


class RefPredictiveModel:
    """Reference-semantics local system-ID (PredictiveModel.py:11-197)."""

    def __init__(self, curv_fn, n_laps_to_use, h=5.0, max_pts=7, dt=0.1):
        self.curv = curv_fn
        self.n_use = n_laps_to_use   # usedIt = range(trToUse) (:31)
        self.h = h                   # kernel bandwidth (:19)
        self.max_pts = max_pts       # MaxNumPoint (:18)
        self.dt = dt
        self.scaling = np.array([0.1, 1.0, 1.0, 1.0, 1.0])  # (:22-26)
        self.xs, self.us, self.lap_len = [], [], []

    def add_trajectory(self, x, u):
        """Sorted insert ascending by lap length (:35-46) => the fastest
        ``n_use`` laps are always the regression data."""
        x = np.asarray(x, float)
        u = np.asarray(u, float)
        T = x.shape[0]
        if not self.lap_len or T >= self.lap_len[-1]:
            pos = len(self.lap_len)
        else:
            pos = next(i for i, L in enumerate(self.lap_len) if T < L)
        self.xs.insert(pos, x)
        self.us.insert(pos, u)
        self.lap_len.insert(pos, T)

    def _neighbors(self, lap_i, z_feat):
        """computeIndices (:180-197): candidates are rows 0..T-2; threshold
        h, cap max_pts by argsort; Epanechnikov weights (not clamped)."""
        lx, lu = self.xs[lap_i], self.us[lap_i]
        feats = np.hstack([lx[:-1, :3], lu[:-1]])
        d = np.abs((feats - z_feat) * self.scaling).sum(axis=1)
        under = np.flatnonzero(d < self.h)
        if under.shape[0] >= self.max_pts:
            idx = np.argsort(d)[: self.max_pts]
        else:
            idx = under
        w = 0.75 * (1.0 - (d[idx] / self.h) ** 2)
        return idx, w

    def regression_and_linearization(self, x, u):
        """(x, u) -> (A, B, C) with x_{k+1} ≈ A x + B u + C (:48-139)."""
        x = np.asarray(x, float)
        u = np.asarray(u, float)
        sel = [self._neighbors(i, np.concatenate([x[:3], u]))
               for i in range(self.n_use)]

        def fit(input_col, y_cols):
            """Weighted LS over [vx,vy,wz,u_col,1] features (:141-178)."""
            rows_X, rows_y, rows_w = [], [], []
            for i, (idx, w) in enumerate(sel):
                lx, lu = self.xs[i], self.us[i]
                rows_X.append(np.hstack([lx[idx][:, :3],
                                         lu[idx][:, [input_col]]]))
                rows_y.append(lx[idx + 1][:, y_cols])
                rows_w.append(w)
            X = np.vstack(rows_X)
            y = np.vstack(rows_y)
            w = np.concatenate(rows_w)
            M = np.hstack([X, np.ones((X.shape[0], 1))])
            Q = M.T @ (w[:, None] * M)       # lamb = 0 (:20)
            rhs = M.T @ (w[:, None] * y)
            return np.linalg.solve(Q, rhs)   # cvxopt qp(Q,b): argmin ½θ'Qθ+b'θ

        A = np.zeros((N_STATE, N_STATE))
        B = np.zeros((N_STATE, N_INPUT))
        C = np.zeros(N_STATE)
        th = fit(1, [0])                     # vx row: input feature a (:29)
        A[0, :3], B[0, 1], C[0] = th[:3, 0], th[3, 0], th[4, 0]
        th = fit(0, [1, 2])                  # vy & wz rows: input delta (:30)
        A[1, :3], B[1, 0], C[1] = th[:3, 0], th[3, 0], th[4, 0]
        A[2, :3], B[2, 0], C[2] = th[:3, 1], th[3, 1], th[4, 1]

        # analytic constant-curvature kinematics rows (:99-135)
        vx, vy, wz, epsi, s, ey = x
        dt = self.dt
        cur = float(self.curv(s))
        den = 1.0 - cur * ey
        ce, se = np.cos(epsi), np.sin(epsi)
        A[3] = [-dt * ce / den * cur, dt * se / den * cur, dt,
                1 - dt * (-vx * se - vy * ce) / den * cur, 0.0,
                dt * (vx * ce - vy * se) / den ** 2 * cur * (-cur)]
        A[4] = [dt * ce / den, -dt * se / den, 0.0,
                dt * (-vx * se - vy * ce) / den, 1.0,
                -dt * (vx * ce - vy * se) / den ** 2 * (-cur)]
        A[5] = [dt * se, dt * ce, 0.0, dt * (vx * ce - vy * se), 0.0, 1.0]
        f = np.array([
            epsi + dt * (wz - (vx * ce - vy * se) / den * cur),
            s + dt * (vx * ce - vy * se) / den,
            ey + dt * (vx * se + vy * ce),
        ])
        C[3:] = f - A[3:] @ x
        return A, B, C


class RefMPC:
    """Reference LTI/LTV-MPC solve loop (PredictiveControllers.py:56-164)."""

    def __init__(self, N, Q, R, dR, Qf, q_slack, x_ref,
                 ey_max, delta_max, a_max,
                 A=None, B=None, pm=None, time_varying=False):
        self.N = N
        self.Q, self.R, self.dR, self.Qf = Q, R, dR, Qf
        self.q_slack, self.x_ref = q_slack, x_ref
        self.ey_max, self.delta_max, self.a_max = ey_max, delta_max, a_max
        self.A_lti, self.B_lti = A, B
        self.pm = pm
        self.time_varying = time_varying
        if time_varying:
            # xLin seeded from the last stored lap (:88-90)
            self.x_lin = pm.xs[-1][: N + 1].copy()
            self.u_lin = pm.us[-1][:N].copy()
        self.u_old = np.zeros(N_INPUT)
        self.x_pred = None
        self.u_pred = None
        self.qp_converged = True

    def _dynamics(self):
        N = self.N
        if self.time_varying:   # computeLTVdynamics (:140-145)
            seq = [self.pm.regression_and_linearization(self.x_lin[i],
                                                        self.u_lin[i])
                   for i in range(N)]
            return ([s[0] for s in seq], [s[1] for s in seq],
                    [s[2] for s in seq])
        Z = np.zeros(N_STATE)
        return [self.A_lti] * N, [self.B_lti] * N, [Z] * N

    def solve(self, x0):
        A_seq, B_seq, C_seq = self._dynamics()
        prob = ref_ftocp.build_ftocp(
            self.N, self.Q, self.R, self.dR, self.Qf, self.q_slack,
            self.x_ref, self.ey_max, self.delta_max, self.a_max,
            A_seq, B_seq, C_seq, x0, self.u_old,
        )
        z, _, _, conv = solve_qp(prob["H"], prob["q"], prob["G"],
                                 prob["g_eq"], prob["F"], prob["b"])
        self.qp_converged = bool(conv)
        N = self.N
        self.x_pred = z[: (N + 1) * N_STATE].reshape(N + 1, N_STATE)
        self.u_pred = z[(N + 1) * N_STATE:
                        (N + 1) * N_STATE + N * N_INPUT].reshape(N, N_INPUT)
        # feasibleStateInput (:157-159) + roll (:131-133)
        if self.time_varying:
            self.x_lin = np.vstack([self.x_pred[1:], self.x_pred[-1:]])
            self.u_lin = np.vstack([self.u_pred[1:], self.u_pred[-1:]])
        self.u_old = self.u_pred[0].copy()
        return self.u_pred[0].copy()


class RefLMPC:
    """Reference LMPC (PredictiveControllers.py:286-513), faithful semantics."""

    def __init__(self, N, dR, q_slack, q_terminal_slack,
                 num_ss_points, num_ss_it, pm, track_len,
                 ey_max=0.4, delta_max=0.5, a_max=10.0, dt=0.1):
        self.N = N
        self.dR = dR
        self.Q = np.zeros(N_STATE)
        self.R = np.zeros(N_INPUT)
        self.Qf = np.zeros(N_STATE)
        self.q_slack = q_slack
        self.q_terminal_slack = q_terminal_slack
        self.x_ref = np.zeros(N_STATE)
        self.ey_max, self.delta_max, self.a_max = ey_max, delta_max, a_max
        self.K = num_ss_points
        self.num_ss_it = num_ss_it
        self.pm = pm
        self.L = float(track_len)
        self.dt = dt
        # safe-set storage (:320-331)
        self.SS, self.uSS, self.Qfun, self.lap_time = [], [], [], []
        self.it = 0
        self.time_step = 0
        self.zt = np.array([0.0, 0.0, 0.0, 0.0, 10.0, 0.0])   # (:331)
        self.zt_u = np.zeros(N_INPUT)
        self.x_pred = None
        self.u_pred = None
        self.u_old = np.zeros(N_INPUT)
        self.x_lin = None
        self.u_lin = None
        self.qp_converged = True
        self.window_clamped = 0   # safety counter: 0 in faithful executions

    # ---- per-lap bookkeeping -------------------------------------------
    def compute_cost(self, x):
        """Backward-DP cost-to-go, 1 per step until s >= L (:447-464)."""
        T = x.shape[0]
        cost = 10000.0 * np.ones(T)
        for i in range(T):
            t = T - 1 - i
            if i == 0 or x[t, 4] >= self.L:
                cost[t] = 0.0
            else:
                cost[t] = cost[t + 1] + 1.0
        return cost

    def add_trajectory(self, x, u):
        """(:418-445)"""
        x = np.asarray(x, float)
        u = np.asarray(u, float)
        self.lap_time.append(x.shape[0])
        self.SS.append(x.copy())
        self.uSS.append(u.copy())
        self.Qfun.append(self.compute_cost(x))
        if self.it == 0:
            self.x_lin = x[1: self.N + 2].copy()
            self.u_lin = u[1: self.N + 1].copy()
        self.it += 1
        self.time_step = 0

    def add_point(self, x, u):
        """Append to the previous lap with s + L, cost - 1 (:466-476)."""
        j = self.it - 1
        xs = np.asarray(x, float) + np.array([0, 0, 0, 0, self.L, 0.0])
        self.SS[j] = np.vstack([self.SS[j], xs])
        self.uSS[j] = np.vstack([self.uSS[j], np.asarray(u, float)])
        self.Qfun[j] = np.append(self.Qfun[j], self.Qfun[j][-1] - 1.0)

    # ---- terminal-set selection ----------------------------------------
    def select_points(self, lap, zt, n_points):
        """(:478-513). ``n_points`` is the FLOAT numSS_Points/numSS_it + 1."""
        x = self.SS[lap]
        d = np.abs(x - zt).sum(axis=1)
        m = int(np.argmin(d))
        if m - n_points / 2 >= 0:
            idx = np.arange(m - int(n_points / 2), m + int(n_points / 2) + 1)
        else:
            idx = np.arange(m, m + int(n_points))
        if idx[-1] >= x.shape[0]:
            # The reference would raise IndexError here: near the finish line
            # zt's nearest neighbor in a lap that addPoint has NOT extended
            # (only the most recent lap is extended, :466-476) sits close
            # enough to the lap end that the window runs past it. Observed in
            # practice during the first LMPC laps while the safe set still
            # holds identical seed copies. Clamp to the last row — the same
            # deviation the JAX framework documents (controllers/lmpc.py) —
            # and count, so tests can report how often it engages.
            self.window_clamped += 1
            idx = np.minimum(idx, x.shape[0] - 1)
        pts = x[idx].T
        upts = self.uSS[lap][idx].T
        q = self.Qfun[lap][idx].copy()
        # Qfun lap-crossing correction (:501-512)
        if self.x_pred is not None and np.any(self.x_pred[:, 4] > self.L):
            if lap < self.it - 1:
                q = q + self.Qfun[lap][0]
            else:
                pred_curr = self.N - np.sum(self.x_pred[:, 4] > self.L)
                q = q + self.time_step + pred_curr
        return pts, upts, q

    def _terminal_components(self, x0):
        """addTerminalComponents (:386-416)."""
        # s-wrap zt / xLin at lap crossing (:391-394) — faithfully including
        # the reference's xLin[4,-1] slip (row 4's ey, not row N's s); it is
        # harmless because xLin is rolled from xPred right after the solve
        # and row N is never consumed by computeLTVdynamics.
        if self.zt[4] - x0[4] > self.L / 2:
            self.zt[4] = max(self.zt[4] - self.L, 0.0)
            self.x_lin[4, -1] = self.x_lin[4, -1] - self.L
        order = np.argsort(np.array(self.lap_time))[: self.num_ss_it]
        n_sel = self.K / self.num_ss_it + 1     # float, as in the reference
        ss_l, succ_l, succ_u_l, q_l = [], [], [], []
        for jj in order:
            pts, upts, q = self.select_points(jj, self.zt, n_sel)
            ss_l.append(pts[:, :-1])
            succ_l.append(pts[:, 1:])
            succ_u_l.append(upts[:, 1:])
            q_l.append(q[:-1])
        return (np.hstack(ss_l), np.hstack(succ_l), np.hstack(succ_u_l),
                np.concatenate(q_l))

    # ---- one control step ----------------------------------------------
    def solve(self, x0):
        x0 = np.asarray(x0, float)
        # computeLTVdynamics runs BEFORE the s-wrap (solve :116 precedes
        # addTerminalComponents :121)
        N = self.N
        seq = [self.pm.regression_and_linearization(self.x_lin[i],
                                                    self.u_lin[i])
               for i in range(N)]
        ss_pts, succ_x, succ_u, qfun_sel = self._terminal_components(x0)
        prob = ref_ftocp.build_ftocp(
            N, self.Q, self.R, self.dR, self.Qf, self.q_slack, self.x_ref,
            self.ey_max, self.delta_max, self.a_max,
            [s[0] for s in seq], [s[1] for s in seq], [s[2] for s in seq],
            x0, self.u_old,
            K=self.K, q_terminal_slack=self.q_terminal_slack,
            ss_points=ss_pts, qfun_sel=qfun_sel,
        )
        z, _, _, conv = solve_qp(prob["H"], prob["q"], prob["G"],
                                 prob["g_eq"], prob["F"], prob["b"])
        self.qp_converged = bool(conv)
        self.x_pred = z[: (N + 1) * N_STATE].reshape(N + 1, N_STATE)
        self.u_pred = z[(N + 1) * N_STATE:
                        (N + 1) * N_STATE + N * N_INPUT].reshape(N, N_INPUT)
        ola = (N + 1) * N_STATE + N * N_INPUT + 2 * N
        lam = z[ola: ola + self.K]
        # feasibleStateInput override: λ-successors (:382-384)
        self.zt = succ_x @ lam
        self.zt_u = succ_u @ lam
        # roll (:131-133)
        self.x_lin = np.vstack([self.x_pred[1:], self.zt])
        self.u_lin = np.vstack([self.u_pred[1:], self.zt_u])
        self.u_old = self.u_pred[0].copy()
        self.time_step += 1
        return self.u_pred[0].copy()


def run_lap(controller, x0, x_glob0, curv_fn, track_len, *,
            max_steps=1000, dt=0.1, lmpc_add_point=False):
    """Closed-loop lap with the reference simulator semantics
    (SysModel.py:22-54): exit at s > L, crossing state excluded from the
    returned trajectory, s-wrapped final state returned for the next lap."""
    x = np.asarray(x0, float).copy()
    g = np.asarray(x_glob0, float).copy()
    xs, us = [], []
    for _ in range(max_steps):
        u = controller.solve(x)
        xs.append(x.copy())
        us.append(u.copy())
        if lmpc_add_point:
            controller.add_point(x, u)   # flagLMPC wiring (SysModel.py:37-38)
        x, g = ref_plant.plant_step(x, g, u, curv_fn, dt=dt)
        if x[4] > track_len:
            break
    xF = x.copy()
    xF[4] -= track_len
    return np.array(xs), np.array(us), len(xs), (xF, g)
