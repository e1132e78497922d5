"""Float64 NumPy oracle for the reference plant semantics.

Independent re-implementation (from the model equations, restructured) of the
dual-frame Euler integration in `RacingLMPC src/fnc/simulator/SysModel.py:56-137`
and the PID law in `RacingLMPC src/fnc/Utilities.py:61-68`, used as the
parity fixture for the JAX plant. Noise-free by construction (parity tests run
with noise disabled on both sides).
"""
import numpy as np

# canonical vehicle constants (SysModel.py:61-70)
M, LF, LR, IZ = 1.98, 0.125, 0.125, 0.024
DF = DR = 0.8 * M * 9.81 / 2.0
CF = CR = 1.25
BF = BR = 1.0


def np_curvature_fn(trk):
    """Pure-NumPy curvature lookup built from a Track table (fast for loops)."""
    s0 = np.asarray(trk.s0, dtype=np.float64)
    curv = np.asarray(trk.curv, dtype=np.float64)
    L = float(trk.total_len)

    def f(s):
        s = float(s)
        if s > L:
            s -= L * np.floor(s / L)
        i = min(max(int(np.searchsorted(s0, s, side="right") - 1), 0), len(s0) - 1)
        return curv[i]

    return f


def plant_step(x, x_glob, u, curvature_fn, dt=0.1, substeps=100, noise=None):
    """One control step: `substeps` Euler substeps of both frames.

    curvature_fn: s -> signed curvature (float64).
    ``noise``: optional length-3 array added as ``0.01 * noise`` to
    (vx, vy, wz) of the curvilinear state after the substeps — the
    reference's per-control-step noise injection point (SysModel.py:139-145)
    with the clipped Gaussian supplied by the caller so parity tests can
    share one noise sequence across implementations.
    Returns (x_next, x_glob_next).
    """
    x = np.array(x, dtype=np.float64)
    g = np.array(x_glob, dtype=np.float64)
    delta, a = float(u[0]), float(u[1])
    dT = dt / substeps
    for _ in range(substeps):
        vx, vy, wz, epsi, s, ey = x
        psi, X, Y = g[3], g[4], g[5]

        af = delta - np.arctan2(vy + LF * wz, vx)
        ar = -np.arctan2(vy - LR * wz, vx)
        fyf = DF * np.sin(CF * np.arctan(BF * af))
        fyr = DR * np.sin(CR * np.arctan(BR * ar))

        dvx = a - fyf * np.sin(delta) / M + wz * vy
        dvy = (fyf * np.cos(delta) + fyr) / M - wz * vx
        dwz = (LF * fyf * np.cos(delta) - LR * fyr) / IZ

        k = float(curvature_fn(s))
        den = 1.0 - k * ey
        sdot = (vx * np.cos(epsi) - vy * np.sin(epsi)) / den

        g = np.array([
            vx + dT * dvx, vy + dT * dvy, wz + dT * dwz,
            psi + dT * wz,
            X + dT * (vx * np.cos(psi) - vy * np.sin(psi)),
            Y + dT * (vx * np.sin(psi) + vy * np.cos(psi)),
        ])
        x = np.array([
            vx + dT * dvx, vy + dT * dvy, wz + dT * dwz,
            epsi + dT * (wz - sdot * k),
            s + dT * sdot,
            ey + dT * (vx * np.sin(epsi) + vy * np.cos(epsi)),
        ])
    if noise is not None:
        x = x.copy()
        x[:3] += 0.01 * np.asarray(noise, dtype=np.float64)
    return x, g


def pid_u(x, vt=0.8):
    """Noise-free PID law (Utilities.py:61-68)."""
    return np.array([-0.6 * x[5] - 0.9 * x[3], 1.5 * (vt - x[0])], dtype=np.float64)


def closed_loop_lap(x0, curvature_fn, track_len, vt=0.8, max_steps=400,
                    dt=0.1, controller=None):
    """Noise-free closed-loop lap with early exit at s > track_len
    (Simulator.sim semantics, SysModel.py:22-54). Returns (xs, us, steps, xF)."""
    controller = controller or (lambda x: pid_u(x, vt))
    x = np.array(x0, dtype=np.float64)
    g = np.array([x0[0], x0[1], x0[2], 0.0, 0.0, 0.0])
    xs, us = [], []
    for _ in range(max_steps):
        u = controller(x)
        xs.append(x.copy())
        us.append(u.copy())
        x, g = plant_step(x, g, u, curvature_fn, dt=dt)
        if x[4] > track_len:
            break
    xF = x.copy()
    xF[4] -= track_len
    return np.array(xs), np.array(us), len(xs), xF
