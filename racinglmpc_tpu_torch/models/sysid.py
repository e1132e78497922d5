"""System identification: the global LTI ridge fit and the per-step local
weighted LS.

Port of ``racinglmpc_tpu/models/sysid.py``. Everything carries a leading
scenario axis B:

- :func:`lti_regression` is the LTI-MPC stage's one-shot ridge fit
  x_{t+1} ~ A x_t + B u_t over pairs t in [1, steps-2] (sample 0 skipped),
  no intercept, ridge ``lamb I`` on the 8x8 normal matrix;
- :class:`LapStore` keeps the K shortest laps seen (fixed capacity);
- for each horizon query, each stored lap contributes its ``knn_max``
  nearest samples in the scaled-L1 metric on [vx, vy, wz, delta, a]
  (candidate rows 0..steps-2, argmin ties to the first index), with
  Epanechnikov weights that are zero at distance >= h;
- two 5x5 weighted normal equations (vx row on [vx, vy, wz, a, 1]; lateral
  rows on [vx, vy, wz, delta, 1]) are solved by unrolled Gauss-Jordan;
- the kinematic rows (epsi, s, ey) are the analytic constant-curvature
  Jacobian.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from racinglmpc_tpu_torch.models import track as track_mod
from racinglmpc_tpu_torch.utils.config import LMPCConfig

_EMPTY = 2**30  # sentinel length for empty slots ("infinitely slow")


class LapStore(NamedTuple):
    x: torch.Tensor      # (B, K, T, 6)
    u: torch.Tensor      # (B, K, T, 2)
    steps: torch.Tensor  # (B, K) int32; _EMPTY marks an unused slot


def make_lap_store(batch: int, n_laps: int, capacity: int,
                   dtype=torch.float32, device="cuda") -> LapStore:
    return LapStore(
        x=torch.zeros((batch, n_laps, capacity, 6), dtype=dtype, device=device),
        u=torch.zeros((batch, n_laps, capacity, 2), dtype=dtype, device=device),
        steps=torch.full((batch, n_laps), _EMPTY, dtype=torch.int32,
                         device=device),
    )


def add_lap(store: LapStore, x: torch.Tensor, u: torch.Tensor,
            steps: torch.Tensor) -> LapStore:
    """Insert a lap (x (B, T', 6), u (B, T', 2), steps (B,)) into each
    scenario's slowest slot, only if the new lap is strictly faster."""
    B, _, cap, _ = store.x.shape
    bi = torch.arange(B, device=store.x.device)
    slot = store.steps.argmax(-1)
    old = store.steps[bi, slot]
    steps = torch.minimum(steps.to(torch.int32), torch.full_like(old, cap))
    do = steps < old
    n = min(x.shape[1], cap)
    xk = torch.zeros((B, cap, 6), dtype=store.x.dtype, device=store.x.device)
    uk = torch.zeros((B, cap, 2), dtype=store.u.dtype, device=store.u.device)
    xk[:, :n] = x[:, :n].to(store.x.dtype)
    uk[:, :n] = u[:, :n].to(store.u.dtype)
    new_x, new_u, new_steps = store.x.clone(), store.u.clone(), store.steps.clone()
    new_x[bi, slot] = torch.where(do[:, None, None], xk, store.x[bi, slot])
    new_u[bi, slot] = torch.where(do[:, None, None], uk, store.u[bi, slot])
    new_steps[bi, slot] = torch.where(do, steps, old)
    return LapStore(x=new_x, u=new_u, steps=new_steps)


def lti_regression(x: torch.Tensor, u: torch.Tensor, lamb: float,
                   steps=None):
    """Ridge fit over stored trajectories x (B, T, 6), u (B, T, 2); rows
    ``>= steps`` (B,) are padding. Returns (A (B, 6, 6), B (B, 6, 2),
    err (B, 2, 6): max / min one-step residuals)."""
    Bsz, T, _ = x.shape
    t = torch.arange(T - 1, device=x.device)
    n_valid = (torch.full((Bsz,), T, device=x.device) if steps is None
               else steps.to(x.device)) - 1
    w = ((t >= 1) & (t < n_valid[:, None])).to(x.dtype)       # (B, T-1)
    X = torch.cat([x[:, :-1], u[:, :-1]], -1)                  # (B, T-1, 8)
    Y = x[:, 1:]
    Xw = X * w[..., None]
    Xt = X.transpose(1, 2)
    Q = Xt @ Xw + lamb * torch.eye(8, dtype=x.dtype, device=x.device)
    W = torch.linalg.solve(Q, Xw.transpose(1, 2) @ Y)          # (B, 8, 6)
    Wt = W.transpose(1, 2)
    resid = (X @ W - Y) * w[..., None]
    err = torch.stack([resid.amax(1), resid.amin(1)], 1)
    return Wt[:, :, :6], Wt[:, :, 6:8], err


def _solve_small_spd(Q: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve Q X = B for tiny SPD Q by unrolled Gauss-Jordan (diagonal
    pivots; SPD + ridge jitter make that safe)."""
    n = Q.shape[-1]
    M = torch.cat([Q, B], dim=-1)
    for k in range(n):
        row_k = M[..., k:k + 1, :] / M[..., k:k + 1, k:k + 1]
        M = M - M[..., :, k:k + 1] * row_k
        M = torch.cat([M[..., :k, :], row_k, M[..., k + 1:, :]], dim=-2)
    return M[..., :, n:]


def knn_select(store: LapStore, zq: torch.Tensor, cfg: LMPCConfig):
    """Per-lap kNN of every query: zq (B, N, 5) raw [vx, vy, wz, delta, a].

    Returns (idx, w), each (B, N, K, knn): row index within the lap and its
    Epanechnikov weight.
    """
    dt = store.x.dtype
    T = store.x.shape[-2]
    scaling = torch.as_tensor(cfg.feat_scaling, dtype=dt, device=zq.device)
    feats = torch.cat([store.x[..., :3], store.u], dim=-1)        # (B,K,T,5)
    diff = ((feats[:, None] - zq[:, :, None, None, :]) * scaling).abs()
    d = diff[..., 0]
    for j in range(1, 5):   # left-to-right, as the CUDA kernel sums
        d = d + diff[..., j]
    n_valid = torch.clamp(store.steps, max=T) - 1                 # (B,K)
    t_idx = torch.arange(T, device=zq.device)
    valid = (t_idx < n_valid[..., None]) & (store.steps < _EMPTY)[..., None]
    inf = torch.tensor(float("inf"), dtype=dt, device=zq.device)
    d = torch.where(valid[:, None], d, inf)                      # (B,N,K,T)
    idxs, ds = [], []
    for _ in range(cfg.knn_max):
        i = d.argmin(-1, keepdim=True)
        idxs.append(i)
        ds.append(d.gather(-1, i))
        d = d.scatter(-1, i, float("inf"))
    idx = torch.cat(idxs, -1)
    d_sel = torch.cat(ds, -1)
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a
    # multiplication by its reciprocal, which rounds differently from the
    # kernel's IEEE division (and these weights feed near-singular systems)
    q = d_sel / torch.full_like(d_sel, cfg.kernel_h)
    w = 0.75 * (1.0 - q * q)
    w = torch.where(d_sel < cfg.kernel_h, w, torch.zeros_like(w))
    return idx, w


def kinematic_rows(x: torch.Tensor, cur: torch.Tensor, h: float):
    """Analytic constant-curvature rows (epsi, s, ey) at x (..., 6).

    Returns (rows (..., 3, 6), f (..., 3)): the Jacobian rows and the
    one-step predictions they linearize."""
    vx, vy, wz, epsi, s, ey = x.unbind(-1)
    den = 1.0 - cur * ey
    den = torch.where(den >= 0, den.clamp(min=0.05), den.clamp(max=-0.05))
    ce, se = torch.cos(epsi), torch.sin(epsi)
    sdot = (vx * ce - vy * se) / den
    zero, one = torch.zeros_like(vx), torch.ones_like(vx)
    row_epsi = torch.stack([
        -h * ce / den * cur, h * se / den * cur, h * one,
        1.0 - h * (-vx * se - vy * ce) / den * cur, zero,
        h * (vx * ce - vy * se) / (den ** 2) * cur * (-cur)], -1)
    row_s = torch.stack([
        h * ce / den, -h * se / den, zero, h * (-vx * se - vy * ce) / den,
        one, -h * (vx * ce - vy * se) / (den ** 2) * (-cur)], -1)
    row_ey = torch.stack([h * se, h * ce, zero, h * (vx * ce - vy * se),
                          zero, one], -1)
    f = torch.stack([epsi + h * (wz - sdot * cur), s + h * sdot,
                     ey + h * (vx * se + vy * ce)], -1)
    return torch.stack([row_epsi, row_s, row_ey], -2), f


def local_linearization_horizon(store: LapStore, trk: track_mod.Track,
                                x_lin: torch.Tensor, u_lin: torch.Tensor,
                                cfg: LMPCConfig, dt_ctrl: float = 0.1):
    """Affine local models over the horizon:
    (B, N, 6), (B, N, 2) -> A (B, N, 6, 6), B (B, N, 6, 2), C (B, N, 6)."""
    dt = store.x.dtype
    x = x_lin.to(dt)
    u = u_lin.to(dt)
    Bsz, N = x.shape[0], x.shape[1]
    K, T = store.x.shape[1], store.x.shape[2]
    idx, w = knn_select(store, torch.cat([x[..., :3], u], -1), cfg)

    # gather selected rows + successors (clamped like the reference's
    # out-of-range gather), ordered lap-major as the reference stacks them
    base = (torch.arange(Bsz, device=x.device)[:, None, None, None] * K
            + torch.arange(K, device=x.device)[None, None, :, None]) * T
    flat_x = store.x.reshape(-1, 6)
    flat_u = store.u.reshape(-1, 2)
    rows = (base + idx).reshape(Bsz, N, -1)
    succ = (base + torch.clamp(idx + 1, max=T - 1)).reshape(Bsz, N, -1)
    xs, us, ys = flat_x[rows], flat_u[rows], flat_x[succ]
    w = w.reshape(Bsz, N, -1)

    ones = torch.ones_like(w)[..., None]
    reg = (cfg.reg_lambda + cfg.reg_jitter) * torch.eye(5, dtype=dt,
                                                        device=x.device)

    upper = torch.ones((5, 5), dtype=torch.bool, device=x.device).triu()

    def wls(M, Y):
        # weighted normal equations summed row by row in the stacking order
        # (upper triangle (w m_a) m_b, mirrored): the same float operations
        # in the same order as the CUDA kernel, whose 5x5 systems are near
        # singular when stored laps repeat (the seeded safe set)
        Q = torch.zeros(M.shape[:-2] + (5, 5), dtype=dt, device=x.device)
        b = torch.zeros(M.shape[:-2] + (5, Y.shape[-1]), dtype=dt,
                        device=x.device)
        for r in range(M.shape[-2]):
            wm = w[..., r, None] * M[..., r, :]
            Q = Q + wm[..., :, None] * M[..., r, None, :]
            b = b + wm[..., :, None] * Y[..., r, None, :]
        Q = torch.where(upper, Q, Q.transpose(-1, -2)) + reg
        return _solve_small_spd(Q, b)

    th_vx = wls(torch.cat([xs[..., :3], us[..., 1:2], ones], -1),
                ys[..., 0:1])[..., 0]                               # (B,N,5)
    th_lat = wls(torch.cat([xs[..., :3], us[..., 0:1], ones], -1),
                 ys[..., 1:3])                                      # (B,N,5,2)

    cur = track_mod.curvature(trk, x[..., 4])
    kin, f = kinematic_rows(x, cur, dt_ctrl)
    A = torch.zeros((Bsz, N, 6, 6), dtype=dt, device=x.device)
    Bm = torch.zeros((Bsz, N, 6, 2), dtype=dt, device=x.device)
    C = torch.zeros((Bsz, N, 6), dtype=dt, device=x.device)
    A[..., 0, :3] = th_vx[..., :3]
    A[..., 1, :3] = th_lat[..., :3, 0]
    A[..., 2, :3] = th_lat[..., :3, 1]
    Bm[..., 0, 1] = th_vx[..., 3]
    Bm[..., 1, 0] = th_lat[..., 3, 0]
    Bm[..., 2, 0] = th_lat[..., 3, 1]
    C[..., 0] = th_vx[..., 4]
    C[..., 1] = th_lat[..., 4, 0]
    C[..., 2] = th_lat[..., 4, 1]
    A[..., 3:, :] = kin
    C[..., 3:] = f - (kin @ x[..., None])[..., 0]
    return A, Bm, C
