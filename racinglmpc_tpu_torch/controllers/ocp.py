"""FTOCP assembly: constant templates on the host, per-step scatters batched.

Port of ``racinglmpc_tpu/controllers/ocp.py``. Decision vector layout:

    z = [ x_0..x_N | u_0..u_{N-1} | laneSlack (2N) | (λ_1..λ_K | termSlack) ]

:func:`make_templates` builds every constant block once (numpy, float64);
:func:`assemble_qp` scatters one step's dynamics, offsets, input-rate term
and safe-set data into them for a whole scenario batch (leading axis B).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from racinglmpc_tpu_torch.ops.qp import QPData
from racinglmpc_tpu_torch.utils.config import NU, NX


class StageDynamics(NamedTuple):
    """Per-stage affine models x_{k+1} = A_k x_k + B_k u_k + C_k."""

    A: torch.Tensor  # (B, N, 6, 6)
    B: torch.Tensor  # (B, N, 6, 2)
    C: torch.Tensor  # (B, N, 6)


class FTOCPTemplates(NamedTuple):
    H: torch.Tensor        # (nz, nz) quadratic cost (x2 convention baked in)
    q_const: torch.Tensor  # (nz,)
    F: torch.Tensor        # (mi, nz)
    b: torch.Tensor        # (mi,)
    G0: torch.Tensor       # (me, nz) equality skeleton
    E: torch.Tensor        # (me, 6)
    L0: torch.Tensor       # (me,)
    idx_A: torch.Tensor    # (N*36,) flat G indices of the -A_k blocks
    idx_B: torch.Tensor    # (N*12,) flat G indices of the -B_k blocks


@dataclasses.dataclass(frozen=True)
class FTOCPDims:
    """Static layout of the decision vector / constraint rows."""

    N: int
    K: int = 0
    n: int = NX
    d: int = NU
    nc: int = 2

    @property
    def nx_tot(self) -> int:
        return self.n * (self.N + 1)

    @property
    def nu_tot(self) -> int:
        return self.d * self.N

    @property
    def ns_tot(self) -> int:
        return self.nc * self.N

    @property
    def off_u(self) -> int:
        return self.nx_tot

    @property
    def off_slack(self) -> int:
        return self.nx_tot + self.nu_tot

    @property
    def off_lambda(self) -> int:
        return self.off_slack + self.ns_tot

    @property
    def off_tslack(self) -> int:
        return self.off_lambda + self.K

    @property
    def nz(self) -> int:
        base = self.nx_tot + self.nu_tot + self.ns_tot
        return base + (self.K + self.n if self.K else 0)

    @property
    def me(self) -> int:
        return self.nx_tot + ((self.n + 1) if self.K else 0)

    @property
    def mi(self) -> int:
        return self.ns_tot + 4 * self.N + self.ns_tot + self.K


def make_templates(*, N: int, Q, R, dR, Qf, q_slack, x_ref, ey_max: float,
                   delta_max: float, a_max: float, K: int = 0,
                   q_terminal_slack: float = 0.0, dtype=torch.float64,
                   device="cuda"):
    """Host-side (numpy) construction of all constant QP blocks."""
    dims = FTOCPDims(N=N, K=K)
    n, d, nc = dims.n, dims.d, dims.nc
    nz, me, mi = dims.nz, dims.me, dims.mi
    Q, R, dR, Qf, x_ref = (np.asarray(a, dtype=np.float64)
                           for a in (Q, R, dR, Qf, x_ref))

    H = np.zeros((nz, nz))
    for k in range(N):
        H[k * n:(k + 1) * n, k * n:(k + 1) * n] = np.diag(Q)
    H[N * n:(N + 1) * n, N * n:(N + 1) * n] = np.diag(Qf)
    ou = dims.off_u
    for k in range(N):
        H[ou + k * d:ou + (k + 1) * d, ou + k * d:ou + (k + 1) * d] = \
            np.diag(R + 2.0 * dR)
    H[ou + (N - 1) * d:ou + N * d, ou + (N - 1) * d:ou + N * d] -= np.diag(dR)
    for k in range(N - 1):
        off = np.diag(-dR)
        H[ou + k * d:ou + (k + 1) * d, ou + (k + 1) * d:ou + (k + 2) * d] = off
        H[ou + (k + 1) * d:ou + (k + 2) * d, ou + k * d:ou + (k + 1) * d] = off
    os_ = dims.off_slack
    H[os_:os_ + dims.ns_tot, os_:os_ + dims.ns_tot] = \
        q_slack[0] * np.eye(dims.ns_tot)
    if K:
        ot = dims.off_tslack
        H[ot:ot + n, ot:ot + n] = q_terminal_slack * np.eye(n)
    H = 2.0 * H

    q_const = np.zeros(nz)
    for k in range(N):
        q_const[k * n:(k + 1) * n] = -2.0 * Q * x_ref
    q_const[N * n:(N + 1) * n] = -2.0 * Qf * x_ref
    q_const[os_:os_ + dims.ns_tot] = q_slack[1]

    # rows: [lane 0..N-1 (soft) | input boxes | slack >= 0 | lambda >= 0]
    F = np.zeros((mi, nz))
    b = np.zeros(mi)
    r = 0
    for k in range(N):
        F[r, k * n + 5], F[r, os_ + k * nc], b[r] = 1.0, -1.0, ey_max
        r += 1
        F[r, k * n + 5], F[r, os_ + k * nc + 1], b[r] = -1.0, -1.0, ey_max
        r += 1
    for k in range(N):
        for col, sign, bound in ((0, 1.0, delta_max), (0, -1.0, delta_max),
                                 (1, 1.0, a_max), (1, -1.0, a_max)):
            F[r, ou + k * d + col], b[r] = sign, bound
            r += 1
    F[r:r + dims.ns_tot, os_:os_ + dims.ns_tot] = -np.eye(dims.ns_tot)
    r += dims.ns_tot
    if K:
        F[r:r + K, dims.off_lambda:dims.off_lambda + K] = -np.eye(K)
        r += K
    assert r == mi

    G0 = np.zeros((me, nz))
    G0[:dims.nx_tot, :dims.nx_tot] = np.eye(dims.nx_tot)
    E = np.zeros((me, n))
    E[:n, :n] = np.eye(n)
    L0 = np.zeros(me)
    if K:
        tr = dims.nx_tot
        G0[tr:tr + n, N * n:(N + 1) * n] = np.eye(n)
        G0[tr:tr + n, dims.off_tslack:dims.off_tslack + n] = np.eye(n)
        G0[tr + n, dims.off_lambda:dims.off_lambda + K] = 1.0
        L0[tr + n] = 1.0

    # flat indices of the per-step dynamics blocks inside G (row-major)
    i, a, c = np.meshgrid(np.arange(N), np.arange(n), np.arange(n),
                          indexing="ij")
    idx_A = ((n * (1 + i) + a) * nz + (n * i + c)).reshape(-1)
    i, a, c = np.meshgrid(np.arange(N), np.arange(n), np.arange(d),
                          indexing="ij")
    idx_B = ((n * (1 + i) + a) * nz + (ou + d * i + c)).reshape(-1)

    def t(arr):
        return torch.as_tensor(arr, dtype=dtype, device=device)

    def ti(arr):
        return torch.as_tensor(arr, dtype=torch.int64, device=device)

    return dims, FTOCPTemplates(
        H=t(H), q_const=t(q_const), F=t(F), b=t(b), G0=t(G0), E=t(E),
        L0=t(L0), idx_A=ti(idx_A), idx_B=ti(idx_B))


def assemble_qp(dims: FTOCPDims, tmpl: FTOCPTemplates, dyn: StageDynamics,
                x0: torch.Tensor, u_old: torch.Tensor, dR,
                ss_points: Optional[torch.Tensor] = None,
                qfun_sel: Optional[torch.Tensor] = None) -> QPData:
    """Scatter one step's data into the templates -> batched OSQP-form QP.

    ``x0`` (B, 6), ``u_old`` (B, 2), ``ss_points`` (B, 6, K),
    ``qfun_sel`` (B, K). Rows are [ineq; eq] with l = -inf on ineq rows.
    """
    n, d, N = dims.n, dims.d, dims.N
    dt = tmpl.H.dtype
    Bsz = x0.shape[0]
    G = tmpl.G0.expand(Bsz, -1, -1).clone()
    Gf = G.view(Bsz, -1)
    Gf[:, tmpl.idx_A] = -dyn.A.to(dt).reshape(Bsz, -1)
    Gf[:, tmpl.idx_B] = -dyn.B.to(dt).reshape(Bsz, -1)
    L = tmpl.L0.expand(Bsz, -1).clone()
    L[:, n:n * (N + 1)] = dyn.C.to(dt).reshape(Bsz, N * n)

    q = tmpl.q_const.expand(Bsz, -1).clone()
    q[:, dims.off_u:dims.off_u + d] = (
        -2.0 * torch.as_tensor(dR, dtype=dt, device=q.device) * u_old.to(dt))
    if dims.K:
        tr = dims.nx_tot
        G[:, tr:tr + n, dims.off_lambda:dims.off_lambda + dims.K] = \
            -ss_points.to(dt)
        q[:, dims.off_lambda:dims.off_lambda + dims.K] = qfun_sel.to(dt)

    g_eq = x0.to(dt) @ tmpl.E.T + L
    A = torch.cat([tmpl.F.expand(Bsz, -1, -1), G], dim=1)
    ninf = torch.full((Bsz, tmpl.b.shape[0]), float("-inf"), dtype=dt,
                      device=q.device)
    l = torch.cat([ninf, g_eq], dim=1)
    u = torch.cat([tmpl.b.expand(Bsz, -1), g_eq], dim=1)
    return QPData(P=tmpl.H.expand(Bsz, -1, -1), q=q, A=A, l=l, u=u)


def _shift_rows(v: torch.Tensor, width: int, count: int) -> torch.Tensor:
    m = v.reshape(v.shape[0], count, width)
    return torch.cat([m[:, 1:], m[:, -1:]], dim=1).reshape(v.shape[0], -1)


def shift_warm(dims: FTOCPDims, z: torch.Tensor, y: torch.Tensor):
    """Shift a batched solution (B, nz), (B, m) one stage forward (last
    entries duplicated; lambda / terminal blocks kept) for the warm start."""
    n, d, N, nc = dims.n, dims.d, dims.N, dims.nc
    parts = [_shift_rows(z[:, :dims.nx_tot], n, N + 1),
             _shift_rows(z[:, dims.off_u:dims.off_u + dims.nu_tot], d, N),
             _shift_rows(z[:, dims.off_slack:dims.off_slack + dims.ns_tot],
                         nc, N)]
    if dims.K:
        parts.append(z[:, dims.off_lambda:])
    z_s = torch.cat(parts, dim=1)

    o = 0
    parts = [_shift_rows(y[:, o:o + nc * N], nc, N)]
    o += nc * N
    parts.append(_shift_rows(y[:, o:o + 4 * N], 4, N))
    o += 4 * N
    parts.append(_shift_rows(y[:, o:o + nc * N], nc, N))
    o += nc * N
    if dims.K:
        parts.append(y[:, o:o + dims.K])
        o += dims.K
    parts.append(_shift_rows(y[:, o:o + dims.nx_tot], n, N + 1))
    o += dims.nx_tot
    if dims.K:
        parts.append(y[:, o:])
    return z_s, torch.cat(parts, dim=1)


def unpack(dims: FTOCPDims, z: torch.Tensor):
    """Split batched solutions by the layout: (x_pred (B, N+1, 6),
    u_pred (B, N, 2), slack (B, 2N), lam (B, K), tslack (B, 6)); the last
    two are None for plain MPC."""
    Bsz = z.shape[0]
    x_pred = z[:, :dims.nx_tot].reshape(Bsz, dims.N + 1, dims.n)
    u_pred = z[:, dims.off_u:dims.off_u + dims.nu_tot].reshape(
        Bsz, dims.N, dims.d)
    slack = z[:, dims.off_slack:dims.off_slack + dims.ns_tot]
    if dims.K:
        lam = z[:, dims.off_lambda:dims.off_lambda + dims.K]
        tslack = z[:, dims.off_tslack:dims.off_tslack + dims.n]
        return x_pred, u_pred, slack, lam, tslack
    return x_pred, u_pred, slack, None, None
