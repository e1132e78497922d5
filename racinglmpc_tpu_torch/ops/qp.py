"""Batched dense QP solver: OSQP-style ADMM + active-set polish.

Port of ``racinglmpc_tpu/ops/qp.py`` for a batch of QPs

    min 1/2 x'Px + q'x   s.t.   l <= Ax <= u

with a leading scenario axis on every tensor. The reference vmaps a
per-problem solver whose loops are ``while_loop``s: under vmap the lanes
run in lockstep but each lane's result equals its unbatched result. The
port keeps that: every loop here runs while any lane is still active,
finished lanes are frozen by masks, and each lane keeps its own iteration
count.

Stages (reference ``qp.py`` line ranges in brackets):

- warm Ruiz equilibration with the ``scaling_refresh_every`` schedule
  [117-167, 419-443];
- K = P + sigma I + A' rho A and its Newton-Schulz inverse with the
  12-step power-iteration warm gate and the unconditional final squaring
  [185-300]; these are plain float32 GEMMs (``torch.matmul``, TF32 off),
  as the reference leaves them to XLA. With an FTOCP ``structure`` and
  ``kkt_structured`` the inverse starts from the exact block-tridiagonal
  build (``ops/kkt_band.structured_kinv``), squared once, and the
  Newton-Schulz guard verifies it [544-567];
- the ADMM loop: on CUDA float32 tensors with fixed rho and
  ``use_pallas`` it is the hand-written kernel ``ops/cuda_qp.py`` (B1);
  with ``pallas_fused_ns`` too (and no structured build, which takes
  precedence) the K build and the Newton-Schulz refresh move into the
  kernel as well: ``ops/cuda_qp_fused.py`` (B4) [500-535]; otherwise the
  warmup + adaptive-rho + early-exit chunks + rho-escalation rescue of the
  reference's XLA path [602-716];
- polish (LU, masked active set) and the epilogue [345-382, 725-772].
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from racinglmpc_tpu_torch.ops import cuda_qp, cuda_qp_fused, kkt_band
from racinglmpc_tpu_torch.utils.batched import lane_where as _w
from racinglmpc_tpu_torch.utils.batched import mv as _mv
from racinglmpc_tpu_torch.utils.batched import vm as _vm
from racinglmpc_tpu_torch.utils.config import SolverConfig


class QPData(NamedTuple):
    P: torch.Tensor  # (B, n, n) symmetric PSD cost
    q: torch.Tensor  # (B, n)
    A: torch.Tensor  # (B, m, n)
    l: torch.Tensor  # (B, m) (-inf for one-sided rows)
    u: torch.Tensor  # (B, m)


class FactorCache(NamedTuple):
    """Warm state carried across control steps (see the reference's
    ``FactorCache``): the scaled KKT inverse (or a (B, 0, 0) placeholder),
    the Ruiz scaling and the solve counter of the refresh schedule."""

    kinv: torch.Tensor   # (B, n, n) or (B, 0, 0)
    D: torch.Tensor      # (B, n)
    E: torch.Tensor      # (B, m)
    c: torch.Tensor      # (B,)
    valid: torch.Tensor  # (B,) bool
    age: torch.Tensor    # (B,) int32


def init_factor_cache(batch: int, n: int, m: int, dtype=torch.float32,
                      device="cuda", with_kinv: bool = True) -> FactorCache:
    k = n if with_kinv else 0
    return FactorCache(
        kinv=torch.zeros((batch, k, k), dtype=dtype, device=device),
        D=torch.ones((batch, n), dtype=dtype, device=device),
        E=torch.ones((batch, m), dtype=dtype, device=device),
        c=torch.ones((batch,), dtype=dtype, device=device),
        valid=torch.zeros((batch,), dtype=torch.bool, device=device),
        age=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


class QPSolution(NamedTuple):
    x: torch.Tensor        # (B, n)
    y: torch.Tensor        # (B, m)
    pri_res: torch.Tensor  # (B,) unscaled primal residual (inf norm)
    dua_res: torch.Tensor  # (B,)
    solved: torch.Tensor   # (B,) bool
    iters: torch.Tensor    # (B,) int32
    polished: torch.Tensor  # (B,) bool
    fac: FactorCache


def _amax(a):
    return a.abs().amax(-1)


def _ruiz_equilibrate(qp: QPData, n_sweeps, init=None):
    """Modified Ruiz equilibration (OSQP scaling), per lane.

    ``n_sweeps``: an int, or a (B,) tensor of per-lane sweep counts (lanes
    past their count are frozen). Returns the scaled problem and (D, E, c)
    with x = D x_s, y = E y_s / c.
    """
    P, q, A, l, u = qp
    Bsz, n = q.shape
    m = l.shape[1]
    dt, dev = q.dtype, q.device
    if init is not None:
        D, E, c = init
        P = c[:, None, None] * (D[:, :, None] * P * D[:, None, :])
        q = c[:, None] * (D * q)
        A = E[:, :, None] * A * D[:, None, :]
        l = E * l
        u = E * u
    else:
        D = torch.ones((Bsz, n), dtype=dt, device=dev)
        E = torch.ones((Bsz, m), dtype=dt, device=dev)
        c = torch.ones((Bsz,), dtype=dt, device=dev)

    if isinstance(n_sweeps, int):
        total, sweeps = n_sweeps, None
    else:
        total, sweeps = int(n_sweeps.max()), n_sweeps
    one = torch.ones((), dtype=dt, device=dev)
    for k in range(total):
        col = torch.maximum(P.abs().amax(1), A.abs().amax(1))
        d = 1.0 / torch.sqrt(torch.where(col > 1e-12, col, one))
        row = A.abs().amax(2)
        e = 1.0 / torch.sqrt(torch.where(row > 1e-12, row, one))
        P2 = d[:, :, None] * P * d[:, None, :]
        q2 = d * q
        A2 = e[:, :, None] * A * d[:, None, :]
        l2, u2 = e * l, e * u
        cn = P2.abs().amax(1).mean(-1)
        gamma = 1.0 / torch.clamp(torch.maximum(cn, _amax(q2)), min=1e-12)
        new = (gamma[:, None, None] * P2, gamma[:, None] * q2, A2, l2, u2,
               D * d, E * e, c * gamma)
        if sweeps is None:
            P, q, A, l, u, D, E, c = new
        else:
            act = k < sweeps
            P, q, A, l, u, D, E, c = (
                _w(act, a, b) for a, b in zip(new, (P, q, A, l, u, D, E, c)))
    return QPData(P, q, A, l, u), D, E, c


def _residuals(qp: QPData, x, y, D, E, c):
    """Unscaled primal/dual residual inf-norms + OSQP relative scales."""
    Ax = _mv(qp.A, x)
    z = torch.clamp(Ax, qp.l, qp.u)
    pri = _amax((Ax - z) / E)
    Px = _mv(qp.P, x)
    Aty = _vm(y, qp.A)
    dua = _amax((Px + qp.q + Aty) * D / c[:, None])
    pri_scale = torch.maximum(_amax(Ax / E), _amax(z / E))
    dua_scale = torch.maximum(torch.maximum(_amax(Px * D), _amax(Aty * D)),
                              _amax(qp.q * D)) / c
    return pri, dua, pri_scale, dua_scale


def _build_K(qp: QPData, rho, sigma: float):
    n = qp.q.shape[1]
    eye = torch.eye(n, dtype=qp.q.dtype, device=qp.q.device)
    return qp.P + sigma * eye + (qp.A.transpose(1, 2) * rho[:, None, :]) @ qp.A


def _ns_inverse(K, X0, warm_ok, tol: float, max_iters: int,
                staged: bool = False):
    """Newton-Schulz inverse X <- X(2I - KX) per lane (reference
    ``_ns_inverse``, same gates): warm start X0 only where a 12-step power
    iteration from the all-ones vector puts the spectral radius of
    I - K X0 below 0.9, else the norm-scaled Jacobi init; a restart pass
    from Jacobi when the first pass failed; an unconditional final
    squaring. Returns (X, resid)."""
    Bsz, n, _ = K.shape
    dt, dev = K.dtype, K.device
    I = torch.eye(n, dtype=dt, device=dev)
    d = 1.0 / torch.clamp(torch.diagonal(K, dim1=1, dim2=2), min=1e-12)
    KXj = K * d[:, None, :]
    cj = torch.sqrt(((I - KXj) ** 2).sum((1, 2)))
    Xj = (I * d[:, None, :]) / torch.clamp(cj, min=1.0)[:, None, None]

    big = torch.full((Bsz,), 1e5, dtype=dt, device=dev)
    if bool(warm_ok.any()):
        R0 = I - K @ X0
        r0_m = R0.abs().amax((1, 2))
        v = torch.full((Bsz, n), 1.0 / math.sqrt(n), dtype=dt, device=dev)
        nrm = torch.zeros((Bsz,), dtype=dt, device=dev)
        for _ in range(12):
            w = _mv(R0, v)
            nrm = torch.sqrt((w * w).sum(-1))
            v = w / torch.clamp(nrm, min=1e-30)[:, None]
        use_warm = (warm_ok & torch.isfinite(nrm) & (nrm < 0.9)
                    & torch.isfinite(r0_m))
        X_init = _w(use_warm, X0, Xj)
        r_init = torch.where(use_warm, r0_m, big)
    else:
        X_init, r_init = Xj, big

    def run_phase(X, r, level):
        X, r = X.clone(), r.clone()
        it = torch.zeros((Bsz,), dtype=torch.int32, device=dev)
        while True:
            act = (r > level) & (r < 1e6) & (it < max_iters)
            idx = act.nonzero()[:, 0]
            if idx.numel() == 0:
                return X, r
            if idx.numel() == Bsz:      # every lane active: no gathers
                R = I - K @ X
                X = X + X @ R
                r = R.abs().amax((1, 2))
                it += 1
                continue
            Xa = X[idx]
            R = I - K[idx] @ Xa
            X[idx] = Xa + Xa @ R
            r[idx] = R.abs().amax((1, 2))
            it[idx] += 1

    def run(X, r):
        if staged:
            X, r = run_phase(X, r, max(0.3, tol))
            X, r = run_phase(X, r, max(3e-2, tol))
        return run_phase(X, r, tol)

    X, resid = run(X_init, r_init)
    bad = ~torch.isfinite(resid) | (resid > 50 * tol)
    X2, resid2 = run(_w(bad, Xj, X), torch.where(bad, big, resid))
    R2 = I - K @ X2
    r2_m = R2.abs().amax((1, 2))
    ok2 = torch.isfinite(r2_m) & (r2_m < 1.0)
    X3 = _w(ok2, X2 + X2 @ R2, X2)
    return X3, torch.where(ok2, torch.minimum(resid2, r2_m), resid2)


def _make_admm_iter(qp: QPData, Kinv, rho, sigma: float, alpha: float,
                    refine_steps: int):
    """One ADMM iteration for a fixed factorization (reference
    ``_make_admm_iter``: Kinv @ rhs plus ``refine_steps`` refinement rounds
    against the exact operator)."""
    P, q, A, l, u = qp

    def apply_K(v):
        return _mv(P, v) + sigma * v + _vm(rho * _mv(A, v), A)

    def one_iter(x, z, y):
        rhs = sigma * x - q + _vm(rho * z - y, A)
        xt = _mv(Kinv, rhs)
        for _ in range(refine_steps):
            xt = xt + _mv(Kinv, rhs - apply_K(xt))
        zt = _mv(A, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        z_rel = alpha * zt + (1.0 - alpha) * z
        z_new = torch.clamp(z_rel + y / rho, l, u)
        y_new = y + rho * (z_rel - z_new)
        return x_new, z_new, y_new

    return one_iter


def _run_masked(one_iter, n_iter: int, active, x, z, y):
    """``n_iter`` iterations on the active lanes; the others are frozen."""
    for _ in range(n_iter):
        xn, zn, yn = one_iter(x, z, y)
        x, z, y = _w(active, xn, x), _w(active, zn, z), _w(active, yn, y)
    return x, z, y


def _polish(qp: QPData, x, y, is_eq, cfg: SolverConfig):
    """Masked active-set polish: the regularized reduced KKT solved by LU,
    with ``polish_refine_steps`` refinement rounds against the
    unregularized system."""
    P, q, A, l, u = qp
    Bsz, n = q.shape
    dt, dev = q.dtype, q.device
    low_act = ~is_eq & (y < -1e-12) & torch.isfinite(l)
    up_act = ~is_eq & (y > 1e-12) & torch.isfinite(u)
    act = is_eq | low_act | up_act
    b_act = torch.where(low_act, l, u)
    Am = A * act.to(dt)[:, :, None]
    eye = torch.eye(n, dtype=dt, device=dev)

    def make_kkt(dlt: float):
        top = torch.cat([P + dlt * eye, Am.transpose(1, 2)], dim=2)
        diag = torch.where(act, torch.full_like(l, -dlt), torch.ones_like(l))
        bot = torch.cat([Am, torch.diag_embed(diag)], dim=2)
        return torch.cat([top, bot], dim=1)

    M = make_kkt(cfg.polish_delta)
    M0 = make_kkt(0.0)
    rhs = torch.cat([-q, torch.where(act, b_act, torch.zeros_like(l))], dim=1)
    LU, piv = torch.linalg.lu_factor(M)
    sol = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
    for _ in range(cfg.polish_refine_steps):
        r = rhs - _mv(M0, sol)
        sol = sol + torch.linalg.lu_solve(LU, piv, r[..., None])[..., 0]
    x_p = sol[:, :n]
    y_p = torch.where(act, sol[:, n:], torch.zeros_like(l))
    return x_p, y_p


class _Prologue(NamedTuple):
    qp_s: QPData
    D: torch.Tensor
    E: torch.Tensor
    c: torch.Tensor
    is_eq: torch.Tensor
    rho0: torch.Tensor
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    kinv0: torch.Tensor
    warm_ok: torch.Tensor
    age: torch.Tensor
    keep_kinv: bool
    ns_tol: float


def _prologue(qp: QPData, cfg: SolverConfig, warm, fac) -> _Prologue:
    dt, dev = qp.q.dtype, qp.q.device
    Bsz, n = qp.q.shape
    m = qp.l.shape[1]
    is_eq = torch.isfinite(qp.l) & torch.isfinite(qp.u) & (qp.u - qp.l < 1e-12)

    if fac is not None and cfg.scaling_iters > 0:
        refresh = ~fac.valid
        if cfg.scaling_refresh_every > 0:
            refresh = refresh | (fac.age % cfg.scaling_refresh_every == 0)
        use_warm = fac.valid & ~refresh
        init = (_w(use_warm, fac.D.to(dt), torch.ones_like(qp.q)),
                _w(use_warm, fac.E.to(dt), torch.ones_like(qp.l)),
                torch.where(use_warm, fac.c.to(dt), torch.ones_like(fac.c, dtype=dt)))
        n_sweeps = torch.where(
            refresh, torch.full_like(fac.age, cfg.scaling_iters),
            torch.full_like(fac.age, min(cfg.scaling_warm_iters,
                                         cfg.scaling_iters)))
        qp_s, D, E, c = _ruiz_equilibrate(qp, n_sweeps, init=init)
    elif cfg.scaling_iters > 0:
        qp_s, D, E, c = _ruiz_equilibrate(qp, cfg.scaling_iters)
    else:
        qp_s = qp
        D = torch.ones((Bsz, n), dtype=dt, device=dev)
        E = torch.ones((Bsz, m), dtype=dt, device=dev)
        c = torch.ones((Bsz,), dtype=dt, device=dev)

    rho0 = torch.where(is_eq, torch.full_like(qp.l, cfg.rho * cfg.rho_eq_scale),
                       torch.full_like(qp.l, cfg.rho))
    if warm is not None:
        x_w, y_w = warm
        fin = torch.isfinite(x_w).all(-1) & torch.isfinite(y_w).all(-1)
        x = _w(fin, x_w.to(dt) / D, torch.zeros_like(qp.q))
        y = _w(fin, c[:, None] * y_w.to(dt) / E, torch.zeros_like(qp.l))
        z = torch.clamp(_mv(qp_s.A, x), qp_s.l, qp_s.u)
    else:
        x = torch.zeros_like(qp.q)
        z = torch.zeros_like(qp.l)
        y = torch.zeros_like(qp.l)

    ns_tol = cfg.ns_tol if cfg.ns_tol is not None else (
        1e-3 if dt == torch.float32 else 1e-9)
    keep_kinv = fac is None or fac.kinv.numel() > 0
    zeros_nn = torch.zeros((Bsz, n, n), dtype=dt, device=dev)
    no = torch.zeros((Bsz,), dtype=torch.bool, device=dev)
    if fac is not None and fac.kinv.numel() > 0:
        ratio = fac.D.to(dt) / torch.where(D > 0, D, torch.ones_like(D))
        kinv0 = fac.kinv.to(dt) * ratio[:, :, None] * ratio[:, None, :]
        warm_ok, age = fac.valid, fac.age
    elif fac is not None:
        kinv0, warm_ok, age = zeros_nn, no, fac.age
    else:
        kinv0, warm_ok = zeros_nn, no
        age = torch.zeros((Bsz,), dtype=torch.int32, device=dev)
    return _Prologue(qp_s, D, E, c, is_eq, rho0, x, z, y, kinv0, warm_ok,
                     age, keep_kinv, ns_tol)


def use_kernel(cfg: SolverConfig, qp: QPData) -> bool:
    """The ADMM kernel's engagement rule (reference ``qp.py:493-498``, with
    "backend is TPU" read as "the tensors are on CUDA")."""
    return (cfg.use_pallas and qp.q.dtype == torch.float32
            and not cfg.adaptive_rho
            and (qp.q.is_cuda or cfg.pallas_interpret))


def admm_inputs(qp: QPData, cfg: SolverConfig, warm=None, fac=None,
                structure=None):
    """The kernel path's prologue: returns (prologue, Kinv1, ns_resid1),
    i.e. exactly what :func:`solve` hands to ``cuda_qp.admm_iterate``.
    With ``structure`` and ``cfg.kkt_structured`` the inverse is the
    structured build, squared once, then guarded by ``_ns_inverse`` (whose
    final squaring is the second one)."""
    pro = _prologue(qp, cfg, warm, fac)
    K1 = _build_K(pro.qp_s, pro.rho0, cfg.sigma)
    if structure is not None and cfg.kkt_structured:
        X_st = kkt_band.structured_kinv(K1, structure)
        eye = torch.eye(K1.shape[-1], dtype=K1.dtype, device=K1.device)
        X_st = X_st + X_st @ (eye - K1 @ X_st)
        X0, warm_ok = X_st, torch.ones_like(pro.warm_ok)
    else:
        X0, warm_ok = pro.kinv0, pro.warm_ok
    Kinv1, ns_resid1 = _ns_inverse(K1, X0, warm_ok, pro.ns_tol,
                                   cfg.ns_max_iters,
                                   staged=cfg.ns_staged_precision)
    return pro, Kinv1, ns_resid1


def kernel_args(pro: _Prologue, Kinv1, cfg: SolverConfig) -> dict:
    """Keyword arguments of ``cuda_qp.admm_iterate`` for this solve."""
    s = pro.qp_s
    return dict(
        P=s.P.contiguous(), Kinv=Kinv1.contiguous(), A=s.A.contiguous(),
        q=s.q.contiguous(), l=s.l.contiguous(), u=s.u.contiguous(),
        rho=pro.rho0.contiguous(), D=pro.D.contiguous(),
        E=pro.E.contiguous(), c=pro.c.contiguous(),
        x0=pro.x.contiguous(), z0=pro.z.contiguous(), y0=pro.y.contiguous(),
        sigma=cfg.sigma, alpha=cfg.alpha, eps_abs=cfg.eps_abs,
        eps_rel=cfg.eps_rel, max_iter=cfg.max_iter,
        check_every=cfg.check_every, refine_steps=cfg.kkt_refine_steps,
        rescue_max_iter=cfg.rescue_max_iter,
        rescue_rho_scale=cfg.rescue_rho_scale,
        rescue_trigger=cfg.rescue_trigger, rescue_exit=cfg.rescue_exit,
        ns_tol=float(pro.ns_tol), ns_max_iters=cfg.ns_max_iters,
    )


def fused_args(pro: _Prologue, cfg: SolverConfig) -> dict:
    """Keyword arguments of ``cuda_qp_fused.admm_iterate_fused``."""
    s = pro.qp_s
    return dict(
        P=s.P.contiguous(), A=s.A.contiguous(), kinv0=pro.kinv0.contiguous(),
        warm_ok=pro.warm_ok.contiguous(), q=s.q.contiguous(),
        l=s.l.contiguous(), u=s.u.contiguous(), rho=pro.rho0.contiguous(),
        D=pro.D.contiguous(), E=pro.E.contiguous(), c=pro.c.contiguous(),
        x0=pro.x.contiguous(), z0=pro.z.contiguous(), y0=pro.y.contiguous(),
        sigma=cfg.sigma, alpha=cfg.alpha, eps_abs=cfg.eps_abs,
        eps_rel=cfg.eps_rel, max_iter=cfg.max_iter,
        check_every=cfg.check_every, refine_steps=cfg.kkt_refine_steps,
        ns_tol=float(pro.ns_tol), ns_max_iters=cfg.ns_max_iters,
        rescue_max_iter=cfg.rescue_max_iter,
        rescue_rho_scale=cfg.rescue_rho_scale,
        rescue_trigger=cfg.rescue_trigger, rescue_exit=cfg.rescue_exit,
    )


def fused_inputs(qp: QPData, cfg: SolverConfig, warm=None,
                 fac=None) -> dict:
    """Keyword arguments of ``cuda_qp_fused.admm_iterate_fused`` for this
    solve: exactly what :func:`solve`'s fused branch hands to it."""
    return fused_args(_prologue(qp, cfg, warm, fac), cfg)


def solve(qp: QPData, cfg: SolverConfig = SolverConfig(), warm=None,
          fac: Optional[FactorCache] = None, structure=None) -> QPSolution:
    """Solve a batch of QPs. ``warm``: (x, y) in original coordinates;
    ``fac``: the previous solve's :class:`FactorCache`; ``structure``: the
    FTOCP's ``kkt_band.BandStructure``, read by the structured KKT inverse
    when ``cfg.kkt_structured`` (which then takes precedence over the
    fused-prologue kernel, as in the reference)."""
    kernel = use_kernel(cfg, qp)
    if kernel and cfg.pallas_iter_precision != "highest":
        raise NotImplementedError(
            "the CUDA ADMM kernels iterate in full float32 only "
            "(pallas_iter_precision='highest')")
    use_structured = structure is not None and cfg.kkt_structured

    orig = qp
    dt = qp.q.dtype
    total = cfg.max_iter
    sigma, alpha = cfg.sigma, cfg.alpha
    if kernel and cfg.pallas_fused_ns and not use_structured:
        pro = _prologue(qp, cfg, warm, fac)
        r = cuda_qp_fused.admm_iterate_fused(**fused_args(pro, cfg))
        D, E, c = pro.D, pro.E, pro.c
        return _finish(orig, cfg, x_u=D * r.x, y_u=E * r.y / c[:, None],
                       solved=r.solved, iters=r.iters, kinv=r.kinv,
                       ns_resid=r.ns_resid, pre=(r.pri, r.dua), is_eq=pro.is_eq,
                       D=D, E=E, c=c, age=pro.age, ns_tol=pro.ns_tol,
                       keep_kinv=pro.keep_kinv)
    pro, Kinv1, ns_resid1 = admm_inputs(
        qp, cfg, warm, fac, structure if use_structured else None)
    qp_s, D, E, c = pro.qp_s, pro.D, pro.E, pro.c
    common = dict(is_eq=pro.is_eq, D=D, E=E, c=c, age=pro.age,
                  ns_tol=pro.ns_tol, keep_kinv=pro.keep_kinv)

    if kernel:
        x, y, pri_k, dua_k, iters, solved, _ = cuda_qp.admm_iterate(
            **kernel_args(pro, Kinv1, cfg))
        return _finish(orig, cfg, x_u=D * x, y_u=E * y / c[:, None],
                       solved=solved, iters=iters, kinv=Kinv1,
                       ns_resid=ns_resid1, pre=(pri_k, dua_k), **common)

    # --- phase 1: warmup at rho0, then one rho adaptation -------------------
    warmup = min(cfg.warmup_iters, total)
    rho = pro.rho0
    x, z, y = pro.x, pro.z, pro.y
    one_iter = _make_admm_iter(qp_s, Kinv1, rho, sigma, alpha,
                               cfg.kkt_refine_steps)
    for _ in range(warmup):
        x, z, y = one_iter(x, z, y)
    pri, dua, pri_sc, dua_sc = _residuals(qp_s, x, y, D, E, c)
    solved = ((pri < cfg.eps_abs + cfg.eps_rel * pri_sc)
              & (dua < cfg.eps_abs + cfg.eps_rel * dua_sc))
    iters = torch.where(solved, warmup, total).to(torch.int32)
    if cfg.adaptive_rho:
        ratio = torch.sqrt(
            (pri / torch.clamp(pri_sc, min=1e-30))
            / torch.clamp(dua / torch.clamp(dua_sc, min=1e-30), min=1e-30))
        scale = torch.clamp(ratio, 0.2, 5.0)
        adapt = ~solved & ((scale > 2.0) | (scale < 0.5))
        rho = _w(adapt, torch.clamp(rho * scale[:, None], 1e-6, 1e6), rho)

    # --- phase 2: fixed rho, early-exit chunks ------------------------------
    K2 = _build_K(qp_s, rho, sigma)
    all_true = torch.ones_like(solved)
    Kinv2, ns_resid = _ns_inverse(K2, Kinv1, all_true, pro.ns_tol,
                                  cfg.ns_max_iters,
                                  staged=cfg.ns_staged_precision)
    chunk = max(cfg.check_every, 1)
    n_chunks = max((total - warmup) // chunk, 0)
    one_iter = _make_admm_iter(qp_s, Kinv2, rho, sigma, alpha,
                               cfg.kkt_refine_steps)
    done = solved
    for k in range(n_chunks):
        active = ~done
        if not bool(active.any()):
            break
        x, z, y = _run_masked(one_iter, chunk, active, x, z, y)
        pri, dua, pri_sc, dua_sc = _residuals(qp_s, x, y, D, E, c)
        ok = ((pri < cfg.eps_abs + cfg.eps_rel * pri_sc)
              & (dua < cfg.eps_abs + cfg.eps_rel * dua_sc))
        newly = ok & active
        iters = torch.where(newly, warmup + (k + 1) * chunk, iters)
        done = done | newly
    solved = solved | done

    # --- rho-escalation rescue (only lanes whose primal residual would be
    # rejected; for the others rho, K and the iterates are unchanged) -------
    if cfg.rescue_max_iter > 0:
        pri_r = _residuals(qp_s, x, y, D, E, c)[0]
        need = pri_r > cfg.rescue_trigger
        idx = need.nonzero()[:, 0]
        if idx.numel():
            s = cfg.rescue_rho_scale
            sub = QPData(*(t[idx] for t in qp_s))
            rho_r = rho[idx] * s
            Kinv3, _ = _ns_inverse(
                _build_K(sub, rho_r, sigma), Kinv2[idx] / s,
                torch.ones_like(idx, dtype=torch.bool), pro.ns_tol,
                cfg.ns_max_iters, staged=cfg.ns_staged_precision)
            one_iter_r = _make_admm_iter(sub, Kinv3, rho_r, sigma, alpha,
                                         cfg.kkt_refine_steps)
            chunk_r = max(cfg.check_every, 1)
            n_rchunks = max(-(-cfg.rescue_max_iter // chunk_r), 1)
            it_main = torch.clamp(iters[idx], max=total)
            it_r = it_main + cfg.rescue_max_iter
            xs, zs, ys = x[idx], z[idx], y[idx]
            Ds, Es, cs = D[idx], E[idx], c[idx]
            done_r = torch.zeros_like(idx, dtype=torch.bool)
            for k in range(n_rchunks):
                active = ~done_r
                if not bool(active.any()):
                    break
                xs, zs, ys = _run_masked(one_iter_r, chunk_r, active,
                                         xs, zs, ys)
                p, d_, psc, dsc = _residuals(sub, xs, ys, Ds, Es, cs)
                ok = (((p < cfg.eps_abs + cfg.eps_rel * psc)
                       & (d_ < cfg.eps_abs + cfg.eps_rel * dsc))
                      | (p < cfg.rescue_exit))
                newly = ok & active
                used = min((k + 1) * chunk_r, cfg.rescue_max_iter)
                it_r = torch.where(newly, it_main + used, it_r)
                done_r = done_r | newly
            x, z, y = x.clone(), z.clone(), y.clone()
            x[idx], z[idx], y[idx] = xs, zs, ys
            iters = iters.clone()
            iters[idx] = it_r.to(iters.dtype)

    return _finish(orig, cfg, x_u=D * x, y_u=E * y / c[:, None],
                   solved=solved, iters=iters, kinv=Kinv2, ns_resid=ns_resid,
                   **common)


def _finish(orig: QPData, cfg: SolverConfig, *, x_u, y_u, solved, iters,
            kinv, ns_resid, ns_tol, is_eq, D, E, c, age, pre=None,
            keep_kinv=True) -> QPSolution:
    """Shared epilogue: optional polish, final residuals, cache packing.
    ``pre``: the kernel's own unscaled (pri, dua) at exit, reused when
    polish is off."""
    Bsz, n = x_u.shape
    m = y_u.shape[1]
    dt, dev = x_u.dtype, x_u.device
    ones_n = torch.ones((Bsz, n), dtype=dt, device=dev)
    ones_m = torch.ones((Bsz, m), dtype=dt, device=dev)
    one = torch.ones((Bsz,), dtype=dt, device=dev)
    if cfg.polish:
        x_p, y_p = _polish(orig, x_u, y_u, is_eq, cfg)
        pri_u, dua_u, _, _ = _residuals(orig, x_u, y_u, ones_n, ones_m, one)
        pri_p, dua_p, _, _ = _residuals(orig, x_p, y_p, ones_n, ones_m, one)
        finite = torch.isfinite(x_p).all(-1) & torch.isfinite(y_p).all(-1)
        better = finite & (torch.maximum(pri_p, dua_p)
                           < torch.maximum(pri_u, dua_u))
        x_u = _w(better, x_p, x_u)
        y_u = _w(better, y_p, y_u)
        polished = better
    else:
        polished = torch.zeros((Bsz,), dtype=torch.bool, device=dev)

    if pre is not None and not cfg.polish:
        pri_f, dua_f = pre
        solved_f = solved
    else:
        pri_f, dua_f, pri_sc, dua_sc = _residuals(orig, x_u, y_u, ones_n,
                                                  ones_m, one)
        solved_f = ((pri_f < cfg.eps_abs + cfg.eps_rel * pri_sc)
                    & (dua_f < cfg.eps_abs + cfg.eps_rel * dua_sc))
    fac_out = FactorCache(
        kinv=kinv if keep_kinv else kinv[:, :0, :0],
        D=D, E=E, c=c,
        valid=torch.isfinite(kinv).all(-1).all(-1) & (ns_resid < 50 * ns_tol),
        age=age + 1,
    )
    return QPSolution(x=x_u, y=y_u, pri_res=pri_f, dua_res=dua_f,
                      solved=solved_f | solved, iters=iters.to(torch.int32),
                      polished=polished, fac=fac_out)
