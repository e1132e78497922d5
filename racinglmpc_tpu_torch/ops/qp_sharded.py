"""Sharded giant-QP solver: one dense QP's row blocks over a mesh of ranks
(port of ``racinglmpc_tpu/ops/qp_sharded.py``).

Solves ONE QP

    min 1/2 x'Px + q'x   s.t.   l <= Ax <= u

whose matrices are too large to hold (or to invert) on one device, by
splitting the rows of ``P`` and ``A`` over the ranks of a
:class:`~racinglmpc_tpu_torch.parallel.ScenarioMesh` (axis ``'block'``).
The batched dense solver (``ops/qp.py``) keeps serving the product FTOCP
(n = 200); this path is for n in the thousands, where the dense KKT inverse
cannot exist. A rank holds (n + m) n / p matrix entries plus O(n + m)
vectors.

Algorithm: OSQP-style ADMM in indirect mode. The x-update system

    K xt = rhs,   K = P + sigma I + A' diag(rho) A

is solved by Jacobi-preconditioned conjugate gradient, warm-started from
the previous iterate; diag(K) is assembled once (the constraint term scales
linearly with the adapted rho). Each K@v is three local products and two
collectives:

    t1 = all_gather( P_l @ v )                   # row blocks -> (n,)
    t3 = all_reduce( A_l' (rho_l * (A_l @ v)) )  # partial sums -> (n,)
    K@v = t1 + sigma v + t3

The CG vectors (x, r, p) are replicated; the constraint-space state (z, y,
l, u, rho, E) stays split by rows, and its updates are local. Ruiz
equilibration runs split as well: column norms are all-reduced with MAX,
row norms are local. Residuals are checked every ``check_every``
iterations, with OSQP's adaptive rho; then an absolute-residual refinement
tail (:class:`ShardedSolverConfig`).

The reference's ``while_loop``s are host loops here. Every exit test reads
a scalar that each rank computes from replicated values, so every rank
leaves each loop on the same iteration. The CG loop's test costs one host
sync per CG iteration; on the card the iteration itself is one CUDA graph
(its collectives captured with it). The iteration accounting is the
reference's, quirks included: a ``max_iter`` below ``check_every`` still
runs one whole chunk, and the refinement tail runs at least
``polish_check_every`` iterations, which do not count in ``iters``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from racinglmpc_tpu_torch.ops.qp import QPData
from racinglmpc_tpu_torch.parallel import mesh as mesh_mod

BLOCK_AXIS = "block"


@dataclasses.dataclass(frozen=True)
class ShardedSolverConfig:
    """ADMM + CG settings of the sharded solver (the reference's defaults).

    ``cg_tol`` is relative to ||rhs||. The refinement tail (``polish``)
    continues the ADMM with an absolute-only exit and the tighter
    ``polish_cg_tol``, and is accepted only on a material primal-residual
    improvement without a dual blow-up.
    """

    max_iter: int = 500
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    scaling_iters: int = 10
    check_every: int = 25
    cg_tol: float = 1e-6
    cg_max_iter: int = 200
    polish: bool = True
    polish_iters: int = 60
    polish_check_every: int = 20
    polish_cg_tol: float = 1e-8


class ShardedQPSolution(NamedTuple):
    x: torch.Tensor         # (n,) primal (original coordinates), every rank
    y: torch.Tensor         # (m,) dual, gathered on every rank
    pri_res: torch.Tensor   # () final unscaled primal residual (inf norm)
    dua_res: torch.Tensor   # () final unscaled dual residual (inf norm)
    solved: torch.Tensor    # () bool
    iters: torch.Tensor     # () int32 ADMM iterations until tolerance
    cg_iters: torch.Tensor  # () int32 CG iterations in all


def _pad_qp(qp: QPData, p: int):
    """Pad n and m of a batch-1 QP up to multiples of ``p``: extra
    variables are decoupled (unit diagonal in P, zero q and A columns, so
    their optimum is 0); extra rows are all-zero with free bounds. Returns
    (unbatched P, q, A, l, u, n, m)."""
    P, q, A, l, u = (t[0] for t in qp)
    n, m = P.shape[0], A.shape[0]
    n_pad, m_pad = (-n) % p, (-m) % p
    if n_pad == 0 and m_pad == 0:
        return P, q, A, l, u, n, m
    dt, dev = P.dtype, P.device
    P_ = torch.zeros((n + n_pad, n + n_pad), dtype=dt, device=dev)
    P_[:n, :n] = P
    idx = torch.arange(n, n + n_pad, device=dev)
    P_[idx, idx] = 1.0
    q_ = torch.zeros(n + n_pad, dtype=dt, device=dev)
    q_[:n] = q
    A_ = torch.zeros((m + m_pad, n + n_pad), dtype=dt, device=dev)
    A_[:m, :n] = A
    l_ = torch.full((m + m_pad,), float("-inf"), dtype=dt, device=dev)
    u_ = torch.full((m + m_pad,), float("inf"), dtype=dt, device=dev)
    l_[:m] = l
    u_[:m] = u
    return P_, q_, A_, l_, u_, n, m


class _Collectives:
    """The mesh's reductions over the block axis."""

    def __init__(self, mesh: mesh_mod.ScenarioMesh):
        self.mesh = mesh

    def _reduce(self, t, op):         # in place on a vector, a copy of a 0-dim
        out = t.reshape(1).clone() if t.dim() == 0 else t
        dist.all_reduce(out, op=op, group=self.mesh.group)
        return out[0] if t.dim() == 0 else out

    def gather(self, v):                  # row blocks -> the whole vector
        return mesh_mod.gather_tensor(v, self.mesh)

    def sum(self, v):
        return self._reduce(v, dist.ReduceOp.SUM)

    def max(self, v):
        return self._reduce(v, dist.ReduceOp.MAX)


class _CGLoop:
    """The conjugate-gradient loop's state in fixed buffers and one
    iteration on it: ``step`` updates x, r, p and r'z in place and sets
    ``go`` to the exit test r'r > tol2 for the next iteration. On the CPU
    ``run`` calls ``step`` eagerly; on the card it replays ``step``
    captured once as a CUDA graph, its collectives included, so an
    iteration costs one graph launch and the one host sync of the exit
    test instead of ~25 kernel launches and two collective calls. Both
    run the same operations on the same buffers."""

    def __init__(self, apply_K, n: int, ml: int, dt, dev, graph: bool):
        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        self.apply_K = apply_K
        self.x, self.r, self.p, self.dK = zeros(n), zeros(n), zeros(n), \
            zeros(n)
        self.rho_l, self.rz, self.tol2 = zeros(ml), zeros(), zeros()
        self.go = torch.zeros((), dtype=torch.bool, device=dev)
        self.graph = None
        if graph and torch.device(dev).type == "cuda":
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):      # warm-up before capture;
                for _ in range(2):             # the buffers are reset
                    self.step()                # before every use
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.step()

    def step(self) -> None:
        Kp = self.apply_K(self.p, self.rho_l)
        a = self.rz / torch.clamp(self.p @ Kp, min=1e-30)
        self.x.copy_(torch.addcmul(self.x, a, self.p))
        self.r.copy_(torch.addcmul(self.r, a, Kp, value=-1.0))
        z = self.r / self.dK
        rz_new = self.r @ z
        self.p.copy_(torch.addcmul(z, rz_new / torch.clamp(self.rz, min=1e-30),
                                   self.p))
        self.rz.copy_(rz_new)
        self.go.copy_(self.r @ self.r > self.tol2)

    def run(self, max_iter: int) -> int:
        """Iterate while ``go`` and fewer than ``max_iter`` iterations;
        returns the count. One host sync an iteration."""
        it = 0
        while it < max_iter and bool(self.go):
            if self.graph is None:
                self.step()
            else:
                self.graph.replay()
            it += 1
        return it


def _ruiz_sharded(P_l, q, A_l, l_l, u_l, iters: int, comm: _Collectives,
                  row0: int):
    """Modified Ruiz equilibration on row blocks (see
    ``qp._ruiz_equilibrate``): column norms are all-reduced with MAX, row
    norms and row scalings are local. D and c come back replicated, E
    split by rows."""
    dt, dev = P_l.dtype, P_l.device
    nl = P_l.shape[0]
    D = torch.ones(q.shape[0], dtype=dt, device=dev)
    E_l = torch.ones(A_l.shape[0], dtype=dt, device=dev)
    c = torch.ones((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    for _ in range(iters):
        coln = comm.max(torch.maximum(P_l.abs().amax(0), A_l.abs().amax(0)))
        d = 1.0 / torch.sqrt(torch.where(coln > 1e-12, coln, one))
        rown = A_l.abs().amax(1)
        e = 1.0 / torch.sqrt(torch.where(rown > 1e-12, rown, one))
        P_l = d[row0:row0 + nl, None] * P_l * d[None, :]
        q = d * q
        A_l = e[:, None] * A_l * d[None, :]
        l_l = e * l_l
        u_l = e * u_l
        cn = comm.max(P_l.abs().amax(0)).mean()
        gamma = 1.0 / torch.clamp(torch.maximum(cn, q.abs().max()),
                                  min=1e-12)
        P_l = gamma * P_l
        q = gamma * q
        D, E_l, c = D * d, E_l * e, c * gamma
    return P_l, q, A_l, l_l, u_l, D, E_l, c


def _solve_core(P_l, q, A_l, l_l, u_l, x_w, y_wl, cfg: ShardedSolverConfig,
                comm: _Collectives, row0: int, graph: bool = True):
    """One rank's part. Replicated: q, x_w; split by rows: the rest."""
    dt, dev = P_l.dtype, P_l.device
    nl = P_l.shape[0]
    P_l, q, A_l, l_l, u_l, D, E_l, c = _ruiz_sharded(
        P_l, q, A_l, l_l, u_l, cfg.scaling_iters, comm, row0)

    is_eq_l = torch.isfinite(l_l) & torch.isfinite(u_l) & (u_l - l_l < 1e-12)
    rho0_l = torch.where(is_eq_l, torch.full_like(l_l, cfg.rho *
                                                  cfg.rho_eq_scale),
                         torch.full_like(l_l, cfg.rho))
    sigma, alpha = cfg.sigma, cfg.alpha

    # Jacobi preconditioner: diag(K) = diag(P) + sigma + rho_fac * colsum0
    ar = torch.arange(nl, device=dev)
    diag_P = comm.gather(P_l[ar, row0 + ar])
    colsum0 = comm.sum((rho0_l[:, None] * A_l * A_l).sum(0))

    def apply_K(v, rho_l):
        t1 = comm.gather(P_l @ v)
        t3 = comm.sum(A_l.T @ (rho_l * (A_l @ v)))
        return torch.add(t1, v, alpha=sigma).add_(t3)

    st = _CGLoop(apply_K, q.shape[0], A_l.shape[0], dt, dev, graph)

    def cg(rhs, x0, rho_l, rho_fac, tol=None, dK=None):
        """Warm-started Jacobi PCG on K x = rhs (see :class:`_CGLoop`)."""
        if dK is None:
            dK = torch.clamp(diag_P + sigma + rho_fac * colsum0, min=1e-12)
        r = rhs - apply_K(x0, rho_l)
        z = r / dK
        st.x.copy_(x0)
        st.r.copy_(r)
        st.p.copy_(z)
        st.rz.copy_(r @ z)
        st.dK.copy_(dK)
        st.rho_l.copy_(rho_l)
        st.tol2.copy_(((cfg.cg_tol if tol is None else tol) ** 2)
                      * torch.clamp(rhs @ rhs, min=1e-30))
        st.go.copy_(r @ r > st.tol2)
        it = st.run(cfg.cg_max_iter)
        return st.x.clone(), it

    def residuals(x, y_l):
        # qp._residuals' definitions (z = clip(Ax, l, u))
        Ax_l = A_l @ x
        z_c = torch.clamp(Ax_l, l_l, u_l)
        pri = comm.max(((Ax_l - z_c) / E_l).abs().max())
        Px = comm.gather(P_l @ x)
        Aty = comm.sum(A_l.T @ y_l)
        dua = ((Px + q + Aty) * D / c).abs().max()
        pri_sc = comm.max(torch.maximum((Ax_l / E_l).abs().max(),
                                        (z_c / E_l).abs().max()))
        dua_sc = torch.maximum(
            torch.maximum((Px * D).abs().max(), (Aty * D).abs().max()),
            (q * D).abs().max()) / c
        return pri, dua, pri_sc, dua_sc

    def admm_iter(x, z_l, y_l, rho_l, rho_fac, tol=None, dK=None):
        rhs = sigma * x - q + comm.sum(A_l.T @ (rho_l * z_l - y_l))
        xt, cg_it = cg(rhs, x, rho_l, rho_fac, tol, dK)
        zt_l = A_l @ xt
        x_new = alpha * xt + (1.0 - alpha) * x
        z_rel = alpha * zt_l + (1.0 - alpha) * z_l
        z_new = torch.clamp(z_rel + y_l / rho_l, l_l, u_l)
        y_new = y_l + rho_l * (z_rel - z_new)
        return x_new, z_new, y_new, cg_it

    # warm start, scaled as the dense solver scales it (x = D x_s,
    # y = E y_s / c); non-finite warm values start from 0
    fin = torch.isfinite(x_w).all() & mesh_mod.all_ranks(
        torch.isfinite(y_wl), comm.mesh)
    x = torch.where(fin, x_w / D, torch.zeros_like(q))
    y_l = torch.where(fin, c * y_wl / E_l, torch.zeros_like(l_l))
    z_l = torch.clamp(A_l @ x, l_l, u_l)

    chunk = max(cfg.check_every, 1)
    # the dense solver's floor: max_iter % chunk trailing iterations are
    # dropped, and one whole chunk runs even when max_iter < chunk
    n_chunks = max(cfg.max_iter // chunk, 1)
    rho_fac = torch.ones((), dtype=dt, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    pri, dua = inf, inf
    done, iters, cg_tot, k = False, cfg.max_iter, 0, 0
    while not done and k < n_chunks:
        rho_l = rho0_l * rho_fac
        for _ in range(chunk):
            x, z_l, y_l, cg_it = admm_iter(x, z_l, y_l, rho_l, rho_fac)
            cg_tot += cg_it
        pri, dua, pri_sc, dua_sc = residuals(x, y_l)
        ok = bool((pri < cfg.eps_abs + cfg.eps_rel * pri_sc)
                  & (dua < cfg.eps_abs + cfg.eps_rel * dua_sc))
        if ok:
            iters = (k + 1) * chunk
        # OSQP's adaptive rho on the residual ratio (indirect mode needs no
        # refactorization: the next CG sees another operator)
        ratio = torch.sqrt(
            (pri / torch.clamp(pri_sc, min=1e-30))
            / torch.clamp(dua / torch.clamp(dua_sc, min=1e-30), min=1e-30))
        scale = torch.clamp(ratio, 0.1, 10.0)
        if not ok:
            rho_fac = torch.where((scale > 5.0) | (scale < 0.2),
                                  torch.clamp(rho_fac * scale, 1e-6, 1e6),
                                  rho_fac)
        k += 1
        done = ok

    if cfg.polish and cfg.polish_iters > 0:
        # refinement tail: absolute-only exit, tighter CG tolerance
        rho_l = rho0_l * rho_fac
        dK_tail = torch.clamp(diag_P + sigma + rho_fac * colsum0, min=1e-12)
        chunk_p = max(cfg.polish_check_every, 1)
        n_pchunks = max(cfg.polish_iters // chunk_p, 1)
        x_p, z_p, y_p, cg_p = x, z_l, y_l, cg_tot
        pri_p, dua_p = pri, dua
        done_p, kp = False, 0
        while not done_p and kp < n_pchunks:
            for _ in range(chunk_p):
                x_p, z_p, y_p, cg_it = admm_iter(
                    x_p, z_p, y_p, rho_l, rho_fac, cfg.polish_cg_tol,
                    dK_tail)
                cg_p += cg_it
            pri_p, dua_p, _, _ = residuals(x_p, y_p)
            done_p = bool((pri_p < cfg.eps_abs) & (dua_p < cfg.eps_abs))
            kp += 1
        fin = mesh_mod.all_ranks(
            torch.isfinite(x_p).all() & torch.isfinite(y_p).all(), comm.mesh)
        better = bool(fin & (pri_p < 0.7 * pri)
                      & (dua_p < 2.0 * dua + cfg.eps_abs))
        if better:
            done = done or bool((pri_p < cfg.eps_abs) & (dua_p < cfg.eps_abs))
            x, y_l, pri, dua, cg_tot = x_p, y_p, pri_p, dua_p, cg_p

    return D * x, comm.gather(E_l * y_l / c), pri, dua, done, iters, cg_tot


class Blocks(NamedTuple):
    """One rank's part of a padded QP: its rows of P and A (and of l, u)
    and the replicated q."""

    P_l: torch.Tensor   # (n_pad / p, n_pad)
    q: torch.Tensor     # (n_pad,)
    A_l: torch.Tensor   # (m_pad / p, n_pad)
    l_l: torch.Tensor   # (m_pad / p,)
    u_l: torch.Tensor
    n: int              # unpadded sizes
    m: int
    row0: int           # first row of P_l in P


def local_blocks(qp: QPData, mesh: mesh_mod.ScenarioMesh) -> Blocks:
    """Pad a batch-1 QP for ``mesh`` and keep this rank's rows, on the
    mesh's device."""
    P, q, A, l, u, n, m = _pad_qp(
        QPData(*(t.to(mesh.device) for t in qp)), mesh.size)
    nl, ml = P.shape[0] // mesh.size, A.shape[0] // mesh.size
    r = mesh.rank
    rows, crow = slice(r * nl, (r + 1) * nl), slice(r * ml, (r + 1) * ml)
    return Blocks(P[rows], q, A[crow], l[crow], u[crow], n, m, r * nl)


def solve_sharded(qp: QPData, mesh: mesh_mod.ScenarioMesh,
                  cfg: Optional[ShardedSolverConfig] = None,
                  x_warm: Optional[torch.Tensor] = None,
                  y_warm: Optional[torch.Tensor] = None,
                  axis_name: str = BLOCK_AXIS,
                  graph: bool = True) -> ShardedQPSolution:
    """Solve ONE dense QP (the port's ``QPData`` with a batch of 1) with
    its rows split over the ranks of ``mesh`` (``make_mesh(axis_name=
    BLOCK_AXIS)``). Every rank calls this with the same problem and keeps
    its own rows (:func:`local_blocks`); n and m are padded to multiples of
    the mesh size. ``x_warm`` / ``y_warm``: a primal / dual start in
    original coordinates, e.g. the previous solve of a slowly drifting
    problem. ``graph``: on the card, replay the CG iteration as a CUDA graph
    (``False`` launches its operations one by one, with the same
    results)."""
    if cfg is None:
        cfg = ShardedSolverConfig()
    if mesh.axis_name != axis_name:
        raise ValueError(f"solve_sharded requires a mesh over {axis_name!r}; "
                         f"got {mesh.axis_name!r}")
    if qp.q.dim() != 2 or qp.q.shape[0] != 1:
        raise ValueError("solve_sharded takes a QPData with a batch of 1")
    blk = local_blocks(qp, mesh)
    dt, dev = blk.q.dtype, blk.q.device
    n_pad, ml = blk.q.shape[0], blk.A_l.shape[0]
    x_w = torch.zeros(n_pad, dtype=dt, device=dev)
    y_w = torch.zeros(ml * mesh.size, dtype=dt, device=dev)
    if x_warm is not None:
        x_w[:blk.n] = x_warm.reshape(-1).to(dev, dt)
    if y_warm is not None:
        y_w[:blk.m] = y_warm.reshape(-1).to(dev, dt)
    x, y, pri, dua, solved, iters, cg_tot = _solve_core(
        blk.P_l, blk.q, blk.A_l, blk.l_l, blk.u_l, x_w,
        y_w[mesh.rank * ml:(mesh.rank + 1) * ml], cfg, _Collectives(mesh),
        blk.row0, graph)
    return ShardedQPSolution(
        x=x[:blk.n], y=y[:blk.m], pri_res=pri, dua_res=dua,
        solved=torch.tensor(solved, device=dev),
        iters=torch.tensor(iters, dtype=torch.int32, device=dev),
        cg_iters=torch.tensor(cg_tot, dtype=torch.int32, device=dev))
