"""LMPC: sampled-safe-set terminal machinery over fixed-capacity buffers.

Port of ``racinglmpc_tpu/controllers/lmpc.py`` with an explicit leading
scenario axis B on every buffer (the reference vmaps per-scenario
functions). Semantics kept from the reference, each documented there:
the cost-to-go DP, the safe-set selection window over the ``num_ss_it``
fastest laps (the most recent one extended by the pending addPoint rows),
the Qfun lap-crossing correction, the s-wrap of zt / the last linearization
point, addPoint via the extension buffer flushed once per lap, the accept
rule (finite and primal residual < ``accept_pri_res``), hold on reject,
the PID fallback after ``fallback_after`` rejects, and zt from the safe-set
successors weighted by lambda.

Buffers are updated functionally (new tensors), like the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from racinglmpc_tpu_torch.controllers import ocp
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models import track as track_mod
from racinglmpc_tpu_torch.ops import cuda_sysid, kkt_band
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.utils.batched import lane_where as _w
from racinglmpc_tpu_torch.utils.config import LMPCConfig, SolverConfig

_EMPTY_TIME = 2**30
_PAD_QFUN = 10000.0


def _ar(t: torch.Tensor) -> torch.Tensor:
    return torch.arange(t.shape[0], device=t.device)


class SafeSet(NamedTuple):
    x: torch.Tensor         # (B, max_laps, max_pts, 6)
    u: torch.Tensor         # (B, max_laps, max_pts, 2)
    x_glob: torch.Tensor    # (B, max_laps, glob_pts, 6) (viz only)
    qfun: torch.Tensor      # (B, max_laps, max_pts) cost-to-go
    n_pts: torch.Tensor     # (B, max_laps) int32 valid rows
    lap_time: torch.Tensor  # (B, max_laps) int32 lap length in steps
    n_laps: torch.Tensor    # (B,) int32 stored laps


def make_safe_set(batch: int, max_laps: int, max_pts: int,
                  dtype=torch.float32, glob_pts: Optional[int] = None,
                  device="cuda") -> SafeSet:
    gp = max_pts if glob_pts is None else glob_pts
    kw = dict(dtype=dtype, device=device)
    ki = dict(dtype=torch.int32, device=device)
    return SafeSet(
        x=torch.zeros((batch, max_laps, max_pts, 6), **kw),
        u=torch.zeros((batch, max_laps, max_pts, 2), **kw),
        x_glob=torch.zeros((batch, max_laps, gp, 6), **kw),
        qfun=torch.full((batch, max_laps, max_pts), _PAD_QFUN, **kw),
        n_pts=torch.zeros((batch, max_laps), **ki),
        lap_time=torch.full((batch, max_laps), _EMPTY_TIME, **ki),
        n_laps=torch.zeros((batch,), **ki),
    )


def compute_qfun(s: torch.Tensor, steps: torch.Tensor, track_len
                 ) -> torch.Tensor:
    """Backward-DP cost-to-go over laps s (B, T): cost[steps-1] = 0, and
    going backwards cost[t] = cost[t+1] + 1 while s[t] < L, reset to 0 at
    a crossed state; rows >= steps keep 10000. Closed form: the distance
    to the next reset row (or to T when there is none)."""
    T = s.shape[-1]
    t = torch.arange(T, device=s.device)
    reset = (t == (steps[:, None] - 1)) | (s >= track_len)
    at = torch.where(reset, t, torch.full_like(t, T))
    nxt = torch.flip(torch.cummin(torch.flip(at, [-1]), -1).values, [-1])
    cost = (nxt - t).to(s.dtype)
    return torch.where(t < steps[:, None], cost,
                       torch.full_like(cost, _PAD_QFUN))


def _pad_rows(a: torch.Tensor, rows: int, dtype) -> torch.Tensor:
    out = torch.zeros((a.shape[0], rows, a.shape[2]), dtype=dtype,
                      device=a.device)
    k = min(a.shape[1], rows)
    out[:, :k] = a[:, :k].to(dtype)
    return out


def add_trajectory(ss: SafeSet, x, u, x_glob, steps, track_len) -> SafeSet:
    """Store a completed lap (x (B, T', 6), ...) in each scenario's next
    free slot; once full, the newest lap overwrites the last slot."""
    B, max_laps, T, _ = ss.x.shape
    Tg = ss.x_glob.shape[2]
    bi = _ar(ss.n_laps)
    slot = torch.clamp(ss.n_laps, max=max_laps - 1).long()
    steps = torch.clamp(steps.to(torch.int32), max=T)
    xk = _pad_rows(x, T, ss.x.dtype)
    qf = compute_qfun(xk[..., 4], steps, track_len)
    new = SafeSet(*(t.clone() for t in ss))
    new.x[bi, slot] = xk
    new.u[bi, slot] = _pad_rows(u, T, ss.x.dtype)
    new.x_glob[bi, slot] = _pad_rows(x_glob, Tg, ss.x.dtype)
    new.qfun[bi, slot] = qf
    new.n_pts[bi, slot] = steps
    new.lap_time[bi, slot] = steps
    return new._replace(n_laps=torch.clamp(ss.n_laps + 1, max=max_laps))


class ExtBuffer(NamedTuple):
    """Pending addPoint appends to the most recent lap (merged per lap)."""

    x: torch.Tensor   # (B, E, 6) appended states (s already shifted by +L)
    u: torch.Tensor   # (B, E, 2)
    q: torch.Tensor   # (B, E) cost-to-go continuation
    n: torch.Tensor   # (B,) int32 valid rows


def make_ext_buffer(batch: int, cap: int, dtype=torch.float32,
                    device="cuda") -> ExtBuffer:
    return ExtBuffer(
        x=torch.zeros((batch, cap, 6), dtype=dtype, device=device),
        u=torch.zeros((batch, cap, 2), dtype=dtype, device=device),
        q=torch.full((batch, cap), _PAD_QFUN, dtype=dtype, device=device),
        n=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def add_point(ss: SafeSet, ext: ExtBuffer, x, u, track_len) -> ExtBuffer:
    """Append the current point (x (B, 6), u (B, 2)) to the previous lap
    with s + L and decreasing cost-to-go; dropped when the buffer or the
    lap's capacity is full."""
    bi = _ar(ext.n)
    lap = (ss.n_laps - 1).long()
    n0 = ss.n_pts[bi, lap]
    E = ext.x.shape[1]
    e = ext.n
    ok = (e < E) & (n0 + e < ss.x.shape[2])
    e_c = torch.clamp(e, max=E - 1).long()
    x_app = x.to(ss.x.dtype).clone()
    x_app[:, 4] = x_app[:, 4] + track_len
    q_prev = torch.where(
        e > 0, ext.q[bi, torch.clamp(e - 1, min=0).long()],
        ss.qfun[bi, lap, torch.clamp(n0 - 1, min=0).long()])
    new = ExtBuffer(ext.x.clone(), ext.u.clone(), ext.q.clone(),
                    torch.where(ok, e + 1, e))
    new.x[bi, e_c] = _w(ok, x_app, ext.x[bi, e_c])
    new.u[bi, e_c] = _w(ok, u.to(ext.u.dtype), ext.u[bi, e_c])
    new.q[bi, e_c] = torch.where(ok, q_prev - 1.0, ext.q[bi, e_c])
    return new


def flush_ext(ss: SafeSet, ext: ExtBuffer):
    """Merge the pending appends into the most recent lap's stored rows;
    returns (safe set, empty buffer)."""
    B, E = ext.x.shape[:2]
    cap = ss.x.shape[2]
    bi = _ar(ext.n)[:, None]
    lap = torch.clamp(ss.n_laps - 1, min=0).long()
    n0 = ss.n_pts[bi[:, 0], lap]
    e = ext.n
    start = torch.clamp(n0, 0, cap - E)
    off = n0 - start
    i = torch.arange(E, device=e.device)
    j = i[None] - off[:, None]
    use = (j >= 0) & (j < e[:, None])
    j_c = torch.clamp(j, 0, E - 1).long()
    rows = (start[:, None] + i[None]).long()
    lapb = lap[:, None]

    def blend(big, ext_rows):
        out = big.clone()
        blk = big[bi, lapb, rows]
        out[bi, lapb, rows] = _w(use, ext_rows[bi, j_c], blk)
        return out

    n_pts = ss.n_pts.clone()
    n_pts[bi[:, 0], lap] = n_pts[bi[:, 0], lap] + e
    ss2 = ss._replace(x=blend(ss.x, ext.x), u=blend(ss.u, ext.u),
                      qfun=blend(ss.qfun, ext.q), n_pts=n_pts)
    return ss2, make_ext_buffer(B, E, dtype=ext.x.dtype, device=ext.x.device)


def _select_lap_points(ss: SafeSet, ext: ExtBuffer, lap: torch.Tensor,
                       recent: torch.Tensor, zt: torch.Tensor, P: int):
    """L1-nearest window of ``P`` points in each selected lap (B, S laps):
    centered on the nearest point when it fits (m - P//2 >= 1), else
    forward from it; indices clamped to the lap's valid rows. Returns
    (pts (B, S, P, 6), u_pts (B, S, P, 2), q_pts (B, S, P))."""
    B, S = lap.shape
    cap = ss.x.shape[2]
    E = ext.x.shape[1]
    bi = _ar(lap)[:, None]
    xs = ss.x[bi, lap]                                   # (B,S,cap,6)
    n = ss.n_pts[bi, lap]                                # (B,S)
    e_n = torch.where(recent, ext.n[:, None], torch.zeros_like(n))
    inf = torch.tensor(float("inf"), dtype=xs.dtype, device=xs.device)
    d_st = (xs - zt[:, None, None, :]).abs().sum(-1)
    d_st = torch.where(torch.arange(cap, device=n.device) < n[..., None],
                       d_st, inf)
    d_ex = (ext.x - zt[:, None, :]).abs().sum(-1)[:, None, :]
    d_ex = torch.where(torch.arange(E, device=n.device) < e_n[..., None],
                       d_ex, inf)
    m_phys = torch.cat([d_st, d_ex], -1).argmin(-1)
    m = torch.where(m_phys < cap, m_phys, m_phys - cap + n)
    n_eff = n + e_n
    half = P // 2
    start = torch.where(m - half >= 1, m - half, m)
    hi = torch.clamp(n_eff - 1, min=0)[..., None].long()
    idx = torch.minimum(torch.clamp(
        start[..., None] + torch.arange(P, device=n.device), min=0), hi)
    in_st = idx < n[..., None]
    st_i = torch.clamp(idx, 0, cap - 1)
    ex_i = torch.clamp(idx - n[..., None], 0, E - 1)
    b3, l3 = bi[..., None], lap[..., None]
    pts = torch.where(in_st[..., None], ss.x[b3, l3, st_i], ext.x[b3, ex_i])
    u_pts = torch.where(in_st[..., None], ss.u[b3, l3, st_i], ext.u[b3, ex_i])
    q_pts = torch.where(in_st, ss.qfun[b3, l3, st_i], ext.q[b3, ex_i])
    return pts, u_pts, q_pts


def select_terminal_set(ss: SafeSet, ext: ExtBuffer, zt, x_pred, time_step,
                        cfg: LMPCConfig, track_len):
    """Terminal-set data for one solve: (ss_pts (B, 6, K), succ_x (B, 6, K),
    succ_u (B, 2, K), qfun_sel (B, K))."""
    P = cfg.points_per_lap
    B = zt.shape[0]
    order = torch.argsort(ss.lap_time, dim=-1, stable=True)[:, :cfg.num_ss_it]
    recent = order == (ss.n_laps - 1)[:, None]
    pts, u_pts, q_pts = _select_lap_points(ss, ext, order, recent, zt, P)

    over = x_pred[..., 4] > track_len
    crossed = over.any(-1)
    pred_curr = cfg.N - over.sum(-1)
    bi = _ar(order)[:, None]
    corr = torch.where(
        recent, (time_step + pred_curr).to(q_pts.dtype)[:, None],
        ss.qfun[bi, order, 0])
    corr = torch.where(crossed[:, None], corr, torch.zeros_like(corr))
    q_pts = q_pts + corr[..., None]

    K = cfg.num_ss_points
    ss_pts = pts[:, :, :-1].reshape(B, K, 6).transpose(1, 2)
    succ_x = pts[:, :, 1:].reshape(B, K, 6).transpose(1, 2)
    succ_u = u_pts[:, :, 1:].reshape(B, K, 2).transpose(1, 2)
    qfun_sel = q_pts[:, :, :-1].reshape(B, K)
    return ss_pts, succ_x, succ_u, qfun_sel


class LMPCState(NamedTuple):
    ss: SafeSet
    ext: ExtBuffer
    store: sysid.LapStore
    u_old: torch.Tensor      # (B, 2)
    x_lin: torch.Tensor      # (B, N+1, 6)
    u_lin: torch.Tensor      # (B, N, 2)
    x_pred: torch.Tensor     # (B, N+1, 6)
    u_pred: torch.Tensor     # (B, N, 2)
    lam: torch.Tensor        # (B, K)
    zt: torch.Tensor         # (B, 6)
    zt_u: torch.Tensor       # (B, 2)
    warm_x: torch.Tensor     # (B, nz)
    warm_y: torch.Tensor     # (B, m)
    fac: qp_mod.FactorCache
    time_step: torch.Tensor  # (B,) int32, reset each lap
    rejects: torch.Tensor    # (B,) int32 consecutive rejected solves
    feasible: torch.Tensor   # (B,) bool
    pri_res: torch.Tensor    # (B,)
    dua_res: torch.Tensor    # (B,)
    iters: torch.Tensor      # (B,) int32


def init_lmpc_state(cfg: LMPCConfig, batch: int, dtype=torch.float32,
                    solver: Optional[SolverConfig] = None,
                    device="cuda") -> LMPCState:
    """Empty state; zt starts at [0, 0, 0, 0, 10, 0]. The cached KKT
    inverse is dropped when the solver's structured build never reads it."""
    dims = ocp.FTOCPDims(N=cfg.N, K=cfg.num_ss_points)
    with_kinv = solver is None or not solver.kkt_structured
    kw = dict(dtype=dtype, device=device)
    zi = torch.zeros((batch,), dtype=torch.int32, device=device)
    return LMPCState(
        ss=make_safe_set(batch, cfg.max_laps, cfg.max_pts, dtype=dtype,
                         glob_pts=cfg.glob_cap, device=device),
        ext=make_ext_buffer(batch, cfg.ext_cap, dtype=dtype, device=device),
        store=sysid.make_lap_store(batch, cfg.model_laps, cfg.model_pts,
                                   dtype=dtype, device=device),
        u_old=torch.zeros((batch, 2), **kw),
        x_lin=torch.zeros((batch, cfg.N + 1, 6), **kw),
        u_lin=torch.zeros((batch, cfg.N, 2), **kw),
        x_pred=torch.zeros((batch, cfg.N + 1, 6), **kw),
        u_pred=torch.zeros((batch, cfg.N, 2), **kw),
        lam=torch.zeros((batch, cfg.num_ss_points), **kw),
        zt=torch.tensor([0.0, 0.0, 0.0, 0.0, 10.0, 0.0], **kw).repeat(batch, 1),
        zt_u=torch.zeros((batch, 2), **kw),
        warm_x=torch.zeros((batch, dims.nz), **kw),
        warm_y=torch.zeros((batch, dims.mi + dims.me), **kw),
        fac=qp_mod.init_factor_cache(batch, dims.nz, dims.mi + dims.me,
                                     dtype=dtype, device=device,
                                     with_kinv=with_kinv),
        time_step=zi, rejects=zi.clone(),
        feasible=torch.zeros((batch,), dtype=torch.bool, device=device),
        pri_res=torch.zeros((batch,), **kw),
        dua_res=torch.zeros((batch,), **kw),
        iters=zi.clone(),
    )


def lmpc_add_trajectory(state: LMPCState, cfg: LMPCConfig, x, u, x_glob,
                        steps, track_len, add_to_model: bool = True
                        ) -> LMPCState:
    """Per-lap bookkeeping: flush the pending appends, store the lap in the
    safe set (and the sys-ID store), seed the linearization trajectory on
    the first lap (rows 1..N+1), reset the step counter."""
    ss0, ext = flush_ext(state.ss, state.ext)
    first = ss0.n_laps == 0
    ss = add_trajectory(ss0, x, u, x_glob, steps, track_len)
    store = (sysid.add_lap(state.store, x, u, steps) if add_to_model
             else state.store)
    N = cfg.N
    dt = state.x_lin.dtype
    pad_x = _pad_rows(x, N + 2, dt)
    pad_u = _pad_rows(u, N + 1, dt)
    return state._replace(
        ss=ss, ext=ext, store=store,
        x_lin=_w(first, pad_x[:, 1:], state.x_lin),
        u_lin=_w(first, pad_u[:, 1:], state.u_lin),
        time_step=torch.zeros_like(state.time_step),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class LMPCController:
    """A built controller: ``step(state, x0, noise=None) -> (state, u)``
    plus the pieces of one step, which the smoke script reads."""

    cfg: LMPCConfig
    solver_cfg: SolverConfig
    trk: track_mod.Track
    table: track_mod.TrackTable
    dims: ocp.FTOCPDims
    tmpl: ocp.FTOCPTemplates
    dt_ctrl: float
    dtype: torch.dtype

    @property
    def use_kernel_sysid(self) -> bool:
        """Engagement rule of the sys-ID kernel, the reference's: float32
        state, ``model_pts % 128 == 0``, and a CUDA track, or
        ``sysid_interpret`` (plain version on the CPU). Elsewhere the step
        takes the plain sys-ID, as the reference takes its XLA path."""
        return (self.cfg.use_pallas_sysid and self.dtype == torch.float32
                and self.cfg.model_pts % 128 == 0
                and (self.trk.s0.is_cuda or self.cfg.sysid_interpret))

    def sysid(self, store, x_lin, u_lin):
        if self.use_kernel_sysid:
            return cuda_sysid.local_linearization_horizon(
                store, self.trk, x_lin.contiguous(), u_lin.contiguous(),
                self.cfg, self.dt_ctrl, table=self.table)
        return sysid.local_linearization_horizon(
            store, self.trk, x_lin, u_lin, self.cfg, self.dt_ctrl)

    def build_qp(self, state: LMPCState, x0: torch.Tensor):
        """Steps 1-3 of a control step: s-wrap, terminal set, sys-ID, FTOCP.
        Returns (qp, zt, succ_x, succ_u)."""
        N, L = self.cfg.N, self.trk.total_len
        x0 = x0.to(self.dtype)
        wrap = state.zt[:, 4] - x0[:, 4] > L / 2
        zt = state.zt.clone()
        zt[:, 4] = torch.where(wrap, torch.clamp(state.zt[:, 4] - L, min=0.0),
                               state.zt[:, 4])
        x_lin = state.x_lin.clone()
        x_lin[:, N, 4] = x_lin[:, N, 4] + torch.where(
            wrap, -L, torch.zeros_like(L))
        ss_pts, succ_x, succ_u, qfun_sel = select_terminal_set(
            state.ss, state.ext, zt, state.x_pred, state.time_step, self.cfg,
            L)
        A, B, C = self.sysid(state.store, x_lin[:, :N], state.u_lin)
        qp = ocp.assemble_qp(self.dims, self.tmpl, ocp.StageDynamics(A, B, C),
                             x0, state.u_old, self.cfg.dR, ss_points=ss_pts,
                             qfun_sel=qfun_sel)
        return qp, zt, succ_x, succ_u

    def step(self, state: LMPCState, x0: torch.Tensor, noise=None):
        """One batched LMPC control step (``noise`` is unused: the
        controller is deterministic). Returns (state, u (B, 2))."""
        cfg, dims = self.cfg, self.dims
        dtype = self.dtype
        x0c = x0.to(dtype)
        qp, zt, succ_x, succ_u = self.build_qp(state, x0c)
        sol = qp_mod.solve(qp, self.solver_cfg,
                           warm=(state.warm_x, state.warm_y), fac=state.fac,
                           structure=kkt_band.band_structure(dims.N, dims.K))
        x_pred, u_pred, _, lam, _ = ocp.unpack(dims, sol.x)
        ok = (torch.isfinite(sol.x).all(-1)
              & (sol.pri_res < self.solver_cfg.accept_pri_res))
        x_pred = _w(ok, x_pred, state.x_pred)
        u_pred = _w(ok, u_pred, state.u_old[:, None, :].expand_as(u_pred))
        lam = _w(ok, lam, state.lam)
        wx_s, wy_s = ocp.shift_warm(dims, sol.x, sol.y)
        warm_x = _w(ok, wx_s, torch.zeros_like(sol.x))
        warm_y = _w(ok, wy_s, torch.zeros_like(sol.y))
        zt_new = _w(ok, (succ_x @ lam[..., None])[..., 0], zt)
        zt_u_new = _w(ok, (succ_u @ lam[..., None])[..., 0], state.zt_u)

        rejects = torch.where(ok, torch.zeros_like(state.rejects),
                              state.rejects + 1)
        u_pid = torch.stack([
            -0.6 * x0c[:, 5] - 0.9 * x0c[:, 3],
            torch.clamp(1.5 * (cfg.fallback_vt - x0c[:, 0]), min=-1.0)], -1)
        use_pid = rejects >= cfg.fallback_after
        bounds = torch.tensor([cfg.delta_max, cfg.a_max], dtype=dtype,
                              device=x0c.device)
        u_apply = torch.clamp(_w(use_pid, u_pid, u_pred[:, 0]), -bounds,
                              bounds)
        zt_new = _w(use_pid, x0c, zt_new)
        zt_u_new = _w(use_pid, u_apply, zt_u_new)
        x_lin_new = torch.cat([x_pred[:, 1:], zt_new[:, None]], 1)
        u_lin_new = torch.cat([u_pred[:, 1:], zt_u_new[:, None]], 1)
        x_lin_new = _w(use_pid, x0c[:, None].expand_as(x_lin_new), x_lin_new)
        u_lin_new = _w(use_pid, u_apply[:, None].expand_as(u_lin_new),
                       u_lin_new)
        ext = add_point(state.ss, state.ext, x0c, u_apply, self.trk.total_len)
        new = LMPCState(
            ss=state.ss, ext=ext, store=state.store, u_old=u_apply,
            x_lin=x_lin_new, u_lin=u_lin_new, x_pred=x_pred, u_pred=u_pred,
            lam=lam, zt=zt_new, zt_u=zt_u_new, warm_x=warm_x, warm_y=warm_y,
            fac=sol.fac, time_step=state.time_step + 1, rejects=rejects,
            feasible=sol.solved & ok, pri_res=sol.pri_res.to(dtype),
            dua_res=sol.dua_res.to(dtype), iters=sol.iters)
        return new, u_apply.to(x0.dtype)


def make_lmpc(cfg: LMPCConfig, trk: track_mod.Track,
              solver_cfg: SolverConfig = SolverConfig(), dt_ctrl: float = 0.1,
              dtype=torch.float32) -> LMPCController:
    """Build the LMPC controller on the track's device; call ``.step``."""
    dims, tmpl = ocp.make_templates(
        N=cfg.N, Q=cfg.Q, R=cfg.R, dR=cfg.dR, Qf=(0.0,) * 6,
        q_slack=cfg.q_slack, x_ref=(0.0,) * 6, ey_max=cfg.ey_max,
        delta_max=cfg.delta_max, a_max=cfg.a_max, K=cfg.num_ss_points,
        q_terminal_slack=cfg.q_terminal_slack, dtype=dtype,
        device=trk.s0.device)
    return LMPCController(cfg=cfg, solver_cfg=solver_cfg, trk=trk,
                          table=track_mod.track_table(trk), dims=dims,
                          tmpl=tmpl, dt_ctrl=dt_ctrl, dtype=dtype)
