"""LTI- and LTV-MPC as batched controller step functions.

Port of ``racinglmpc_tpu/controllers/mpc.py`` with a leading scenario axis
B on every tensor (the reference vmaps per-scenario functions):

- **LTI**: a fixed (A, B) per scenario from the one-shot ridge fit
  (``models/sysid.lti_regression``); the stage dynamics are built once.
  No band structure is handed to the solver, so the LTI stage never takes
  the structured KKT build: its matrices are constant and the warm
  Newton-Schulz refresh is the cheap path (the one regime where the fused
  kernel B4 contracts its warm start).
- **LTV**: every step the model is re-identified at the linearization
  trajectory (``models/sysid.local_linearization_horizon``), the QP is
  reassembled, and after the solve the trajectory is rolled forward:
  x_lin <- [x_pred[1:], x_pred[-1]], u_lin <- [u_pred[1:], u_pred[-1]].

A solve is accepted when it is finite and its primal residual is below
``accept_pri_res``; otherwise the prediction and the input are held and
the warm start is zeroed. The applied input is clipped to the input box.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from racinglmpc_tpu_torch.controllers import ocp
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models import track as track_mod
from racinglmpc_tpu_torch.ops import kkt_band
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.utils.batched import lane_where as _w
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, MPCConfig,
                                               SolverConfig)


class MPCState(NamedTuple):
    u_old: torch.Tensor    # (B, 2) previously applied input
    x_lin: torch.Tensor    # (B, N+1, 6) linearization trajectory (LTV)
    u_lin: torch.Tensor    # (B, N, 2)
    x_pred: torch.Tensor   # (B, N+1, 6) last accepted prediction
    u_pred: torch.Tensor   # (B, N, 2)
    warm_x: torch.Tensor   # (B, nz) previous primal solution (warm start)
    warm_y: torch.Tensor   # (B, m)
    fac: qp_mod.FactorCache
    feasible: torch.Tensor  # (B,) bool: last solve accepted and solved


def init_state(N: int, batch: int, x_lin=None, u_lin=None,
               dtype=torch.float32, nz: int = 0, m: int = 0,
               solver: Optional[SolverConfig] = None,
               time_varying: bool = False, device="cuda") -> MPCState:
    """Fresh state; LTV passes the warm-start trajectory (B, N+1, 6),
    (B, N, 2). The cached KKT inverse is dropped only for an LTV
    controller whose solver takes the structured build (which never reads
    it); LTI always keeps it."""
    with_kinv = (not time_varying) or solver is None \
        or not solver.kkt_structured
    kw = dict(dtype=dtype, device=device)
    x_lin = (torch.zeros((batch, N + 1, 6), **kw) if x_lin is None
             else x_lin.to(**kw).clone())
    u_lin = (torch.zeros((batch, N, 2), **kw) if u_lin is None
             else u_lin.to(**kw).clone())
    return MPCState(
        u_old=torch.zeros((batch, 2), **kw), x_lin=x_lin, u_lin=u_lin,
        x_pred=torch.zeros((batch, N + 1, 6), **kw),
        u_pred=torch.zeros((batch, N, 2), **kw),
        warm_x=torch.zeros((batch, nz), **kw),
        warm_y=torch.zeros((batch, m), **kw),
        fac=qp_mod.init_factor_cache(batch, nz, m, dtype=dtype, device=device,
                                     with_kinv=with_kinv),
        feasible=torch.zeros((batch,), dtype=torch.bool, device=device))


def _templates(cfg: MPCConfig, dtype, device):
    return ocp.make_templates(
        N=cfg.N, Q=cfg.Q, R=cfg.R, dR=cfg.dR, Qf=cfg.Qf, q_slack=cfg.q_slack,
        x_ref=cfg.x_ref, ey_max=cfg.ey_max, delta_max=cfg.delta_max,
        a_max=cfg.a_max, dtype=dtype, device=device)


def _clip_u(u: torch.Tensor, cfg: MPCConfig) -> torch.Tensor:
    bounds = torch.tensor([cfg.delta_max, cfg.a_max], dtype=u.dtype,
                          device=u.device)
    return torch.clamp(u, -bounds, bounds)


@dataclasses.dataclass(frozen=True, eq=False)
class MPCController:
    """A built LTI (``store`` None, fixed ``dyn``) or LTV controller:
    ``ctrl(state, x0, noise=None) -> (state, u)``; :meth:`build_qp` is the
    step's FTOCP (the smoke script reads it)."""

    cfg: MPCConfig
    solver_cfg: SolverConfig
    dims: ocp.FTOCPDims
    tmpl: ocp.FTOCPTemplates
    dyn: Optional[ocp.StageDynamics] = None
    store: Optional[sysid.LapStore] = None
    trk: Optional[track_mod.Track] = None
    lmpc_cfg: Optional[LMPCConfig] = None
    dt_ctrl: float = 0.1

    @property
    def structure(self):
        """The band structure handed to the solver: only for a
        time-varying configuration (so LTI never takes the structured
        build)."""
        return (kkt_band.band_structure(self.dims.N, self.dims.K)
                if self.cfg.time_varying else None)

    def build_qp(self, state: MPCState, x0: torch.Tensor) -> qp_mod.QPData:
        dyn = self.dyn
        if self.store is not None:
            N = self.cfg.N
            dyn = ocp.StageDynamics(*sysid.local_linearization_horizon(
                self.store, self.trk, state.x_lin[:, :N], state.u_lin,
                self.lmpc_cfg, self.dt_ctrl))
        return ocp.assemble_qp(self.dims, self.tmpl, dyn, x0, state.u_old,
                               self.cfg.dR)

    def __call__(self, state: MPCState, x0: torch.Tensor, noise=None):
        dims, scfg = self.dims, self.solver_cfg
        sol = qp_mod.solve(self.build_qp(state, x0), scfg,
                           warm=(state.warm_x, state.warm_y), fac=state.fac,
                           structure=self.structure)
        x_pred, u_pred, _, _, _ = ocp.unpack(dims, sol.x)
        ok = (torch.isfinite(sol.x).all(-1)
              & (sol.pri_res < scfg.accept_pri_res))
        x_pred = _w(ok, x_pred, state.x_pred)
        u_pred = _w(ok, u_pred, state.u_old[:, None, :].expand_as(u_pred))
        wx_s, wy_s = ocp.shift_warm(dims, sol.x, sol.y)
        u = _clip_u(u_pred[:, 0], self.cfg)
        new = state._replace(
            u_old=u, x_pred=x_pred, u_pred=u_pred,
            warm_x=_w(ok, wx_s, torch.zeros_like(sol.x)),
            warm_y=_w(ok, wy_s, torch.zeros_like(sol.y)), fac=sol.fac,
            feasible=sol.solved & ok)
        if self.store is not None:    # roll the linearization trajectory
            new = new._replace(
                x_lin=torch.cat([x_pred[:, 1:], x_pred[:, -1:]], 1),
                u_lin=torch.cat([u_pred[:, 1:], u_pred[:, -1:]], 1))
        return new, u.to(x0.dtype)


def make_lti_mpc(cfg: MPCConfig, A: torch.Tensor, B: torch.Tensor,
                 solver_cfg: SolverConfig = SolverConfig(),
                 dtype=torch.float32):
    """LTI-MPC with a fixed model per scenario: A (B, 6, 6), B (B, 6, 2).
    Returns ``(controller, init_state)``."""
    device = A.device
    dims, tmpl = _templates(cfg, dtype, device)
    N, Bsz = cfg.N, A.shape[0]
    dyn = ocp.StageDynamics(
        A=A.to(dtype)[:, None].expand(Bsz, N, 6, 6),
        B=B.to(dtype)[:, None].expand(Bsz, N, 6, 2),
        C=torch.zeros((Bsz, N, 6), dtype=dtype, device=device))
    ctrl = MPCController(cfg=cfg, solver_cfg=solver_cfg, dims=dims,
                         tmpl=tmpl, dyn=dyn)
    return ctrl, init_state(N, Bsz, dtype=dtype, nz=dims.nz,
                            m=dims.mi + dims.me, device=device)


def make_ltv_mpc(cfg: MPCConfig, store: sysid.LapStore,
                 trk: track_mod.Track, lmpc_cfg: LMPCConfig = LMPCConfig(),
                 solver_cfg: SolverConfig = SolverConfig(),
                 dt_ctrl: float = 0.1, dtype=torch.float32):
    """LTV-MPC with per-step local sys-ID over a fixed lap store (B, K, T,
    ...); ``lmpc_cfg`` carries the regression hyper-parameters. Returns
    ``(controller, init_state)`` with the linearization trajectory started
    from the first N+1 rows of each scenario's stored lap in slot 0."""
    device = store.x.device
    dims, tmpl = _templates(cfg, dtype, device)
    N, Bsz = cfg.N, store.x.shape[0]
    ctrl = MPCController(cfg=cfg, solver_cfg=solver_cfg, dims=dims,
                         tmpl=tmpl, store=store, trk=trk, lmpc_cfg=lmpc_cfg,
                         dt_ctrl=dt_ctrl)
    return ctrl, init_state(
        N, Bsz, store.x[:, 0, :N + 1], store.u[:, 0, :N], dtype=dtype,
        nz=dims.nz, m=dims.mi + dims.me, solver=solver_cfg,
        time_varying=True, device=device)
