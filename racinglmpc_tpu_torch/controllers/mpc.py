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
  trajectory: by the sys-ID kernel B2 (``ops/cuda_sysid.py``) for a
  float32 store on CUDA, else (on the CPU, in float64) by the plain
  ``models/sysid.local_linearization_horizon``; the QP is reassembled, and
  after the solve the trajectory is rolled forward:
  x_lin <- [x_pred[1:], x_pred[-1]], u_lin <- [u_pred[1:], u_pred[-1]].

A solve is accepted when it is finite and its primal residual is below
``accept_pri_res``; otherwise the prediction and the input are held and
the warm start is zeroed. The applied input is clipped to the input box.

The state carries the last step's solve, as device tensors (no host
read): the ADMM iterations, whether the solve was rejected, and the
fused-prologue kernel B4's Newton-Schulz iterations and warm start per
lane (0 and False where B4 did not run). The JAX package's state has no
such fields (:data:`SOLVE_INFO`). The step runs under the spans the LMPC
step uses (``runtime/tracing.py``): ``ctrl.step`` > ``ctrl.sysid`` (LTV),
``ctrl.assemble``, ``qp.solve``, ``ctrl.accept``.

On CUDA in float32 the step is replayed as CUDA graphs
(``runtime/step_graph.py``), one a Ruiz sweep count, the span
``ctrl.step`` > ``ctrl.graph``: its one host wait is the read of the
count's flag, before the replay. The graph returns fresh tensors and
gives the eager step's bits.
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
from racinglmpc_tpu_torch.runtime import step_graph, tracing
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
    iters: torch.Tensor     # (B,) int32 ADMM iterations of the last solve
    rejected: torch.Tensor  # (B,) bool: last solve rejected, input held
    ns_iters: torch.Tensor  # (B,) int32 B4's Newton-Schulz iterations
    warm: torch.Tensor      # (B,) bool: B4 took the warm inverse


# the fields of the port's state that the JAX package's lacks
SOLVE_INFO = ("iters", "rejected", "ns_iters", "warm")


def solve_info(batch: int, device="cuda") -> dict:
    """:data:`SOLVE_INFO` of a state no solve has touched."""
    i32 = dict(dtype=torch.int32, device=device)
    no = dict(dtype=torch.bool, device=device)
    return dict(iters=torch.zeros((batch,), **i32),
                rejected=torch.zeros((batch,), **no),
                ns_iters=torch.zeros((batch,), **i32),
                warm=torch.zeros((batch,), **no))


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
        feasible=torch.zeros((batch,), dtype=torch.bool, device=device),
        **solve_info(batch, device))


def _templates(cfg: MPCConfig, dtype, device):
    return ocp.make_templates(
        N=cfg.N, Q=cfg.Q, R=cfg.R, dR=cfg.dR, Qf=cfg.Qf, q_slack=cfg.q_slack,
        x_ref=cfg.x_ref, ey_max=cfg.ey_max, delta_max=cfg.delta_max,
        a_max=cfg.a_max, dtype=dtype, device=device)


def _clip_u(u: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """The input clipped to ``box`` (the templates' ``u_box``)."""
    return torch.clamp(u, -box, box)


@dataclasses.dataclass(frozen=True, eq=False)
class MPCController:
    """A built LTI (``store`` None, fixed ``dyn``) or LTV controller:
    ``ctrl(state, x0, noise=None) -> (state, u)``, replayed as a CUDA graph
    where :meth:`graphed` holds, else :meth:`step`, the same step run
    eagerly; :meth:`build_qp` is the step's FTOCP (the smoke script reads
    it). ``table``: the LTV track's segment table on the host, the sys-ID
    kernel's launch arguments."""

    cfg: MPCConfig
    solver_cfg: SolverConfig
    dims: ocp.FTOCPDims
    tmpl: ocp.FTOCPTemplates
    dyn: Optional[ocp.StageDynamics] = None
    store: Optional[sysid.LapStore] = None
    trk: Optional[track_mod.Track] = None
    lmpc_cfg: Optional[LMPCConfig] = None
    dt_ctrl: float = 0.1
    table: Optional[track_mod.TrackTable] = None
    graph: step_graph.StepGraph = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "graph",
                           step_graph.StepGraph(self._graph_step))

    @property
    def structure(self):
        """The band structure handed to the solver: only for a
        time-varying configuration (so LTI never takes the structured
        build)."""
        return (kkt_band.band_structure(self.dims.N, self.dims.K)
                if self.cfg.time_varying else None)

    @property
    def use_kernel_sysid(self) -> bool:
        """The LTV step's rule for the sys-ID kernel B2: a float32 store on
        CUDA. On the CPU and in float64 the step takes the plain sys-ID;
        a store on the card that B2 cannot take raises, never falls back."""
        return (self.store is not None and self.store.x.is_cuda
                and self.store.x.dtype == torch.float32)

    @tracing.traced("ctrl.sysid")
    def sysid(self, state: MPCState) -> ocp.StageDynamics:
        """The LTV step's local regression at the linearization
        trajectory: one launch of B2 by :attr:`use_kernel_sysid`, else the
        plain version."""
        x_lin, u_lin = state.x_lin[:, :self.cfg.N], state.u_lin
        if self.use_kernel_sysid:
            return ocp.StageDynamics(*cuda_sysid.local_linearization_horizon(
                self.store, self.trk, x_lin.contiguous(), u_lin.contiguous(),
                self.lmpc_cfg, self.dt_ctrl, table=self.table))
        return ocp.StageDynamics(*sysid.local_linearization_horizon(
            self.store, self.trk, x_lin, u_lin, self.lmpc_cfg, self.dt_ctrl))

    def build_qp(self, state: MPCState, x0: torch.Tensor) -> qp_mod.QPData:
        dyn = self.dyn if self.store is None else self.sysid(state)
        return ocp.assemble_qp(self.dims, self.tmpl, dyn, x0, state.u_old,
                               self.tmpl.dR)

    def graphed(self, state: MPCState) -> bool:
        """Whether the step replays as a CUDA graph: a float32 state on
        CUDA whose solve takes a kernel path with no host read (B1 or B4 at
        fixed rho, no polish, no structured KKT build). Elsewhere it runs
        eagerly."""
        s = self.solver_cfg
        return (state.u_old.is_cuda and state.u_old.dtype == torch.float32
                and s.use_pallas and not s.adaptive_rho and not s.polish
                and not (s.kkt_structured and self.structure is not None))

    @tracing.traced("ctrl.step")
    def __call__(self, state: MPCState, x0: torch.Tensor, noise=None):
        if not self.graphed(state):
            return self.step(state, x0)
        return self.graph((state, x0), self._graph_key)

    def _graph_key(self, inputs) -> tuple:
        # the Ruiz count (the step's one wait, on a flag of the cache it is
        # handed) and the tracer's arming (its device counters' pointers)
        return (qp_mod.SweepCount(self.solver_cfg, inputs[0].fac).total,
                tracing.armed())

    def _graph_step(self, inputs, key):
        return self.step(*inputs, sweeps=qp_mod.SweepCount.of(key[0]))

    def step(self, state: MPCState, x0: torch.Tensor,
             sweeps: Optional[qp_mod.SweepCount] = None):
        """The step, eagerly. ``sweeps``: its Ruiz count (by default read
        from ``state.fac``, made before the sys-ID is launched and waited
        for at the sweeps)."""
        if sweeps is None:
            sweeps = qp_mod.SweepCount(self.solver_cfg, state.fac)
        sol = qp_mod.solve(self.build_qp(state, x0), self.solver_cfg,
                           warm=(state.warm_x, state.warm_y), fac=state.fac,
                           structure=self.structure, sweeps=sweeps)
        return self.accept(state, x0, sol)

    @tracing.traced("ctrl.accept")
    def accept(self, state: MPCState, x0: torch.Tensor,
               sol: qp_mod.QPSolution):
        """Accept or hold the solve, clip the input, shift the warm start
        and (LTV) roll the linearization trajectory. Returns (state, u)."""
        dims = self.dims
        x_pred, u_pred, _, _, _ = ocp.unpack(dims, sol.x)
        ok = (torch.isfinite(sol.x).all(-1)
              & (sol.pri_res < self.solver_cfg.accept_pri_res))
        x_pred = _w(ok, x_pred, state.x_pred)
        u_pred = _w(ok, u_pred, state.u_old[:, None, :].expand_as(u_pred))
        wx_s, wy_s = ocp.shift_warm(dims, sol.x, sol.y)
        u = _clip_u(u_pred[:, 0], self.tmpl.u_box)
        new = state._replace(
            u_old=u, x_pred=x_pred, u_pred=u_pred,
            warm_x=_w(ok, wx_s, torch.zeros_like(sol.x)),
            warm_y=_w(ok, wy_s, torch.zeros_like(sol.y)), fac=sol.fac,
            feasible=sol.solved & ok, iters=sol.iters, rejected=~ok,
            # without B4 the zeros init_state made are carried
            ns_iters=state.ns_iters if sol.ns_iters is None else sol.ns_iters,
            warm=state.warm if sol.warm is None else sol.warm)
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
    ...); ``lmpc_cfg`` carries the regression hyper-parameters (B2 or the
    plain sys-ID by :attr:`MPCController.use_kernel_sysid`, whatever its
    ``use_pallas_sysid``: that switch is the LMPC step's). Returns
    ``(controller, init_state)`` with the linearization trajectory started
    from the first N+1 rows of each scenario's stored lap in slot 0."""
    device = store.x.device
    dims, tmpl = _templates(cfg, dtype, device)
    N, Bsz = cfg.N, store.x.shape[0]
    ctrl = MPCController(cfg=cfg, solver_cfg=solver_cfg, dims=dims,
                         tmpl=tmpl, store=store, trk=trk, lmpc_cfg=lmpc_cfg,
                         dt_ctrl=dt_ctrl, table=track_mod.track_table(trk))
    return ctrl, init_state(
        N, Bsz, store.x[:, 0, :N + 1], store.u[:, 0, :N], dtype=dtype,
        nz=dims.nz, m=dims.mi + dims.me, solver=solver_cfg,
        time_varying=True, device=device)
