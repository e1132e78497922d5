"""The FTOCPs of the LTI / LTV-MPC stages, with the controller state that
carries their warm start and factor cache.

After ``run_experiment`` has run a stage, :func:`stage_ftocps` rebuilds
that stage's controller from the run's own data (the LTI fit, or the PID
lap as the LTV store), drives it ``steps`` more steps from the stage's
final plant state (plant noise off) so that its warm start and factor
cache are those of a running stage, and returns the FTOCP of the next
step. ``chip_smoke.py`` holds kernel B4 against its plain version on
these inputs (the LTI stage's warm cache, the LTV stage's cold build) and
checks the structured KKT inverse on the LTV stage's K.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

from racinglmpc_tpu_torch.controllers import mpc as mpc_mod
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.track import Track
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.config import VehicleParams


class StageFTOCPs(NamedTuple):
    ctrl: mpc_mod.MPCController
    state: mpc_mod.MPCState
    qp: qp_mod.QPData
    warm: tuple                  # (x, y) warm start of the next solve
    fac: qp_mod.FactorCache


def stage_controller(res: exp.ExperimentResult, cfg: exp.ExperimentConfig,
                     stage: str, trk: Track):
    """(controller, initial state) of the ``"lti"`` or ``"ltv"`` stage of
    ``res``, built as ``run_experiment`` builds it."""
    if stage == "lti":
        mpc_cfg = dataclasses.replace(cfg.mpc, N=cfg.N, vt=cfg.vt)
        return mpc_mod.make_lti_mpc(mpc_cfg, res.A_lti, res.B_lti,
                                    cfg.solver, dtype=res.pid.x.dtype)
    mpc_cfg = dataclasses.replace(cfg.mpc, N=cfg.N, vt=cfg.vt,
                                  time_varying=True)
    x = res.pid.x
    store = sysid.add_lap(
        sysid.make_lap_store(x.shape[0], 1, cfg.lmpc.model_pts,
                             dtype=x.dtype, device=x.device),
        x, res.pid.u, res.pid.steps)
    return mpc_mod.make_ltv_mpc(mpc_cfg, store, trk, cfg.lmpc, cfg.solver,
                                cfg.sim.dt, dtype=x.dtype)


def stage_ftocps(res: exp.ExperimentResult, cfg: exp.ExperimentConfig,
                 stage: str, trk: Track, steps: int = 10) -> StageFTOCPs:
    ctrl, state = stage_controller(res, cfg, stage, trk)
    sim = dataclasses.replace(cfg.sim, noise=False)
    lap = loop.run_lap(ctrl, state, getattr(res, stage).plant_final,
                       trk=trk, vp=VehicleParams(), sim_cfg=sim,
                       max_steps=steps, multi_lap=True)
    st = lap.ctrl_state
    return StageFTOCPs(ctrl, st, ctrl.build_qp(st, lap.plant_final.x),
                       (st.warm_x, st.warm_y), st.fac)
