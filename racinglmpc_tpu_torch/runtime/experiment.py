"""The racing experiment, scenario-batched: the PID and LMPC stages.

Port of ``racinglmpc_tpu/runtime/experiment.py`` for ``stages="pid,lmpc"``:

1. **PID** path following, ``stage_steps`` fixed steps (multi-lap);
2. **LMPC** for ``n_lmpc_laps`` laps, the safe set and the sys-ID store
   seeded with ``num_ss_it`` copies of the PID data; each lap runs in
   ``lap_chunk``-step chunks with an early exit on the host once every
   scenario has crossed the line. Lap steps come from the masks and lap
   times from Qfun (``qfun[lap, 0] * dt``).

Not ported yet: the LTI/LTV-MPC stages (ROADMAP item 11), the device mesh
(item 13) and checkpoints (item 12); asking for them raises.

Noise (PID exploration and plant noise, when the config turns it on) is
drawn from a ``torch.Generator`` seeded by ``seed``; it cannot reproduce
the reference's threefry streams.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.controllers.pid import make_pid_controller
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import Track, make_track, track_table
from racinglmpc_tpu_torch.runtime import loop as loop_mod
from racinglmpc_tpu_torch.utils.config import (
    LMPCConfig, SimConfig, SolverConfig, VehicleParams)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    N: int = 14
    vt: float = 0.8
    n_lmpc_laps: int = 40
    stage_steps: int = 1000
    lap_max_steps: int = 1000
    lap_chunk: int = 125
    pid_noise: bool = True
    sim: SimConfig = SimConfig()
    lmpc: LMPCConfig = LMPCConfig()
    solver: SolverConfig = SolverConfig()


class StageResult(NamedTuple):
    x: torch.Tensor        # (B, T, 6)
    u: torch.Tensor        # (B, T, 2)
    x_glob: torch.Tensor   # (B, T, 6)
    mask: torch.Tensor     # (B, T)
    steps: torch.Tensor    # (B,)
    plant_final: PlantState


class ExperimentResult(NamedTuple):
    pid: StageResult
    lmpc_laps: Optional[List[StageResult]]
    lap_steps: Optional[np.ndarray]   # (B, n_lmpc_laps)
    lap_times: Optional[np.ndarray]   # (B, n_lmpc_laps) [s]
    lmpc_state: Optional[lmpc_mod.LMPCState]


def initial_plant(batch: int, dtype=torch.float32, device="cuda") -> PlantState:
    """x = x_glob = [0.5, 0, 0, 0, 0, 0] for every scenario."""
    x0 = torch.tensor([0.5, 0, 0, 0, 0, 0], dtype=dtype,
                      device=device).repeat(batch, 1)
    return PlantState(x=x0, x_glob=x0.clone())


def run_lap_chunked(runner, ctrl_state, plant: PlantState, max_steps: int,
                    chunk: int, pad_to: int):
    """One lap in ``chunk``-step pieces with a host early exit.
    ``runner(ctrl_state, plant, done, step0) -> LapResult``. Returns
    (StageResult padded to ``pad_to`` steps, ctrl_state)."""
    B = plant.x.shape[0]
    done = torch.zeros((B,), dtype=torch.bool, device=plant.x.device)
    parts = []
    step0 = 0
    while step0 < max_steps:
        res = runner(ctrl_state, plant, done, step0)
        ctrl_state, plant, done = res.ctrl_state, res.plant_final, res.done
        parts.append(res)
        step0 += chunk
        if bool(done.all()):
            break

    def cat_pad(name):
        a = torch.cat([getattr(r, name) for r in parts], 1)
        if a.shape[1] < pad_to:
            pad = torch.zeros((B, pad_to - a.shape[1]) + a.shape[2:],
                              dtype=a.dtype, device=a.device)
            a = torch.cat([a, pad], 1)
        return a[:, :pad_to]

    mask = cat_pad("mask")
    return StageResult(x=cat_pad("x"), u=cat_pad("u"),
                       x_glob=cat_pad("x_glob"), mask=mask,
                       steps=mask.sum(1).to(torch.int32),
                       plant_final=plant), ctrl_state


def run_experiment(cfg: ExperimentConfig = ExperimentConfig(), *,
                   batch: int = 1, trk: Optional[Track] = None,
                   vp: Optional[VehicleParams] = None,
                   stages: str = "pid,lmpc", dtype=torch.float32,
                   device="cuda", seed: int = 0, mesh=None,
                   verbose: bool = False,
                   checkpoint_dir: Optional[str] = None) -> ExperimentResult:
    """Run the PID stage and (if asked) the LMPC laps for ``batch``
    scenarios on ``device``."""
    want = set(stages.split(","))
    missing = want - {"pid", "lmpc"}
    if missing:
        raise NotImplementedError(
            f"stages {sorted(missing)}: the LTI/LTV-MPC stages are ROADMAP "
            "item 11 of the PyTorch port")
    if mesh is not None:
        raise NotImplementedError("mesh: multi-GPU is ROADMAP item 13")
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoints are ROADMAP item 12")
    if trk is None:
        trk = make_track(dtype=dtype, device=device)
    if vp is None:
        vp = VehicleParams()
    table = track_table(trk)
    L = trk.total_len
    sim = cfg.sim
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    log = print if verbose else (lambda *a, **k: None)
    plant0 = initial_plant(batch, dtype=dtype, device=device)

    log("Starting PID")
    pid_step, pid0 = make_pid_controller(cfg.vt, noise=cfg.pid_noise)
    pid_res = loop_mod.run_lap(
        pid_step, pid0, plant0, trk=trk, vp=vp, sim_cfg=sim,
        max_steps=cfg.stage_steps, multi_lap=True, table=table,
        noise=loop_mod.gaussian_noise(batch, 2, sim, gen, dtype, device,
                                      ctrl_noise=cfg.pid_noise))
    pid_sr = StageResult(x=pid_res.x, u=pid_res.u, x_glob=pid_res.x_glob,
                         mask=pid_res.mask, steps=pid_res.steps,
                         plant_final=pid_res.plant_final)
    if "lmpc" not in want:
        return ExperimentResult(pid=pid_sr, lmpc_laps=None, lap_steps=None,
                                lap_times=None, lmpc_state=None)

    log("Starting LMPC")
    lcfg = dataclasses.replace(cfg.lmpc, N=cfg.N)
    if cfg.n_lmpc_laps + lcfg.num_ss_it > lcfg.max_laps:
        raise ValueError(
            f"n_lmpc_laps ({cfg.n_lmpc_laps}) + num_ss_it ({lcfg.num_ss_it}) "
            f"exceeds the safe-set capacity lmpc.max_laps ({lcfg.max_laps})")
    if cfg.lap_max_steps % cfg.lap_chunk != 0:
        raise ValueError(f"lap_chunk ({cfg.lap_chunk}) must divide "
                         f"lap_max_steps ({cfg.lap_max_steps})")
    ctrl = lmpc_mod.make_lmpc(lcfg, trk, cfg.solver, sim.dt, dtype=dtype)
    state = lmpc_mod.init_lmpc_state(lcfg, batch, dtype=dtype,
                                     solver=cfg.solver, device=device)
    for _ in range(lcfg.num_ss_it):
        state = lmpc_mod.lmpc_add_trajectory(
            state, lcfg, pid_sr.x, pid_sr.u, pid_sr.x_glob, pid_sr.steps, L)
    noise = loop_mod.gaussian_noise(batch, 0, sim, gen, dtype, device)

    def runner(st, plant, done, step0):
        return loop_mod.run_lap(
            ctrl.step, st, plant, trk=trk, vp=vp, sim_cfg=sim,
            max_steps=cfg.lap_chunk, done0=done, step0=step0, noise=noise,
            table=table)

    plant = plant0
    laps, lap_steps, lap_times = [], [], []
    bi = torch.arange(batch, device=device)
    for it in range(cfg.n_lmpc_laps):
        sr, state = run_lap_chunked(runner, state, plant, cfg.lap_max_steps,
                                    cfg.lap_chunk, cfg.lap_max_steps)
        shift = torch.zeros_like(sr.plant_final.x)
        shift[:, 4] = L
        plant = PlantState(x=sr.plant_final.x - shift,
                           x_glob=sr.plant_final.x_glob)
        state = lmpc_mod.lmpc_add_trajectory(state, lcfg, sr.x, sr.u,
                                             sr.x_glob, sr.steps, L)
        laps.append(sr)
        lap_steps.append(sr.steps.cpu().numpy())
        slot = (state.ss.n_laps - 1).long()
        lap_times.append(state.ss.qfun[bi, slot, 0].cpu().numpy() * sim.dt)
        log(f"Completed lap {it}: steps={lap_steps[-1]}, "
            f"time={np.round(lap_times[-1], 2)} s")
    return ExperimentResult(
        pid=pid_sr, lmpc_laps=laps,
        lap_steps=np.stack(lap_steps, 1) if lap_steps else np.zeros((batch, 0)),
        lap_times=np.stack(lap_times, 1) if lap_times else np.zeros((batch, 0)),
        lmpc_state=state)
