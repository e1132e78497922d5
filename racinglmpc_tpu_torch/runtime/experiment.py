"""The four-stage racing experiment, scenario-batched.

Port of ``racinglmpc_tpu/runtime/experiment.py``. On the L-shaped track:

1. **PID** path following, ``stage_steps`` fixed steps (multi-lap);
2. **LTI-MPC** from a one-shot ridge fit of each scenario's PID data;
3. **LTV-MPC** with per-step local sys-ID on the PID lap;
4. **LMPC** for ``n_lmpc_laps`` laps, the safe set and the sys-ID store
   seeded with ``num_ss_it`` copies of the PID data; each lap runs in
   ``lap_chunk``-step chunks with an early exit on the host once every
   scenario has crossed the line. Lap steps come from the masks and lap
   times from Qfun (``qfun[lap, 0] * dt``).

The LMPC stage can write an atomic checkpoint (controller state, plant,
lap index) every ``checkpoint_every`` laps and resume from it; a resumed
run reproduces the uninterrupted one exactly, and its per-lap records
cover the whole experiment (the laps before the resume point come from the
checkpoint's meta sidecar).

With ``mesh`` (a :class:`~racinglmpc_tpu_torch.parallel.ScenarioMesh`)
every rank runs its own rows of the batch on its own device: the noise is
drawn for the whole batch and cut to the rank's rows, so every scenario
gets the draws of the unsharded run; the LMPC lap's early exit is one
decision over all ranks; the results are gathered, so every rank returns
the whole batch; rank 0 writes the gathered checkpoint and every rank
resumes from its own rows of it.

Noise (PID exploration, plant noise) is drawn from ``torch.Generator``s:
one per stage and one per LMPC lap, each seeded by :func:`stream_seed`
from ``seed`` and its stage (and lap) index, as the reference splits one
key per stage and folds the lap index into the LMPC stage's key. So a
resumed run draws the same noise, and adding or removing a stage leaves
the others' noise unchanged. The streams cannot reproduce the reference's
threefry bits.

``python -m racinglmpc_tpu_torch.runtime.experiment [--laps N] [--batch B]
[--stages pid,lti,ltv,lmpc] [--seed S] [--throughput] [--mesh]`` runs it on
the card and prints the lap times; with ``--mesh`` under ``torchrun
--nproc_per_node=G`` the scenarios are split over G cards (one NCCL rank
each; without torchrun, one rank).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.controllers import mpc as mpc_mod
from racinglmpc_tpu_torch.controllers.pid import make_pid_controller
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import Track, make_track, track_table
from racinglmpc_tpu_torch.parallel import mesh as mesh_mod
from racinglmpc_tpu_torch.runtime import checkpoint
from racinglmpc_tpu_torch.runtime import loop as loop_mod
from racinglmpc_tpu_torch.runtime import tracing
from racinglmpc_tpu_torch.utils.batched import tree_map
from racinglmpc_tpu_torch.utils.config import (
    LMPCConfig, MPCConfig, SimConfig, SolverConfig, VehicleParams)

PID, LTI, LTV, LMPC = range(4)   # stage indices of the noise streams


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    N: int = 14
    vt: float = 0.8
    lti_lambda: float = 1e-7          # ridge weight of the LTI fit
    n_lmpc_laps: int = 40
    stage_steps: int = 1000           # PID / LTI / LTV steps
    lap_max_steps: int = 1000         # per-LMPC-lap step cap
    lap_chunk: int = 125              # chunk of the host early exit
    pid_noise: bool = True
    # move each completed lap's trajectories to host memory instead of
    # keeping them on the card (nothing on the card reads them back)
    offload_laps: bool = False
    sim: SimConfig = SimConfig()
    mpc: MPCConfig = MPCConfig()
    lmpc: LMPCConfig = LMPCConfig()
    solver: SolverConfig = SolverConfig()


class StageResult(NamedTuple):
    x: torch.Tensor        # (B, T, 6)
    u: torch.Tensor        # (B, T, 2)
    x_glob: torch.Tensor   # (B, T, 6)
    mask: torch.Tensor     # (B, T)
    steps: torch.Tensor    # (B,)
    plant_final: PlantState
    collected: Any = None  # the lap runner's collect_fn archive, (B, T, ...)


class ExperimentResult(NamedTuple):
    pid: StageResult
    lti: Optional[StageResult]
    ltv: Optional[StageResult]
    lmpc_laps: Optional[List[StageResult]]
    lap_steps: Optional[np.ndarray]   # (B, n_lmpc_laps)
    lap_times: Optional[np.ndarray]   # (B, n_lmpc_laps) [s]
    lmpc_state: Optional[lmpc_mod.LMPCState]
    A_lti: Optional[torch.Tensor]     # (B, 6, 6)
    B_lti: Optional[torch.Tensor]     # (B, 6, 2)
    # host wall seconds per LMPC lap (synchronized at each lap's end)
    lap_wall_s: Optional[np.ndarray] = None
    # first lap executed by this call (> 0 on a resumed run)
    resume_lap: int = 0
    # host wall seconds of each stage run ({"pid": s, "lti": s, ...}),
    # synchronized with the device at the stage's end
    stage_wall_s: Optional[dict] = None


def stream_seed(seed: int, *path: int) -> int:
    """Seed of the noise stream at ``path`` (stage index, then lap index
    for the LMPC laps). The PID stage draws from ``seed`` itself, so the
    PID lap that seeds the LMPC main path does not depend on how the later
    streams are derived; every later stream is a 64-bit word of
    ``numpy.random.SeedSequence(seed, spawn_key=path)``."""
    if path == (PID,):
        return seed
    ss = np.random.SeedSequence(entropy=seed, spawn_key=path)
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def _generator(seed: int, device, *path: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *path))
    return g


def initial_plant(batch: int, dtype=torch.float32, device="cuda") -> PlantState:
    """x = x_glob = [0.5, 0, 0, 0, 0, 0] for every scenario."""
    x0 = torch.tensor([0.5, 0, 0, 0, 0, 0], dtype=dtype,
                      device=device).repeat(batch, 1)
    return PlantState(x=x0, x_glob=x0.clone())


def _stage_result(res: loop_mod.LapResult) -> StageResult:
    return StageResult(x=res.x, u=res.u, x_glob=res.x_glob, mask=res.mask,
                       steps=res.steps, plant_final=res.plant_final,
                       collected=res.collected)


def run_lap_chunked(runner, ctrl_state, plant: PlantState, max_steps: int,
                    chunk: int, pad_to: int, mesh=None):
    """One lap in ``chunk``-step pieces with a host early exit (over all
    ranks of ``mesh``, so every rank runs the same chunks).
    ``runner(ctrl_state, plant, done, step0) -> LapResult``. Returns
    (StageResult padded to ``pad_to`` steps, ctrl_state); the chunks'
    ``collected`` archives are joined and padded alike."""
    B = plant.x.shape[0]
    tracing.new_episode()
    done = torch.zeros((B,), dtype=torch.bool, device=plant.x.device)
    parts = []
    step0 = 0
    while step0 < max_steps:
        res = runner(ctrl_state, plant, done, step0)
        ctrl_state, plant, done = res.ctrl_state, res.plant_final, res.done
        parts.append(res)
        step0 += chunk
        with tracing.span("lap.exit"):
            exit_ = bool(done.all() if mesh is None
                         else mesh_mod.all_ranks(done, mesh))
        if exit_:
            break

    def pad(a):
        if a.shape[1] < pad_to:
            zeros = torch.zeros((B, pad_to - a.shape[1]) + a.shape[2:],
                                dtype=a.dtype, device=a.device)
            a = torch.cat([a, zeros], 1)
        return a[:, :pad_to]

    def cat_pad(name):
        return tree_map(lambda *ts: pad(torch.cat(ts, 1)),
                        *[getattr(r, name) for r in parts])

    with tracing.span("lap.freeze"):
        mask = cat_pad("mask")
        return StageResult(x=cat_pad("x"), u=cat_pad("u"),
                           x_glob=cat_pad("x_glob"), mask=mask,
                           steps=mask.sum(1).to(torch.int32),
                           plant_final=plant,
                           collected=cat_pad("collected")), ctrl_state


def run_experiment(cfg: ExperimentConfig = ExperimentConfig(), *,
                   batch: int = 1, trk: Optional[Track] = None,
                   vp: Optional[VehicleParams] = None,
                   stages: str = "pid,lti,ltv,lmpc", dtype=torch.float32,
                   device="cuda", seed: int = 0, mesh=None,
                   verbose: bool = False,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: int = 1,
                   resume: bool = False) -> ExperimentResult:
    """Run the selected stages (PID always runs) for ``batch`` scenarios
    on ``device``. ``checkpoint_dir``: the LMPC stage writes
    ``lmpc.npz`` there every ``checkpoint_every`` completed laps (and
    after the last); with ``resume`` an existing checkpoint is loaded and
    the laps continue after its lap. ``mesh``: a ``ScenarioMesh``
    (``parallel.make_mesh``); each rank runs its rows of ``batch`` (which
    must divide by the mesh size) on ``mesh.device``, and every rank
    returns the whole batch."""
    if mesh is None:
        rows, gather, rank0 = None, (lambda t: t), True
    elif isinstance(mesh, mesh_mod.ScenarioMesh):
        rows, rank0 = mesh.rows(batch), mesh.rank == 0
        device = mesh.device

        def gather(t):
            return mesh_mod.gather_scenario_tree(t, mesh)
    else:
        raise TypeError(f"mesh must be a ScenarioMesh, not "
                        f"{type(mesh).__name__}")
    local = batch if rows is None else rows.stop - rows.start
    if trk is None:
        trk = make_track(dtype=dtype, device=device)
    if vp is None:
        vp = VehicleParams()
    elif mesh is not None:
        vp = mesh_mod.shard_scenario_tree(vp, mesh)
    want = set(stages.split(","))
    table = track_table(trk)
    L = trk.total_len
    sim = cfg.sim
    log = print if verbose and rank0 else (lambda *a, **k: None)
    plant0 = initial_plant(local, dtype=dtype, device=device)

    walls = {}

    def run_fixed(step, state, stage: int, ctrl_dims: int = 0,
                  ctrl_noise: bool = True) -> StageResult:
        t0 = time.time()
        gen = _generator(seed, device, stage)
        sr = _stage_result(loop_mod.run_lap(
            step, state, plant0, trk=trk, vp=vp, sim_cfg=sim,
            max_steps=cfg.stage_steps, multi_lap=True, table=table,
            noise=loop_mod.gaussian_noise(batch, ctrl_dims, sim, gen, dtype,
                                          device, ctrl_noise=ctrl_noise,
                                          rows=rows)))
        sr.steps.cpu()          # waits for the stage's last step
        walls[("pid", "lti", "ltv")[stage]] = time.time() - t0
        return sr

    log("Starting PID")
    pid_step, pid0 = make_pid_controller(cfg.vt, noise=cfg.pid_noise)
    pid_sr = run_fixed(pid_step, pid0, PID, 2, cfg.pid_noise)

    lti_sr = ltv_sr = None
    A_lti = B_lti = None
    lmpc_laps: Optional[List[StageResult]] = None
    lap_steps = lap_times = None
    lmpc_state = None
    lap_wall: List[float] = []
    start_lap = 0

    if "lti" in want:
        log("Starting MPC (LTI)")
        A_lti, B_lti, _ = sysid.lti_regression(pid_sr.x, pid_sr.u,
                                               cfg.lti_lambda)
        mpc_cfg = dataclasses.replace(cfg.mpc, N=cfg.N, vt=cfg.vt)
        step, state = mpc_mod.make_lti_mpc(mpc_cfg, A_lti, B_lti, cfg.solver,
                                           dtype=dtype)
        lti_sr = run_fixed(step, state, LTI)

    if "ltv" in want:
        log("Starting TV-MPC")
        mpc_cfg = dataclasses.replace(cfg.mpc, N=cfg.N, vt=cfg.vt,
                                      time_varying=True)
        store = sysid.add_lap(
            sysid.make_lap_store(local, 1, cfg.lmpc.model_pts, dtype=dtype,
                                 device=device),
            pid_sr.x, pid_sr.u, pid_sr.steps)
        step, state = mpc_mod.make_ltv_mpc(mpc_cfg, store, trk, cfg.lmpc,
                                           cfg.solver, sim.dt, dtype=dtype)
        ltv_sr = run_fixed(step, state, LTV)

    if "lmpc" in want:
        log("Starting LMPC")
        lcfg = dataclasses.replace(cfg.lmpc, N=cfg.N)
        if cfg.n_lmpc_laps + lcfg.num_ss_it > lcfg.max_laps:
            raise ValueError(
                f"n_lmpc_laps ({cfg.n_lmpc_laps}) + num_ss_it "
                f"({lcfg.num_ss_it}) exceeds the safe-set capacity "
                f"lmpc.max_laps ({lcfg.max_laps})")
        if cfg.lap_max_steps % cfg.lap_chunk != 0:
            raise ValueError(f"lap_chunk ({cfg.lap_chunk}) must divide "
                             f"lap_max_steps ({cfg.lap_max_steps})")
        ctrl = lmpc_mod.make_lmpc(lcfg, trk, cfg.solver, sim.dt, dtype=dtype)
        lmpc_state = lmpc_mod.init_lmpc_state(lcfg, local, dtype=dtype,
                                              solver=cfg.solver,
                                              device=device)
        plant = plant0
        lap_steps_l: List[np.ndarray] = []
        lap_times_l: List[np.ndarray] = []
        lmpc_laps = []
        lmpc_seed = stream_seed(seed, LMPC)
        ckpt_path = None
        resumed = False
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            ckpt_path = os.path.join(checkpoint_dir, "lmpc")
            if resume and os.path.exists(ckpt_path + ".npz"):
                (lmpc_state, plant), saved_seed, last_lap = checkpoint.load(
                    ckpt_path, (lmpc_state, plant), rows=rows)
                if saved_seed != lmpc_seed:
                    raise ValueError(
                        "resume seed mismatch: the checkpoint was written by "
                        "a run with another seed, so resumed laps would not "
                        "reproduce the uninterrupted run")
                start_lap = last_lap + 1
                resumed = True
                meta_path = ckpt_path + ".npz.meta.json"
                if os.path.exists(meta_path):
                    with open(meta_path) as f:
                        hist = json.load(f)
                    lap_steps_l = [np.asarray(v, dtype=np.int32)
                                   for v in hist.get("lap_steps", [])]
                    lap_times_l = [np.asarray(v)
                                   for v in hist.get("lap_times", [])]
                    lap_wall = list(hist.get("lap_wall_s", []))
                log(f"Resumed from checkpoint after lap {last_lap}")
        if not resumed:
            for _ in range(lcfg.num_ss_it):
                lmpc_state = lmpc_mod.lmpc_add_trajectory(
                    lmpc_state, lcfg, pid_sr.x, pid_sr.u, pid_sr.x_glob,
                    pid_sr.steps, L)

        bi = torch.arange(local, device=device)
        for it in range(start_lap, cfg.n_lmpc_laps):
            t0 = time.time()
            noise = loop_mod.gaussian_noise(
                batch, 0, sim, _generator(seed, device, LMPC, it), dtype,
                device, rows=rows)

            def runner(st, plant, done, step0, noise=noise):
                return loop_mod.run_lap(
                    ctrl.step, st, plant, trk=trk, vp=vp, sim_cfg=sim,
                    max_steps=cfg.lap_chunk, done0=done, step0=step0,
                    noise=noise, table=table)

            sr, lmpc_state = run_lap_chunked(runner, lmpc_state, plant,
                                             cfg.lap_max_steps,
                                             cfg.lap_chunk,
                                             cfg.lap_max_steps, mesh=mesh)
            shift = torch.zeros_like(sr.plant_final.x)
            shift[:, 4] = L
            plant = PlantState(x=sr.plant_final.x - shift,
                               x_glob=sr.plant_final.x_glob)
            lmpc_state = lmpc_mod.lmpc_add_trajectory(
                lmpc_state, lcfg, sr.x, sr.u, sr.x_glob, sr.steps, L)
            sr_all = gather(sr)
            lmpc_laps.append(tree_map(lambda t: t.cpu(), sr_all)
                             if cfg.offload_laps else sr_all)
            lap_steps_l.append(sr_all.steps.cpu().numpy())
            lap_wall.append(time.time() - t0)    # the copy above syncs
            slot = (lmpc_state.ss.n_laps - 1).long()
            lap_times_l.append(
                gather(lmpc_state.ss.qfun[bi, slot, 0]).cpu().numpy()
                * sim.dt)
            log(f"Completed lap {it}: steps={lap_steps_l[-1]}, "
                f"time={np.round(lap_times_l[-1], 2)} s")
            if ckpt_path is not None and (
                    (it + 1) % checkpoint_every == 0
                    or it == cfg.n_lmpc_laps - 1):
                whole = gather((lmpc_state, plant))
                if rank0:
                    checkpoint.save(
                        ckpt_path, whole, lmpc_seed, it,
                        meta={"lap_steps": [v.tolist() for v in lap_steps_l],
                              "lap_times": [v.tolist() for v in lap_times_l],
                              "lap_wall_s": [float(v) for v in lap_wall]})
                if mesh is not None:      # the file is whole for every rank
                    mesh.barrier()
        if lap_steps_l:
            lap_steps = np.stack(lap_steps_l, 1)
            lap_times = np.stack(lap_times_l, 1)
        else:
            log("Checkpoint already covers all laps; nothing to run")
            lap_steps = np.zeros((batch, 0), dtype=np.int32)
            lap_times = np.zeros((batch, 0))

    return ExperimentResult(
        pid=gather(pid_sr), lti=gather(lti_sr), ltv=gather(ltv_sr),
        lmpc_laps=lmpc_laps, lap_steps=lap_steps, lap_times=lap_times,
        lmpc_state=gather(lmpc_state), A_lti=gather(A_lti),
        B_lti=gather(B_lti),
        lap_wall_s=np.asarray(lap_wall) if "lmpc" in want else None,
        resume_lap=start_lap if "lmpc" in want else 0, stage_wall_s=walls)


def main(argv=None) -> int:
    """The port's counterpart of ``examples/run_experiment.py``."""
    p = argparse.ArgumentParser()
    p.add_argument("--laps", type=int, default=8, help="LMPC laps")
    p.add_argument("--batch", type=int, default=4, help="scenario batch")
    p.add_argument("--stages", default="pid,lmpc")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--throughput", action="store_true",
                   help="use the fast solver config")
    p.add_argument("--mesh", action="store_true",
                   help="split the scenarios over the ranks torchrun "
                        "started, one card each")
    args = p.parse_args(argv)
    solver = (SolverConfig.throughput() if args.throughput
              else SolverConfig(max_iter=200))
    cfg = ExperimentConfig(
        stage_steps=450, n_lmpc_laps=args.laps, lap_max_steps=500,
        lap_chunk=125, solver=solver,
        lmpc=LMPCConfig(max_laps=args.laps + 6, max_pts=1024, model_pts=512))
    mesh = None
    if args.mesh:
        mesh_mod.init_multi_host()
        mesh = mesh_mod.make_mesh()
    t0 = time.time()
    try:
        res = run_experiment(cfg, batch=args.batch, stages=args.stages,
                             seed=args.seed, verbose=True, mesh=mesh)
    finally:
        if mesh is not None:
            mesh.close()
            if dist.is_initialized():        # torchrun's group
                dist.destroy_process_group()
    if mesh is not None and mesh.rank != 0:
        return 0
    print(f"wall: {time.time() - t0:.1f}s")
    if res.lap_times is not None:
        print("lap times [s] (rows=scenarios):")
        print(np.round(res.lap_times, 2))
        mono = np.all(np.diff(res.lap_times, axis=1) <= 0.5)
        print("lap times (approximately) non-increasing:", bool(mono))
        if res.lap_times.shape[1] >= 3:
            gain = 1.0 - res.lap_times[:, -1] / res.lap_times[:, 0]
            print(f"improvement first->last lap: {np.round(100 * gain, 1)} %")
            if np.any(gain < 0.05):
                print("WARNING: <5% improvement: LMPC is not learning "
                      "(solver rejecting every step?)")
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
