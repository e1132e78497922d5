"""The main path's workload: batched LMPC control steps seeded from one PID
stage (the setup ``bench.py`` times in the reference package).

``batch`` scenarios share one PID seed lap (``run_experiment(stages="pid",
batch=1)``, 450 steps), stored ``num_ss_it`` times in the safe set and the
sys-ID store; every scenario starts at x0 = [0.5, 0, 0, 0, 0, 0] and gets
its own plant noise. Solver ``SolverConfig.throughput()``,
``LMPCConfig(max_laps=12, max_pts=1024, model_pts=512)``, N = 14, with the
three CUDA kernels engaged on a CUDA device.

On a card, ``python -m racinglmpc_tpu_torch.runtime.main_path [--batch B]
[--steps S]`` profiles a few steps with the tracer armed
(:func:`profile`); ``python -m racinglmpc_tpu_torch.runtime.bench`` times
it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import torch

from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.models.track import Track, TrackTable, make_track
from racinglmpc_tpu_torch.models.track import track_table
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop, tracing
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                               SolverConfig, VehicleParams)


def config(solver: SolverConfig = None,
           pallas_rollout: bool = True) -> exp.ExperimentConfig:
    """The main path's configuration; ``solver`` replaces its
    ``SolverConfig.throughput()`` (e.g. at another
    ``pallas_iter_precision``); ``pallas_rollout=False`` steps the plant
    without the rollout kernel."""
    return exp.ExperimentConfig(
        stage_steps=450, solver=solver or SolverConfig.throughput(),
        sim=SimConfig(use_pallas_rollout=pallas_rollout),
        lmpc=LMPCConfig(max_laps=12, max_pts=1024, model_pts=512,
                        use_pallas_sysid=True))


@dataclasses.dataclass(eq=False)
class MainPath:
    cfg: exp.ExperimentConfig
    trk: Track
    table: TrackTable
    vp: VehicleParams
    ctrl: lmpc_mod.LMPCController
    gen: torch.Generator
    batch: int


class Chunk(NamedTuple):
    state: lmpc_mod.LMPCState
    plant: object
    iters: torch.Tensor       # (steps, B) ADMM iterations per solve
    rejected: torch.Tensor    # () solves the controller rejected
    unsolved: torch.Tensor    # () solves not at tolerance (incl. rejected)


def setup(batch: int = 256, device="cuda", seed: int = 0,
          solver: SolverConfig = None, pallas_rollout: bool = True,
          pid: exp.ExperimentResult = None):
    """Returns (MainPath, seeded LMPC state, initial plant, PID result);
    ``solver``, ``pallas_rollout``: see :func:`config`; ``pid``: an earlier
    setup's PID result to seed from instead of running the PID stage."""
    cfg = config(solver, pallas_rollout)
    trk = make_track(device=device)
    if pid is None:
        pid = exp.run_experiment(cfg, batch=1, stages="pid", trk=trk,
                                 device=device, seed=seed)
    xs, us, xgs = (a.expand(batch, -1, -1) for a in
                   (pid.pid.x, pid.pid.u, pid.pid.x_glob))
    steps = pid.pid.steps.expand(batch)
    state = lmpc_mod.init_lmpc_state(cfg.lmpc, batch, solver=cfg.solver,
                                     device=device)
    for _ in range(cfg.lmpc.num_ss_it):
        state = lmpc_mod.lmpc_add_trajectory(state, cfg.lmpc, xs, us, xgs,
                                             steps, trk.total_len)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    mp = MainPath(cfg=cfg, trk=trk, table=track_table(trk),
                  vp=VehicleParams(),
                  ctrl=lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver,
                                          cfg.sim.dt),
                  gen=gen, batch=batch)
    return mp, state, exp.initial_plant(batch, device=device), pid


def run_chunk(mp: MainPath, state, plant, steps: int) -> Chunk:
    """``steps`` control steps + plant periods, no host synchronization
    beyond the solver's own loop exits."""
    iters = []
    rej = torch.zeros((), dtype=torch.int64, device=plant.x.device)
    uns = torch.zeros_like(rej)
    for t in range(steps):
        tracing.at_step(t)
        state, u = mp.ctrl.step(state, plant.x)
        draws = torch.randn((mp.batch, 3), generator=mp.gen,
                            device=plant.x.device)
        plant = loop.plant_step(plant, u, mp.vp, mp.trk, mp.cfg.sim, draws,
                                mp.table)
        iters.append(state.iters)
        rej = rej + (state.rejects > 0).sum()
        uns = uns + (~state.feasible).sum()
    return Chunk(state, plant, torch.stack(iters), rej, uns)


def profile(batch: int, steps: int) -> dict:
    """``steps`` steps after a 20-step warm-up, inside a tracing session
    and ``torch.profiler`` (the device's activity: kernels, copies, CUDA
    runtime calls). Prints the device busy share (the union of the device
    intervals over the profiled wall), the per-span table
    (:func:`tracing.table`: per step, each stage's host self time, the
    device time of the kernels it launched, the device idle time while it
    was the innermost span, its launches and syncs) and the tracer's
    counters (Newton-Schulz passes and lane-iterations, B1's rescue);
    returns the overlay and the counters."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    mp, state, plant, _ = setup(batch)
    state, plant = run_chunk(mp, state, plant, 20)[:2]   # warm-up
    torch.cuda.synchronize()
    with tracing.session() as rec:
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time_ns()
            out = run_chunk(mp, state, plant, steps)
            torch.cuda.synchronize()
            t1 = time.time_ns()
    ov = tracing.overlay(rec.spans, *tracing.profiler_events(prof),
                         window=(t0, t1), steps=steps)
    print(f"{steps} steps at batch {batch}: wall {(t1 - t0) * 1e-6:.1f} ms, "
          f"device busy {ov['busy_ms']:.1f} ms "
          f"({100 * ov['busy_ms'] / ov['window_ms']:.1f}% of wall), "
          f"ADMM iters mean {float(out.iters.float().mean()):.2f}")
    print(tracing.table(ov))
    print("counters: " + ", ".join(f"{k} {v}" for k, v in
                                   sorted(rec.counts.items())))
    return {"overlay": ov, "counts": dict(rec.counts)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10, help="profiled steps")
    a = ap.parse_args()
    profile(a.batch, a.steps)
