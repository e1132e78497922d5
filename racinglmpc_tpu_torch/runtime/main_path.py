"""The main path's workload: batched LMPC control steps seeded from one PID
stage (the setup ``bench.py`` times in the reference package).

``batch`` scenarios share one PID seed lap (``run_experiment(stages="pid",
batch=1)``, 450 steps), stored ``num_ss_it`` times in the safe set and the
sys-ID store; every scenario starts at x0 = [0.5, 0, 0, 0, 0, 0] and gets
its own plant noise. Solver ``SolverConfig.throughput()``,
``LMPCConfig(max_laps=12, max_pts=1024, model_pts=512)``, N = 14, with the
three CUDA kernels engaged on a CUDA device.

On a card, ``python -m racinglmpc_tpu_torch.runtime.main_path`` profiles
a few steps (``torch.profiler``: kernel time by name, device busy share);
with ``--time`` it prints the solves/s of a timed 50-step chunk after a
50-step warm-up, as ``chip_smoke.py`` measures it.
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
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                               SolverConfig, VehicleParams)


def config() -> exp.ExperimentConfig:
    return exp.ExperimentConfig(
        stage_steps=450, solver=SolverConfig.throughput(),
        sim=SimConfig(use_pallas_rollout=True),
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


def setup(batch: int = 256, device="cuda", seed: int = 0):
    """Returns (MainPath, seeded LMPC state, initial plant, PID result)."""
    cfg = config()
    trk = make_track(device=device)
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
    for _ in range(steps):
        state, u = mp.ctrl.step(state, plant.x)
        draws = torch.randn((mp.batch, 3), generator=mp.gen,
                            device=plant.x.device)
        plant = loop.plant_step(plant, u, mp.vp, mp.trk, mp.cfg.sim, draws,
                                mp.table)
        iters.append(state.iters)
        rej = rej + (state.rejects > 0).sum()
        uns = uns + (~state.feasible).sum()
    return Chunk(state, plant, torch.stack(iters), rej, uns)


def profile(batch: int, steps: int) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    mp, state, plant, _ = setup(batch)
    state, plant = run_chunk(mp, state, plant, 20)[:2]   # warm-up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = run_chunk(mp, state, plant, steps)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = prof.key_averages()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{steps} steps at batch {batch}: wall {wall * 1e3:.1f} ms, "
          f"device busy {dev_us / 1e3:.1f} ms "
          f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
          f"ADMM iters mean {float(out.iters.float().mean()):.2f}")
    print(events.table(sort_by="self_device_time_total", row_limit=25))


def timed(batch: int, steps: int) -> None:
    mp, state, plant, _ = setup(batch)
    state, plant = run_chunk(mp, state, plant, steps)[:2]   # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    out = run_chunk(mp, state, plant, steps)
    torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"{batch * steps / wall:.1f} solves/s (batch {batch}, {steps} "
          f"steps in {wall:.3f} s), ADMM iters mean "
          f"{float(out.iters.float().mean()):.2f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=None,
                    help="profiled steps (10) or timed steps (50)")
    ap.add_argument("--time", action="store_true",
                    help="time a chunk instead of profiling")
    a = ap.parse_args()
    if a.time:
        timed(a.batch, a.steps or 50)
    else:
        profile(a.batch, a.steps or 10)
