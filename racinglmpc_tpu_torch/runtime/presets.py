"""Runnable presets: the five ``BASELINE.json`` configurations (port of
``racinglmpc_tpu/runtime/presets.py``).

Each preset is an :class:`ExperimentConfig` plus (batch, stages);
:func:`run_preset` runs one and returns its summary. Config 5 runs on one
card without a mesh: its own sizing (``offload_laps``, ``store_glob`` off,
``max_pts`` 1024) fits the whole batch on one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime.metrics import latency_report
from racinglmpc_tpu_torch.utils.config import LMPCConfig, SolverConfig

PRESETS: Dict[str, dict] = {
    # lap-1 PID path following, single vehicle
    "config1_pid": dict(
        stages="pid", batch=1,
        cfg=exp.ExperimentConfig(stage_steps=1000),
    ),
    # LTI-MPC path following, horizon N=14, batch 64
    "config2_lti": dict(
        stages="pid,lti", batch=64,
        cfg=exp.ExperimentConfig(stage_steps=450,
                                 solver=SolverConfig.throughput()),
    ),
    # LTV-MPC with local regression sys-ID, batch 256
    "config3_ltv": dict(
        stages="pid,ltv", batch=256,
        cfg=exp.ExperimentConfig(stage_steps=450,
                                 solver=SolverConfig.throughput()),
    ),
    # LMPC with a safe set from 10 laps, batch 1k
    "config4_lmpc": dict(
        stages="pid,lmpc", batch=1024,
        cfg=exp.ExperimentConfig(
            stage_steps=450, n_lmpc_laps=10, lap_max_steps=500,
            lap_chunk=25, solver=SolverConfig.throughput(),
            lmpc=LMPCConfig(max_laps=16, max_pts=1024, model_pts=512,
                            use_pallas_sysid=True),
        ),
    ),
    # full multi-lap LMPC (30 laps, growing safe set) x 4k variants
    "config5_lmpc_4k": dict(
        stages="pid,lmpc", batch=4096,
        cfg=exp.ExperimentConfig(
            stage_steps=450, n_lmpc_laps=30, lap_max_steps=500,
            lap_chunk=10, solver=SolverConfig.throughput(),
            offload_laps=True,
            lmpc=LMPCConfig(max_laps=36, max_pts=1024, model_pts=512,
                            store_glob=False, use_pallas_sysid=True),
        ),
    ),
}


def run_preset(name: str, seed: int = 0, scale_batch: float = 1.0,
               n_laps: Optional[int] = None, verbose: bool = False,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               device="cuda", cfg: Optional[exp.ExperimentConfig] = None,
               ) -> dict:
    """Run one preset; returns {preset, batch, wall_s, and for LMPC
    presets the lap times, completed laps, steps/s and batched-step
    latency}. ``scale_batch`` / ``n_laps`` shrink a preset without changing
    its structure; ``cfg`` replaces the preset's configuration (the same
    stages and batch), e.g. with another solver."""
    p = PRESETS[name]
    cfg = p["cfg"] if cfg is None else cfg
    if n_laps is not None and "lmpc" in p["stages"]:
        cfg = dataclasses.replace(cfg, n_lmpc_laps=n_laps)
    batch = max(int(p["batch"] * scale_batch), 1)
    t0 = time.time()
    res = exp.run_experiment(
        cfg, batch=batch, stages=p["stages"], seed=seed, verbose=verbose,
        checkpoint_dir=checkpoint_dir, checkpoint_every=2, resume=resume,
        device=device)
    wall = time.time() - t0
    out = {"preset": name, "batch": batch, "wall_s": round(wall, 2),
           "result": res}
    if res.resume_lap:
        out["resumed_from_lap"] = int(res.resume_lap)
    if res.lap_times is not None:
        out["mean_lap_times_s"] = np.round(res.lap_times.mean(0), 2).tolist()
        out["laps_completed"] = int(
            (res.lap_steps < cfg.lap_max_steps).all(axis=1).sum())
        exec_steps = int(res.lap_steps[:, res.resume_lap:].sum())
        if exec_steps:
            out["lmpc_steps_per_s"] = round(exec_steps / wall, 1)
        if res.lap_wall_s is not None and len(res.lap_wall_s):
            # batched-step wall latency: one lap's wall over the steps the
            # batch executed that lap (whole chunks until the last crossing)
            ch = cfg.lap_chunk
            max_steps = res.lap_steps.max(axis=0)[-len(res.lap_wall_s):]
            executed = np.ceil(np.maximum(max_steps, 1) / ch) * ch
            per_step = res.lap_wall_s / executed
            # lap 0 carries the one-time kernel build
            if len(per_step) > 1:
                per_step = per_step[1:]
            out["batched_step_latency"] = latency_report(per_step)
    return out
