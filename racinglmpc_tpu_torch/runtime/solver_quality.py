"""The 40-lap lap-time criterion (level (c) of how the port is held): the
port's LMPC controller against the float64 reference-semantics oracle,
both driven through the same float64 plant with the same draws.

The port's counterpart of ``run_jax`` in ``examples/solver_quality.py``:
one scenario (batch 1), ``LMPCConfig()`` unless the caller passes another,
the PID seed lap stored ``num_ss_it`` times, then ``laps`` laps of at most
1000 steps. Each step the controller acts on the plant's float64 state
(cast to the controller's dtype), the caller's plant advances it one
period with that lap's noise row, and the lap ends once the arc length
passes the track length. After each lap the crossing state's arc length
drops by one track length and the lap is stored with its states passed as
``x_glob`` too, the reference harness's quirk, kept so that both runs
store the same rows.

The draws, the seed lap and the oracle's own lap steps are committed in
``fixtures/solver_quality_40lap_v1.npz`` (:func:`load_fixture`): the
record's (``oracle_f64`` of ``BENCH_solver_quality_40lap_tpu.json``) and
a rerun's. The float64 oracle is chaotic too: rerun under another numpy
and OpenBLAS it gives the record's steps on laps 0-26 and differs from lap
27 on (3,450 steps in all against 3,448), so the criterion holds the port
to both. The plant step and the curvature lookup are the caller's (the
float64 NumPy plant of ``tests/oracles/ref_plant.py`` in the checks), so
this module reads no test code. Per lap it returns the steps, the rejected solves
(the solution not applied), the solves accepted off tolerance and the
99th percentile of the ADMM iterations, the record's columns
(``BENCH_solver_quality_40lap_tpu.json``), and :func:`summary` the
record's cumulative and last-lap differences to the oracle.
"""
from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.models.track import Track
from racinglmpc_tpu_torch.utils.config import LMPCConfig, SolverConfig

X0 = (0.5, 0.0, 0.0, 0.0, 0.0, 0.0)
MAX_STEPS = 1000
PAD_ROWS = 2048        # rows a stored lap is zero-padded to (the harness's)
CRITERION = 0.01       # cumulative lap steps against the oracle's
FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "fixtures", "solver_quality_40lap_v1.npz")


class Fixture(NamedTuple):
    xs: np.ndarray          # (T, 6) PID seed lap states, float64
    us: np.ndarray          # (T, 2) its inputs
    noise: np.ndarray       # (laps + 1, 1000, 3) clipped plant draws
    oracle: np.ndarray      # (laps,) the record's oracle lap steps
    oracle_rerun: np.ndarray  # (laps,) the oracle rerun on these draws
    rerun_env: str          # where the rerun ran
    track_len: float


def load_fixture(path: str = FIXTURE) -> Fixture:
    f = np.load(path)
    return Fixture(f["xs"], f["us"], f["noise"], f["oracle_steps"],
                   f["oracle_steps_rerun"], str(f["rerun_env"]),
                   float(f["track_len"]))


class Laps(NamedTuple):
    steps: List[int]
    rejected: List[int]
    unconverged: List[int]
    iters_p99: List[int]
    finite: bool            # every applied input finite


def _pad(a: np.ndarray, dtype, device) -> torch.Tensor:
    out = torch.zeros((1, PAD_ROWS, a.shape[1]), dtype=dtype, device=device)
    out[0, :len(a)] = torch.as_tensor(a[:PAD_ROWS], dtype=dtype)
    return out


def run_laps(trk: Track, plant_step: Callable, curvature: Callable,
             fx: Fixture, laps: int, solver: SolverConfig,
             dtype=torch.float32, lcfg: LMPCConfig = LMPCConfig(),
             device="cuda", log: Callable = lambda _m: None,
             hook: Optional[Callable] = None) -> Laps:
    """``laps`` laps of the port's controller on ``trk`` (its device and
    ``dtype``) through ``plant_step(x, x_glob, u, curvature, noise=row)``
    (float64 NumPy, one control period) with ``fx``'s seed lap and draws.
    ``hook(ctrl, state, x)``, if given, sees each step's controller state
    and input state before the step."""
    L = fx.track_len
    Lt = torch.tensor(L, dtype=dtype, device=device)
    ctrl = lmpc_mod.make_lmpc(lcfg, trk, solver, 0.1, dtype=dtype)
    state = lmpc_mod.init_lmpc_state(lcfg, 1, dtype=dtype, device=device)

    def add(state, xs, us):
        x, u = _pad(xs, dtype, device), _pad(us, dtype, device)
        n = torch.tensor([len(xs)], dtype=torch.int32, device=device)
        return lmpc_mod.lmpc_add_trajectory(state, lcfg, x, u, x, n, Lt)

    for _ in range(lcfg.num_ss_it):
        state = add(state, fx.xs, fx.us)
    out = Laps([], [], [], [], True)
    x, g = np.array(X0), np.array(X0)
    for lap in range(laps):
        xs, us, iters = [], [], []
        rejects = unconv = 0
        for t in range(MAX_STEPS):
            x_t = torch.tensor(x, dtype=dtype, device=device)[None]
            if hook is not None:
                hook(ctrl, state, x_t)
            state, u = ctrl.step(state, x_t, None)
            # one transfer a step: u, rejected, off tolerance, iterations
            row = torch.cat([u[0].double(), (state.rejects > 0).double(),
                             (~state.feasible).double(),
                             state.iters.double()]).cpu().numpy()
            u = row[:2]
            rejects += int(row[2])
            unconv += int(row[3])
            iters.append(int(row[4]))
            out = out._replace(finite=out.finite and bool(
                np.isfinite(u).all()))
            xs.append(x.copy())
            us.append(u.copy())
            x, g = plant_step(x, g, u, curvature, noise=fx.noise[lap, t])
            if x[4] > L:
                break
        x = x.copy()
        x[4] -= L
        state = add(state, np.array(xs), np.array(us))
        out.steps.append(len(xs))
        out.rejected.append(rejects)
        out.unconverged.append(unconv)
        out.iters_p99.append(int(np.percentile(iters, 99)))
        log(f"lap {lap}: {len(xs)} (rejected {rejects}, unconverged "
            f"{unconv}, iters_p99 {out.iters_p99[-1]})")
    return out


def summary(steps, oracle) -> dict:
    """The record's differences to the oracle (percent, unrounded) over
    the laps run: cumulative |sum - sum| / sum, and the last lap's signed
    difference."""
    s = np.asarray(steps, dtype=float)
    ref = np.asarray(oracle, dtype=float)[:len(s)]
    return {"total_rel_diff_pct": abs(s.sum() - ref.sum()) / ref.sum() * 100,
            "final_lap_rel_diff_pct": (s[-1] - ref[-1]) / ref[-1] * 100}
