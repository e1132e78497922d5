"""``plant_gap`` at a curvature jump, on the CPU: the program's plant (B3's
plain version, float32) against ``judge.plant_next`` (the float64
reference) on 2,000 states that cross s = 5.5, where the curvature flips
from 0.698 to -0.698. Each state is placed so that one of its substeps
lands within 8 ulps of the jump, where the float32 and float64 arc lengths
may fall on the two sides of it."""
import types

import numpy as np
import pytest
import torch

from lmpc_bench import judge, spec
from lmpc_bench.reference import ref_plant
from lmpc_bench.stages import lmpc as lmpc_stage
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.config import VehicleParams

CELL = "lmpc_b256.converged_lap"
JUMP = 5.5
STATES = 2000


@pytest.fixture(scope="module")
def crossing():
    """(ref, sim, x, x_glob, u, draws, limit): float32 states one period
    before the jump, from the seed laps' last states before it, varied."""
    torch.set_num_threads(1)
    c = spec.cell(CELL)
    laps = lmpc_stage.seed_laps(c.traffic)
    ref = judge.reference(c.config, c.traffic, laps)
    _, _, sim = lmpc_stage.port_configs(c.config, c.traffic)
    rng = np.random.default_rng(5500)
    base = []
    for x, u, xg, n in laps:
        i = int(np.flatnonzero(x[:n, 4] < JUMP)[-1])
        base.append((x[i], u[i], xg[i]))
    pick = rng.integers(len(base), size=STATES)
    X, U, XG = (np.stack([base[k][j] for k in pick]).astype(float)
                for j in range(3))
    X[:, 0] += rng.uniform(-0.1, 0.1, STATES)
    X[:, 1] += rng.uniform(-0.02, 0.02, STATES)
    X[:, 2] += rng.uniform(-0.1, 0.1, STATES)
    X[:, 3] += rng.uniform(-0.02, 0.02, STATES)
    X[:, 5] += rng.uniform(-0.05, 0.05, STATES)
    X[:, 4] = JUMP - rng.uniform(1e-3, 0.08 * X[:, 0])
    U[:, 0] += rng.uniform(-0.02, 0.02, STATES)
    U[:, 1] += rng.uniform(-0.05, 0.05, STATES)
    X, U, XG = (a.astype(np.float32).astype(float) for a in (X, U, XG))
    ulp = float(np.spacing(np.float32(JUMP)))
    target = JUMP + rng.uniform(-8, 8, STATES) * ulp
    for i in range(STATES):
        # before the jump the curvature is constant, so the substeps'
        # arc lengths move with the start's: shift it to put the nearest
        # substep at the target
        seen = []
        ref_plant.plant_step(X[i], XG[i], U[i],
                             lambda v: seen.append(v) or ref.curv(v),
                             dt=ref.dt)
        near = min(seen, key=lambda v: abs(v - JUMP))
        X[i, 4] = float(np.float32(X[i, 4] + target[i] - near))
    draws = rng.standard_normal((STATES, 3)).astype(np.float32)
    limit = c.limits["limits"]["plant_gap"]
    return ref, sim, X, XG, U, draws.astype(float), limit


def program(crossing, offset=(0.0, 0.0)):
    """The program's next states (B3's plain version, float32), with
    ``offset`` added to the input it applies."""
    ref, sim, X, XG, U, D, _ = crossing
    f32 = [torch.tensor(a, dtype=torch.float32) for a in (X, XG, U, D)]
    trk = make_track(dtype=torch.float32, device="cpu")
    out = loop.plant_step(PlantState(x=f32[0], x_glob=f32[1]),
                          f32[2] + torch.tensor(offset), VehicleParams(), trk,
                          sim, f32[3], track_table(trk))
    return out.x.double().numpy()


def gaps(crossing, x_next, float64_lookup=False):
    """Each state's plant gap and whether the reference took the jump's
    other side; ``float64_lookup``: the reference without the repair."""
    ref, _, X, XG, U, D, _ = crossing
    out, other = [], []
    for i in range(STATES):
        s = types.SimpleNamespace(x0=X[i], xg0=XG[i], u=U[i], draw=D[i],
                                  x_next=x_next[i])
        if float64_lookup:
            noise = np.clip(D[i] * ref.sigma, -ref.clip, ref.clip)
            x, _ = ref_plant.plant_step(X[i], XG[i], U[i], ref.curv,
                                        dt=ref.dt,
                                        noise=noise * (ref.gain / 0.01))
            o = False
        else:
            x, o = judge.plant_next(ref, s)
        out.append(np.abs(x_next[i] - x).max())
        other.append(o)
    return np.array(out), np.array(other)


def test_a_float32_plant_crossing_a_curvature_jump_is_within_the_limit(
        crossing):
    x_next = program(crossing)
    assert (x_next[:, 4] > JUMP).all()              # every state crosses
    limit = crossing[-1]
    before, _ = gaps(crossing, x_next, float64_lookup=True)
    after, other = gaps(crossing, x_next)
    # the float64 lookup alone fails a correct float32 plant here ...
    assert (before > limit).sum() >= 20
    # ... and the program's side of the jump passes every state, the other
    # side taken exactly where the float64 side read over the limit
    assert after.max() < limit / 100
    assert other.tolist() == (before > limit).tolist()


def test_a_planted_input_offset_still_fails_at_the_jump(crossing):
    x_next = program(crossing, offset=(0.0, 0.02))
    after, _ = gaps(crossing, x_next)
    assert after.min() > crossing[-1]
