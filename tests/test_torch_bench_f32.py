"""The bench gate's lap runner in float32, the dtype the card runs, against
the root ``bench.py``'s ``_run_gate_laps`` on the CPU (the kernels' plain
versions on both sides).

In float32 the two controllers part from the first solves: from the same
float32 state the two solvers take other ADMM iteration counts, and the
closed loop amplifies that into other lap steps.
``tests/test_torch_bench.py`` holds the two equal in float64; here one lap
from the committed converged laps (batch 2, chunk 30, noise off, as there)
is held within bounds:

- both finish the lap;
- the port's mean lap steps are within 5% of the reference's lap at its
  own float64 precision (the lap both packages run in float64), and at
  most 5% above the reference's float32 lap;
- the port's shares of rejected solves and of solves not at tolerance are
  at most the reference's float32 shares plus 5 percentage points, so the
  port's float32 path may not be worse than the reference's by more than
  that.

CPU run (mean steps, rejected and not-at-tolerance solves): the
reference's float64 lap 83, 2 and 2 of 166 solves; its float32 lap 88, 8
and 80 of 176 (its float32 inverse stops at ~4.8e-4 and 45% of its solves
miss the tolerance); the port's float32 lap 83, 0 and 6 of 166 (before the
float64 final squaring of its inverse, ROADMAP C6: 85, 2 and 64 of 170).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from racinglmpc_tpu.controllers import lmpc as jlmpc
from racinglmpc_tpu.models import dynamics as jdyn
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.runtime import experiment as jexp
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.runtime import bench as tbench
from racinglmpc_tpu_torch.runtime import experiment as texp
from racinglmpc_tpu_torch.utils import config as tc

torch.set_num_threads(1)
STEPS_REL = 0.05
SHARE_ABOVE = 0.05
PLANT = jdyn.PlantState


def _reference(seeds, kw, dtype):
    """The root bench.py's gate laps at ``dtype``: in float64 its
    controller, state and x0 are made float64 through their own ``dtype``
    arguments, as ``tests/test_torch_bench.py`` does."""
    lkw = dict(max_laps=12, max_pts=1024, model_pts=512)
    cfg = jexp.ExperimentConfig(sim=jc.SimConfig(noise=False),
                                solver=jc.SolverConfig.throughput(),
                                lmpc=jc.LMPCConfig(**lkw))
    with pytest.MonkeyPatch.context() as mp:
        if dtype == jnp.float64:
            for name in ("init_lmpc_state", "make_lmpc"):
                mp.setattr(jlmpc, name, functools.partial(
                    getattr(jlmpc, name), dtype=jnp.float64))
            mp.setattr(jdyn, "PlantState", lambda x, x_glob: PLANT(
                x=jnp.asarray(x, jnp.float64),
                x_glob=jnp.asarray(x_glob, jnp.float64)))
        return jbench._run_gate_laps(
            cfg, jtrack.make_track(dtype=dtype), jc.VehicleParams(),
            [tuple(jnp.asarray(a) for a in s) for s in seeds],
            jax.random.PRNGKey(0), log=lambda *a: None, **kw)


def test_gate_lap_float32_within_bounds_of_reference():
    lkw = dict(max_laps=12, max_pts=1024, model_pts=512)
    fx = np.load(tbench.CONVERGED_FIXTURE)
    seeds = [[fx[f"{k}{i}"] for k in ("x", "u", "xg", "steps")]
             for i in range(int(fx["n_laps"]))]
    kw = dict(laps=1, batch=2, chunk=30, max_steps=120)
    ref = _reference(seeds, kw, jnp.float32)
    (exact,), _, _ = _reference(seeds, kw, jnp.float64)
    got = tbench.gate_laps(
        texp.ExperimentConfig(sim=tc.SimConfig(noise=False),
                              solver=tc.SolverConfig.throughput(),
                              lmpc=tc.LMPCConfig(**lkw)),
        ttrack.make_track(device="cpu"), tc.VehicleParams(),
        [tuple(torch.from_numpy(a) for a in s) for s in seeds],
        device="cpu", **kw)
    (r_steps,), (r_rej,), (r_unc,) = ref
    (p_steps,), (p_rej,), (p_unc,) = got
    assert max(r_steps, p_steps) < kw["max_steps"]       # the lap finished
    assert abs(p_steps - exact) <= STEPS_REL * exact, (exact, ref, got)
    assert p_steps <= (1 + STEPS_REL) * r_steps, (ref, got)
    r_solves, p_solves = r_steps * kw["batch"], p_steps * kw["batch"]
    assert p_rej / p_solves <= r_rej / r_solves + SHARE_ABOVE, (ref, got)
    assert p_unc / p_solves <= r_unc / r_solves + SHARE_ABOVE, (ref, got)
