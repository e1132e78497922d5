"""The port's LTI fit and LTI/LTV-MPC against the JAX package (float64).

- ``lti_regression`` equals JAX's to 1e-9, over the whole trajectory and
  with ragged ``steps``;
- the golden LTI step: ``make_lti_mpc(MPCConfig(), A_lti, B_lti,
  SolverConfig(max_iter=500))`` from x0 reproduces ``mpc_u0`` and
  ``mpc_x_pred`` of ``tests/golden/pipeline_v1.npz`` to 1e-9;
- five LTV steps (default ``SolverConfig()``, so the structured KKT build)
  equal JAX's step on the full ``MPCState`` to 1e-8, the initial state
  carried across with ``convert.from_jax``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.controllers import mpc as jmpc
from racinglmpc_tpu.models import dynamics as jdyn
from racinglmpc_tpu.models import sysid as jsysid
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch import convert
from racinglmpc_tpu_torch.controllers import mpc as tmpc
from racinglmpc_tpu_torch.models import sysid as tsysid
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.utils import config as tc
from tests.test_torch_lmpc import _asdict, _seed_lap

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pipeline_v1.npz")


def _trajectories(B=3, T=60, seed=0):
    xs, us = zip(*(_seed_lap(T, seed + b) for b in range(B)))
    return np.stack(xs), np.stack(us)


@pytest.mark.parametrize("ragged", [False, True])
def test_lti_regression_matches_reference(ragged):
    x, u = _trajectories()
    steps = np.array([60, 41, 23]) if ragged else None
    if ragged:
        jout = jax.vmap(lambda a, b, s: jsysid.lti_regression(a, b, 1e-7, s))(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(steps))
    else:
        jout = jax.vmap(lambda a, b: jsysid.lti_regression(a, b, 1e-7))(
            jnp.asarray(x), jnp.asarray(u))
    tout = tsysid.lti_regression(
        torch.from_numpy(x), torch.from_numpy(u), 1e-7,
        None if steps is None else torch.from_numpy(steps))
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-9)


def test_lti_step_reproduces_golden():
    g = np.load(GOLDEN)
    A = torch.from_numpy(g["A_lti"])[None]
    B = torch.from_numpy(g["B_lti"])[None]
    step, st = tmpc.make_lti_mpc(tc.MPCConfig(), A, B,
                                 tc.SolverConfig(max_iter=500),
                                 dtype=torch.float64)
    x0 = torch.tensor([[0.5, 0, 0, 0, 0, 0]], dtype=torch.float64)
    st1, u0 = step(st, x0)
    np.testing.assert_allclose(u0[0].numpy(), g["mpc_u0"], atol=1e-9)
    np.testing.assert_allclose(st1.x_pred[0].numpy(), g["mpc_x_pred"],
                               atol=1e-9)


def _compare_state(t, j, atol):
    jd = _asdict(j)
    for name in tmpc.MPCState._fields:
        tv, jv = getattr(t, name), jd[name]
        if name == "fac":
            for f in tv._fields:
                np.testing.assert_allclose(getattr(tv, f).numpy(), jv[f],
                                           atol=atol, err_msg=f"fac.{f}")
        else:
            np.testing.assert_allclose(tv.numpy(), jv, atol=atol,
                                       err_msg=name)


def test_ltv_steps_match_reference():
    Bsz, N, n_steps = 2, 6, 5
    x, u = _trajectories(Bsz, 80, seed=3)
    lkw = dict(N=N, model_pts=128)
    jl, tl = jc.LMPCConfig(**lkw), tc.LMPCConfig(**lkw)
    jm = dataclasses.replace(jc.MPCConfig(), N=N, time_varying=True)
    tm = dataclasses.replace(tc.MPCConfig(), N=N, time_varying=True)
    jt = jtrack.make_track(dtype=jnp.float64)
    tt = ttrack.make_track(dtype=torch.float64, device="cpu")
    jstore = jax.vmap(lambda a, b: jsysid.add_lap(
        jsysid.make_lap_store(1, 128, dtype=jnp.float64), a, b,
        jnp.int32(80)))(jnp.asarray(x), jnp.asarray(u))
    tstore = tsysid.add_lap(
        tsysid.make_lap_store(Bsz, 1, 128, dtype=torch.float64, device="cpu"),
        torch.from_numpy(x), torch.from_numpy(u), torch.full((Bsz,), 80))
    jsc, tsc = jc.SolverConfig(), tc.SolverConfig()
    jstep = jax.jit(jax.vmap(
        lambda st, s, xx: jmpc.make_ltv_mpc(jm, st, jt, jl, jsc, 0.1,
                                            dtype=jnp.float64)[0](s, xx, None)))
    jstate = jax.vmap(lambda st: jmpc.make_ltv_mpc(
        jm, st, jt, jl, jsc, 0.1, dtype=jnp.float64)[1])(jstore)
    tstep, tstate = tmpc.make_ltv_mpc(tm, tstore, tt, tl, tsc, 0.1,
                                      dtype=torch.float64)
    _compare_state(tstate, jstate, 0.0)
    assert tstate.fac.kinv.shape == (Bsz, 0, 0)   # structured: no Kinv kept
    # the carried-across state equals the port's own initial state
    _compare_state(convert.from_jax(tmpc.MPCState, _asdict(jstate),
                                    device="cpu"), jstate, 0.0)
    plant = jdyn.PlantState(x=jnp.asarray(x[:, 2]), x_glob=jnp.zeros((Bsz, 6)))
    sim = jc.SimConfig(noise=False)
    for _ in range(n_steps):
        jstate, ju = jstep(jstore, jstate, plant.x)
        tstate, tu = tstep(tstate, torch.from_numpy(np.array(plant.x)))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-8)
        _compare_state(tstate, jstate, 1e-8)
        plant = jax.vmap(lambda p, uu: jdyn.plant_step(
            p, uu, jc.VehicleParams(), jt, sim, None))(plant, ju)
    assert bool(np.asarray(jstate.feasible).all())
