"""Port LMPC controller against the JAX reference in f64.

The reference builds and seeds the controller state; ``convert.py``
carries it across; both then run the same closed loop (the reference's
plant states feed both controllers) and must apply the same inputs, with
equal accept / reject / iteration records. A short 2-lap
``run_experiment("pid,lmpc")`` with noise off must give equal lap steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.controllers import lmpc as jlmpc
from racinglmpc_tpu.models import dynamics as jdyn
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.runtime import experiment as jexp
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch import convert
from racinglmpc_tpu_torch.controllers import lmpc as tlmpc
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.runtime import experiment as texp
from racinglmpc_tpu_torch.utils import config as tc

torch.set_num_threads(1)
LKW = dict(N=6, num_ss_points=12, max_laps=6, max_pts=256, model_pts=128)


def _asdict(tree):
    if hasattr(tree, "_asdict"):
        return {k: _asdict(v) for k, v in tree._asdict().items()}
    return np.asarray(jax.device_get(tree))


def _seed_lap(steps=100, seed=7):
    rng = np.random.default_rng(seed)
    x = np.zeros((steps, 6))
    x[:, 0] = 1.0 + 0.05 * rng.standard_normal(steps)
    x[:, 1] = 0.02 * rng.standard_normal(steps)
    x[:, 2] = 0.1 * rng.standard_normal(steps)
    x[:, 4] = np.linspace(0, 19.3, steps)
    x[:, 5] = 0.05 * rng.standard_normal(steps)
    u = np.stack([0.1 * rng.standard_normal(steps),
                  0.2 + 0.1 * rng.standard_normal(steps)], 1)
    return x, u


def _jax_state(cfg, scfg, B):
    x, u = _seed_lap()
    L = jtrack.make_track(dtype=jnp.float64).total_len

    def one(_):
        st = jlmpc.init_lmpc_state(cfg, dtype=jnp.float64, solver=scfg)
        for _ in range(cfg.num_ss_it):
            st = jlmpc.lmpc_add_trajectory(
                st, cfg, jnp.asarray(x), jnp.asarray(u), jnp.asarray(x),
                jnp.int32(x.shape[0]), L)
        return st

    return jax.vmap(one)(jnp.arange(B)), x


@pytest.mark.parametrize("preset", ["throughput"])
def test_lmpc_steps_match_reference_f64(preset):
    B, n_steps = 2, 5
    jcfg, tcfg = jc.LMPCConfig(**LKW), tc.LMPCConfig(**LKW)
    jscfg = getattr(jc.SolverConfig, preset)()
    tscfg = getattr(tc.SolverConfig, preset)()
    jt = jtrack.make_track(dtype=jnp.float64)
    tt = ttrack.make_track(dtype=torch.float64, device="cpu")
    jstate, x = _jax_state(jcfg, jscfg, B)
    tstate = convert.from_jax(tlmpc.LMPCState, _asdict(jstate), device="cpu")
    jstep = jax.jit(jax.vmap(jlmpc.make_lmpc(jcfg, jt, jscfg, 0.1,
                                             dtype=jnp.float64),
                             in_axes=(0, 0, None)))
    tctrl = tlmpc.make_lmpc(tcfg, tt, tscfg, 0.1, dtype=torch.float64)
    plant = jdyn.PlantState(x=jnp.asarray(np.stack([x[1], x[1] + 0.01])),
                            x_glob=jnp.zeros((B, 6)))
    sim = jc.SimConfig(noise=False)
    for _ in range(n_steps):
        jstate, ju = jstep(jstate, plant.x, None)
        tstate, tu = tctrl.step(tstate, torch.from_numpy(np.array(plant.x)))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-7)
        for name in ("rejects", "iters", "feasible", "time_step"):
            np.testing.assert_array_equal(
                getattr(tstate, name).numpy(),
                np.asarray(getattr(jstate, name)), err_msg=name)
        np.testing.assert_allclose(tstate.zt.numpy(), np.asarray(jstate.zt),
                                   atol=1e-7)
        np.testing.assert_array_equal(tstate.ext.n.numpy(),
                                      np.asarray(jstate.ext.n))
        plant = jax.vmap(lambda p, uu: jdyn.plant_step(
            p, uu, jc.VehicleParams(), jt, sim, None))(plant, ju)
    assert int(np.asarray(jstate.iters).max()) > 0


def test_add_trajectory_flush_equal():
    """lmpc_add_trajectory after some addPoint appends (flush + store)."""
    jcfg, tcfg = jc.LMPCConfig(**LKW), tc.LMPCConfig(**LKW)
    jstate, x = _jax_state(jcfg, jc.SolverConfig.throughput(), 1)
    L = jtrack.make_track(dtype=jnp.float64).total_len
    jext = jstate.ext
    for k in range(3):
        jext = jax.vmap(lambda ss, e: jlmpc.add_point(
            ss, e, jnp.asarray(x[k]), jnp.asarray([0.1, 0.2]), L))(
            jstate.ss, jext)
    jstate = jstate._replace(ext=jext)
    tstate = convert.from_jax(tlmpc.LMPCState, _asdict(jstate), device="cpu")
    xl, ul = x[:40], np.full((40, 2), 0.1)
    j2 = jax.vmap(lambda st: jlmpc.lmpc_add_trajectory(
        st, jcfg, jnp.asarray(xl), jnp.asarray(ul), jnp.asarray(xl),
        jnp.int32(40), L))(jstate)
    t2 = tlmpc.lmpc_add_trajectory(
        tstate, tcfg, torch.tensor(xl)[None], torch.tensor(ul)[None],
        torch.tensor(xl)[None], torch.tensor([40]),
        torch.tensor(float(L), dtype=torch.float64))
    for name in ("x", "u", "qfun", "n_pts", "lap_time", "n_laps"):
        np.testing.assert_array_equal(getattr(t2.ss, name).numpy(),
                                      np.asarray(getattr(j2.ss, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t2.store.steps.numpy(),
                                  np.asarray(j2.store.steps))


def _oval(dtype_j, dtype_t):
    """A short oval (two straights, two half circles) keeps laps short."""
    spec = np.array([[1.0, 0.0], [np.pi * 0.8, 0.8], [1.0, 0.0],
                     [np.pi * 0.8, 0.8]])
    return (jtrack.make_track(spec, dtype=dtype_j),
            ttrack.make_track(spec, dtype=dtype_t, device="cpu"))


def test_run_experiment_two_laps_match_reference():
    jt, tt = _oval(jnp.float64, torch.float64)
    common = dict(N=6, stage_steps=120, n_lmpc_laps=2, lap_max_steps=60,
                  lap_chunk=30, pid_noise=False)
    jcfg = jexp.ExperimentConfig(
        sim=jc.SimConfig(noise=False), solver=jc.SolverConfig.throughput(),
        lmpc=jc.LMPCConfig(**LKW), **common)
    tcfg = texp.ExperimentConfig(
        sim=tc.SimConfig(noise=False), solver=tc.SolverConfig.throughput(),
        lmpc=tc.LMPCConfig(**LKW), **common)
    jres = jexp.run_experiment(jax.random.PRNGKey(0), jcfg, batch=2,
                               trk=jt, stages="pid,lmpc", dtype=jnp.float64)
    tres = texp.run_experiment(tcfg, batch=2, trk=tt, stages="pid,lmpc",
                               dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tres.lap_steps, jres.lap_steps)
    np.testing.assert_allclose(tres.lap_times, jres.lap_times, atol=1e-9)
    for name in ("rejects", "iters", "time_step"):
        np.testing.assert_array_equal(
            getattr(tres.lmpc_state, name).numpy(),
            np.asarray(getattr(jres.lmpc_state, name)), err_msg=name)
    # the seeded PID laps are identical; the closed-loop rows are checked
    # through the lap steps / times and the controller records above
    np.testing.assert_allclose(tres.lmpc_state.ss.x[:, :3].numpy(),
                               np.asarray(jres.lmpc_state.ss.x)[:, :3],
                               atol=1e-7)
