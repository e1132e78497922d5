"""Six LMPC laps in float64, the port against the JAX reference, in the
configuration of ``tests/test_ref_parity.py`` (``ROADMAP.md`` item 12).

Both packages run the reference's LMPC setting (``LMPCConfig()``: N = 14,
12 safe-set points from each of 4 laps; ``SolverConfig.parity()``;
float64) from x0 = [0.5, 0, 0, 0, 0, 0], seeded with the same PID lap: the
one ``tests/test_ref_parity.py`` drives on the float64 NumPy plant
(``tests/oracles/ref_plant.py``), stored 4 times. Each package then drives
6 laps on its own plant with plant noise on. The noise is the reference's:
its lap runner draws each step's plant noise from ``fold_in(key, t)``, and
the port's lap runner gets the same standard-normal draws through its
``noise`` callable. After each lap both store it, cut to its steps and
zero-padded alike, and start the next lap from the crossing state.

Criteria (those of ``test_ref_parity.py::test_lmpc_lap_times_within_1pct``):
on every lap the two lap step counts within max(2 steps, 1%), and the
cumulative count within 1%. In float64 the two controllers follow each
other: the solver's float32 products are not on this path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.controllers import lmpc as jlmpc
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.models.dynamics import PlantState as JPlant
from racinglmpc_tpu.runtime import loop as jloop
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch.controllers import lmpc as tlmpc
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.runtime import experiment as texp
from racinglmpc_tpu_torch.runtime import loop as tloop
from racinglmpc_tpu_torch.utils import config as tc
from tests.oracles import ref_plant

torch.set_num_threads(1)
X0 = np.array([0.5, 0, 0, 0, 0, 0.0])
N_LAPS = 6
MAX_STEPS = 1000
CHUNK = 100


def _seed_lap(trk):
    """The PID seed lap of ``tests/test_ref_parity.py`` (``shared``):
    (x, u, x_glob) on the float64 NumPy plant, PID exploration and plant
    noise from ``default_rng(0)``."""
    curv = ref_plant.np_curvature_fn(trk)
    L = float(trk.total_len)
    rng = np.random.default_rng(0)
    x, g = X0.copy(), X0.copy()
    xs, us, gs = [], [], []
    for _ in range(420):
        n_st = np.clip(rng.standard_normal() * 0.25, -0.9, 0.9)
        n_a = np.clip(rng.standard_normal() * 0.10, -0.2, 0.2)
        u = np.array([-0.6 * x[5] - 0.9 * x[3] + n_st,
                      1.5 * (0.8 - x[0]) + n_a])
        xs.append(x.copy())
        us.append(u.copy())
        gs.append(g.copy())
        pn = np.clip(rng.standard_normal(3) * np.array([0.01, 0.01, 0.005]),
                     -0.05, 0.05)
        x, g = ref_plant.plant_step(x, g, u, curv, noise=pn)
        if x[4] > L:
            break
    return np.array(xs), np.array(us), np.array(gs)


def _cut(a, steps):
    """The lap's first ``steps`` rows, zero-padded to ``MAX_STEPS``."""
    out = np.zeros((MAX_STEPS,) + a.shape[1:])
    out[:steps] = a[:steps]
    return out


def _lap_keys():
    return [jax.random.fold_in(jax.random.PRNGKey(0), lap)
            for lap in range(N_LAPS)]


def _reference(seed):
    trk = jtrack.make_track(dtype=jnp.float64)
    L = trk.total_len
    lcfg, solver = jc.LMPCConfig(), jc.SolverConfig.parity()
    step = jlmpc.make_lmpc(lcfg, trk, solver, 0.1, dtype=jnp.float64)
    add = jax.jit(lambda st, x, u, xg, n: jlmpc.lmpc_add_trajectory(
        st, lcfg, x, u, xg, n, L))
    run = jax.jit(lambda st, pl, key: jloop.run_lap(
        step, st, pl, key, trk=trk, vp=jc.VehicleParams(),
        sim_cfg=jc.SimConfig(), max_steps=MAX_STEPS))
    xs, us, gs = seed
    state = jlmpc.init_lmpc_state(lcfg, dtype=jnp.float64, solver=solver)
    for _ in range(lcfg.num_ss_it):
        state = add(state, _cut(xs, len(xs)), _cut(us, len(xs)),
                    _cut(gs, len(xs)), jnp.int32(len(xs)))
    x0 = jnp.asarray(X0)
    plant, steps = JPlant(x=x0, x_glob=x0), []
    for key in _lap_keys():
        res = run(state, plant, key)
        n = int(res.steps)
        steps.append(n)
        state = add(res.ctrl_state, *(_cut(np.asarray(a), n)
                                      for a in (res.x, res.u, res.x_glob)),
                    jnp.int32(n))
        plant = res.x_final
    return np.array(steps)


def _plant_draws(key):
    """The standard-normal plant draws of the reference's lap runner:
    step t's plant key is the second half of ``split(fold_in(key, t))``."""
    return np.asarray(jax.vmap(lambda t: jax.random.normal(
        jax.random.split(jax.random.fold_in(key, t))[1], (3,),
        jnp.float64))(jnp.arange(MAX_STEPS)))


def _port(seed):
    trk = ttrack.make_track(dtype=torch.float64, device="cpu")
    L = trk.total_len
    lcfg, solver = tc.LMPCConfig(), tc.SolverConfig.parity()
    sim, vp = tc.SimConfig(), tc.VehicleParams()
    ctrl = tlmpc.make_lmpc(lcfg, trk, solver, 0.1, dtype=torch.float64)
    t = lambda a: torch.from_numpy(a)[None]  # noqa: E731
    xs, us, gs = seed
    state = tlmpc.init_lmpc_state(lcfg, 1, dtype=torch.float64,
                                  solver=solver, device="cpu")
    for _ in range(lcfg.num_ss_it):
        state = tlmpc.lmpc_add_trajectory(
            state, lcfg, t(_cut(xs, len(xs))), t(_cut(us, len(xs))),
            t(_cut(gs, len(xs))), torch.tensor([len(xs)]), L)
    plant = texp.initial_plant(1, torch.float64, "cpu")
    steps = []
    for key in _lap_keys():
        draws = torch.from_numpy(np.array(_plant_draws(key)))

        def runner(st, pl, done, step0, draws=draws):
            return tloop.run_lap(
                ctrl.step, st, pl, trk=trk, vp=vp, sim_cfg=sim,
                max_steps=CHUNK, done0=done, step0=step0,
                noise=lambda k: (None, draws[k][None]))

        res, state = texp.run_lap_chunked(runner, state, plant, MAX_STEPS,
                                          CHUNK, MAX_STEPS)
        n = int(res.steps[0])
        steps.append(n)
        state = tlmpc.lmpc_add_trajectory(
            state, lcfg, *(t(_cut(a[0].numpy(), n))
                           for a in (res.x, res.u, res.x_glob)),
            torch.tensor([n]), L)
        shift = torch.zeros_like(res.plant_final.x)
        shift[:, 4] = L
        plant = res.plant_final._replace(x=res.plant_final.x - shift)
    return np.array(steps)


@pytest.mark.slow
def test_lmpc_six_laps_float64_within_1pct_of_reference():
    seed = _seed_lap(jtrack.make_track(dtype=jnp.float64))
    ref, got = _reference(seed), _port(seed)
    assert (ref < MAX_STEPS).all() and (got < MAX_STEPS).all(), (ref, got)
    tol = np.maximum(2, np.ceil(0.01 * ref))
    assert (np.abs(got - ref) <= tol).all(), f"lap steps ref={ref} port={got}"
    total_rel = abs(int(got.sum()) - int(ref.sum())) / ref.sum()
    assert total_rel <= 0.01, f"cumulative lap-step delta {total_rel:.3%}"
