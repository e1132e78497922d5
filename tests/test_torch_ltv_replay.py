"""Scenario 168 of the ``config3_ltv`` preset (seed 0, batch 256), replayed
on the CPU through the port and through the JAX package (``ROADMAP.md`` C3).

On the card this scenario misses the LTV stage criteria (final s > 14.0)
under every solver. ``fixtures/c3_config3_ltv_seed0_row168.npz`` holds its
inputs as the card made them (``python -m
racinglmpc_tpu_torch.runtime.dump_scenario``): the PID-stage lap that fills
the LTV sys-ID store and the LTV stage's 450 plant draws, with the card's
own LTV trajectory. Both packages replay them at batch 1 with the draws
injected (the JAX plant steps noise-free and adds the same clipped noise):

- on the kernel path that the card runs (``throughput()``; the port's ADMM
  kernel through its plain version, the reference's Pallas kernel in
  interpret mode), float32: both miss, as the card does;
- on the plain path in float64 the port equals the reference to 1e-6 over
  all 450 steps, and both meet the criteria.

So the miss is the reference's own behaviour on this scenario's draws (an
observation, not a port fault): the car stalls under the fixed-rho kernel
path's float32 solutions.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from racinglmpc_tpu.controllers import mpc as jmpc
from racinglmpc_tpu.models import dynamics as jdyn
from racinglmpc_tpu.models import sysid as jsysid
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch.controllers import mpc as tmpc
from racinglmpc_tpu_torch.models import sysid as tsysid
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.runtime import experiment as texp
from racinglmpc_tpu_torch.runtime import loop as tloop
from racinglmpc_tpu_torch.utils import config as tc

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "fixtures", "c3_config3_ltv_seed0_row168.npz")


def _meets_criteria(x):
    """The LTV stage criteria of ``chip_smoke.py`` (the reference's
    closed-loop stage test): finite, |ey| < 0.5, final s > 14.0."""
    return bool(np.isfinite(x).all() and (np.abs(x[:, 5]) < 0.5).all()
                and x[-1, 4] > 14.0)


def _port(z, dtype, kernel_path):
    cfg = texp.ExperimentConfig(stage_steps=450)
    solver = dataclasses.replace(tc.SolverConfig.throughput(),
                                 pallas_interpret=kernel_path)
    sim = dataclasses.replace(cfg.sim, use_pallas_rollout=True)
    trk = ttrack.make_track(dtype=dtype, device="cpu")
    store = tsysid.add_lap(
        tsysid.make_lap_store(1, 1, cfg.lmpc.model_pts, dtype=dtype,
                              device="cpu"),
        torch.from_numpy(z["pid_x"])[None], torch.from_numpy(z["pid_u"])[None],
        torch.tensor([int(z["pid_steps"])]))
    mc = dataclasses.replace(cfg.mpc, N=cfg.N, vt=cfg.vt, time_varying=True)
    step, st = tmpc.make_ltv_mpc(mc, store, trk, cfg.lmpc, solver, sim.dt,
                                 dtype=dtype)
    draws = torch.from_numpy(z["ltv_draws"]).to(dtype)
    res = tloop.run_lap(step, st, texp.initial_plant(1, dtype, "cpu"),
                        trk=trk, vp=tc.VehicleParams(), sim_cfg=sim,
                        max_steps=draws.shape[0], multi_lap=True,
                        noise=lambda t: (None, draws[t][None]))
    return res.x[0].numpy()


def _reference(z, dtype, kernel_path):
    solver = dataclasses.replace(jc.SolverConfig.throughput(),
                                 pallas_interpret=kernel_path)
    lcfg = jc.LMPCConfig()
    mc = dataclasses.replace(jc.MPCConfig(), N=14, vt=0.8, time_varying=True)
    trk = jtrack.make_track(dtype=dtype)
    store = jsysid.add_lap(
        jsysid.make_lap_store(1, lcfg.model_pts, dtype=dtype),
        jnp.asarray(z["pid_x"], dtype), jnp.asarray(z["pid_u"], dtype),
        jnp.int32(int(z["pid_steps"])))
    step, st = jmpc.make_ltv_mpc(mc, store, trk, lcfg, solver, 0.1,
                                 dtype=dtype)
    sim = jc.SimConfig()
    sig = jnp.asarray(sim.noise_sigma, dtype)

    @jax.jit
    def one(st, plant, draw):
        st, u = step(st, plant.x, None)
        p = jdyn.plant_step(plant, u, jc.VehicleParams(), trk, sim, None)
        noise = sim.noise_gain * jnp.clip(draw * sig, -sim.noise_clip,
                                          sim.noise_clip)
        return st, jdyn.PlantState(x=p.x.at[:3].add(noise), x_glob=p.x_glob)

    x0 = jnp.asarray([0.5, 0, 0, 0, 0, 0], dtype)
    plant = jdyn.PlantState(x=x0, x_glob=x0)
    xs = []
    for draw in z["ltv_draws"]:
        xs.append(np.asarray(plant.x))
        st, plant = one(st, plant, jnp.asarray(draw, dtype))
    return np.stack(xs)


def test_fixture_is_the_card_miss():
    z = np.load(FIXTURE)
    assert (str(z["preset"]), int(z["seed"]), int(z["row"])) == (
        "config3_ltv", 0, 168)
    assert z["ltv_draws"].shape == (450, 3) and int(z["pid_steps"]) == 450
    assert not bool(z["card_ok"]) and not _meets_criteria(z["ltv_x"])
    assert 168 in z["misses"].tolist()


def test_kernel_path_float32_misses_in_both_packages():
    z = np.load(FIXTURE)
    xp = _port(z, torch.float32, kernel_path=True)
    xj = _reference(z, jnp.float32, kernel_path=True)
    assert np.isfinite(xp).all() and np.isfinite(xj).all()
    # both stall short of s = 14 (card 9.88, reference 9.92, port 11.30)
    assert not _meets_criteria(xp), xp[-1, 4]
    assert not _meets_criteria(xj), xj[-1, 4]
    assert xp[-1, 4] < 12.0 and xj[-1, 4] < 12.0


def test_plain_path_float64_equals_reference_and_meets_criteria():
    z = np.load(FIXTURE)
    xp = _port(z, torch.float64, kernel_path=False)
    xj = _reference(z, jnp.float64, kernel_path=False)
    np.testing.assert_allclose(xp, xj, atol=1e-6)
    assert _meets_criteria(xp) and _meets_criteria(xj)
