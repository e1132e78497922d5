"""Port PID + lap runner against the JAX reference (f64): a noise-off lap
(step count, x, u and the wrapped crossing state), a lap with the
reference's own noise draws injected, the fixed-length PID stage of
run_experiment, and the chunked done0/step0 resume against one long run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.controllers.pid import make_pid_controller as jpid
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.models.dynamics import PlantState as JPS
from racinglmpc_tpu.runtime import experiment as jexp
from racinglmpc_tpu.runtime.loop import run_lap as jrun_lap
from racinglmpc_tpu.runtime.loop import run_lap_batch as jrun_lap_batch
from racinglmpc_tpu.utils.config import SimConfig as JSim
from racinglmpc_tpu.utils.config import VehicleParams as JVP
from racinglmpc_tpu_torch.controllers.pid import make_pid_controller
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.parallel import make_mesh
from racinglmpc_tpu_torch.runtime import experiment as texp
from racinglmpc_tpu_torch.runtime.loop import run_lap
from racinglmpc_tpu_torch.utils.config import SimConfig, VehicleParams

torch.set_num_threads(1)
X0 = np.asarray([0.5, 0, 0, 0, 0, 0], np.float64)


@pytest.fixture(scope="module")
def trks():
    return (jtrack.make_track(dtype=jnp.float64),
            ttrack.make_track(dtype=torch.float64, device="cpu"))


def _tplant(x0s):
    x = torch.tensor(np.asarray(x0s))
    xg = x.clone()
    xg[:, 3:] = 0.0
    return PlantState(x=x, x_glob=xg)


def test_noise_off_lap_matches_reference(trks):
    jt, tt = trks
    step, cs0 = jpid(vt=0.8, noise=False)
    ref = jrun_lap(step, cs0, JPS(x=jnp.asarray(X0), x_glob=jnp.asarray(
        X0).at[3:].set(0.0)), jax.random.PRNGKey(0), trk=jt, vp=JVP(),
        sim_cfg=JSim(noise=False), max_steps=420)
    tstep, tcs0 = make_pid_controller(vt=0.8, noise=False)
    out = run_lap(tstep, tcs0, _tplant([X0]), trk=tt, vp=VehicleParams(),
                  sim_cfg=SimConfig(noise=False), max_steps=420)
    steps = int(ref.steps)
    assert int(out.steps[0]) == steps and 250 <= steps <= 400
    np.testing.assert_allclose(out.x[0, :steps].numpy(),
                               np.asarray(ref.x[:steps]), atol=1e-7)
    np.testing.assert_allclose(out.u[0, :steps].numpy(),
                               np.asarray(ref.u[:steps]), atol=1e-7)
    np.testing.assert_allclose(out.x_final.x[0].numpy(),
                               np.asarray(ref.x_final.x), atol=1e-7)
    np.testing.assert_array_equal(out.mask[0].numpy(), np.asarray(ref.mask))
    assert 0.0 <= float(out.x_final.x[0, 4]) < float(jt.total_len)


def _jax_draws(keys):
    """The reference loop's per-step draws: fold_in(key, t) -> (ctrl, plant)
    -> ctrl split into the two PID normals."""
    def draw(t):
        def one(k):
            kc, kp = jax.random.split(jax.random.fold_in(k, t))
            k1, k2 = jax.random.split(kc)
            c = jnp.stack([jax.random.normal(k1, dtype=jnp.float64),
                           jax.random.normal(k2, dtype=jnp.float64)])
            return c, jax.random.normal(kp, (3,), dtype=jnp.float64)
        c, p = jax.vmap(one)(keys)
        return torch.tensor(np.array(c)), torch.tensor(np.array(p))
    return draw


@pytest.mark.parametrize("rollout_kernel", [False, True])
def test_injected_noise_lap_matches_reference(trks, rollout_kernel):
    jt, tt = trks
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    x0 = np.zeros((3, 6))
    x0[:, 0] = [0.4, 0.5, 0.6]
    x0[:, 4] = float(jt.total_len) - 2.0 + np.array([0.0, 0.3, 0.6])
    step, _ = jpid(vt=0.8, noise=True)
    ref = jrun_lap_batch(step, (), JPS(x=jnp.asarray(x0), x_glob=jnp.asarray(
        x0)), keys, trk=jt, vp=JVP(), sim_cfg=JSim(), max_steps=60)
    assert bool(np.all(np.asarray(ref.done)))
    tstep, _ = make_pid_controller(vt=0.8, noise=True)
    out = run_lap(tstep, (), PlantState(torch.tensor(x0), torch.tensor(x0)),
                  trk=tt, vp=VehicleParams(),
                  sim_cfg=SimConfig(use_pallas_rollout=rollout_kernel),
                  max_steps=60, noise=_jax_draws(keys))
    np.testing.assert_array_equal(out.steps.numpy(), np.asarray(ref.steps))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-7)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), atol=1e-7)


def test_chunked_resume_equals_one_run(trks):
    _, tt = trks
    tstep, _ = make_pid_controller(vt=0.8, noise=False)
    x0 = np.zeros((2, 6))
    x0[:, 0] = [0.5, 0.7]
    x0[:, 4] = float(tt.total_len) - 2.5
    kw = dict(trk=tt, vp=VehicleParams(), sim_cfg=SimConfig(noise=False))
    one = run_lap(tstep, (), PlantState(torch.tensor(x0), torch.tensor(x0)),
                  max_steps=80, **kw)
    runner = (lambda st, plant, done, step0: run_lap(
        tstep, st, plant, max_steps=20, done0=done, step0=step0, **kw))
    sr, _ = texp.run_lap_chunked(runner, (), PlantState(
        torch.tensor(x0), torch.tensor(x0)), 80, 20, 80)
    assert bool(one.done.all()) and int(one.steps.max()) < 60
    np.testing.assert_array_equal(sr.steps.numpy(), one.steps.numpy())
    np.testing.assert_array_equal(sr.mask.numpy(), one.mask.numpy())
    m = one.mask.numpy()
    np.testing.assert_array_equal(sr.x.numpy()[m], one.x.numpy()[m])
    np.testing.assert_array_equal(sr.plant_final.x.numpy(),
                                  one.plant_final.x.numpy())


def test_pid_stage_matches_reference():
    cfg_kw = dict(stage_steps=120, pid_noise=False)
    jres = jexp.run_experiment(
        jax.random.PRNGKey(0), jexp.ExperimentConfig(sim=JSim(noise=False),
                                                     **cfg_kw),
        batch=2, stages="pid", dtype=jnp.float64)
    tres = texp.run_experiment(
        texp.ExperimentConfig(sim=SimConfig(noise=False), **cfg_kw),
        batch=2, stages="pid", dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tres.pid.steps.numpy(),
                                  np.asarray(jres.pid.steps))
    np.testing.assert_allclose(tres.pid.x.numpy(), np.asarray(jres.pid.x),
                               atol=1e-7)
    np.testing.assert_allclose(tres.pid.x_glob.numpy(),
                               np.asarray(jres.pid.x_glob), atol=1e-7)
    with pytest.raises(TypeError, match="ScenarioMesh"):
        texp.run_experiment(stages="pid", device="cpu", mesh=object())
    with make_mesh("cpu") as mesh:      # a one-rank gloo mesh runs alike
        mres = texp.run_experiment(
            texp.ExperimentConfig(sim=SimConfig(noise=False), **cfg_kw),
            batch=2, stages="pid", dtype=torch.float64, mesh=mesh)
    np.testing.assert_array_equal(mres.pid.x.numpy(), tres.pid.x.numpy())
    np.testing.assert_array_equal(mres.pid.steps.numpy(),
                                  tres.pid.steps.numpy())
