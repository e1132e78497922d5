"""Port track + plant against the JAX reference (f64), and the rollout
kernel's plain version against the Pallas kernel (interpret mode, f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.models import dynamics as jdyn
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.ops import pallas_rollout
from racinglmpc_tpu.utils.config import SimConfig as JSim
from racinglmpc_tpu.utils.config import VehicleParams as JVP
from racinglmpc_tpu_torch.models import dynamics as tdyn
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.ops import cuda_rollout
from racinglmpc_tpu_torch.utils.config import SimConfig, VehicleParams

torch.set_num_threads(1)
CPU = "cpu"


@pytest.fixture(scope="module")
def tracks():
    return (jtrack.make_track(dtype=jnp.float64),
            ttrack.make_track(dtype=torch.float64, device=CPU))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def test_track_table_equal(tracks):
    jt, tt = tracks
    for name in jtrack.Track._fields:
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)), atol=1e-12)


def test_track_queries_match(tracks):
    jt, tt = tracks
    L = float(jt.total_len)
    rng = np.random.default_rng(0)
    # across the finish line and exactly on segment starts
    s = np.concatenate([rng.uniform(-0.5, 2 * L, 64), np.asarray(jt.s0),
                        [L, L - 1e-9, L + 1e-9]])
    ey = rng.uniform(-0.4, 0.4, s.shape[0])
    epsi = rng.uniform(-0.3, 0.3, s.shape[0])
    js, jey, jepsi = map(jnp.asarray, (s, ey, epsi))
    ts, tey, tepsi = map(_t, (s, ey, epsi))
    np.testing.assert_allclose(ttrack.wrap_s(tt, ts).numpy(),
                               np.asarray(jtrack.wrap_s(jt, js)), atol=1e-12)
    np.testing.assert_allclose(ttrack.curvature(tt, ts).numpy(),
                               np.asarray(jtrack.curvature(jt, js)), atol=1e-12)
    np.testing.assert_allclose(
        ttrack.tangent_angle(tt, ts, tepsi).numpy(),
        np.asarray(jtrack.tangent_angle(jt, js, jepsi)), atol=1e-12)
    X, Y = ttrack.global_position(tt, ts, tey)
    jX, jY = jtrack.global_position(jt, js, jey)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), atol=1e-12)
    np.testing.assert_allclose(Y.numpy(), np.asarray(jY), atol=1e-12)
    # round trip through local_position, per point as the reference is
    psi = ttrack.tangent_angle(tt, ts, tepsi)
    out = ttrack.local_position(tt, X, Y, psi)
    ref = jax.vmap(lambda x, y, p: jtrack.local_position(jt, x, y, p))(
        jX, jY, jnp.asarray(psi.numpy()))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
    # off track -> invalid + sentinel
    s_o, ey_o, _, ok = ttrack.local_position(tt, _t(100.0), _t(100.0), _t(0.0))
    assert not bool(ok) and float(s_o) == 10000.0


def _states(B, seed, L):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.1, size=(B, 6))
    x[:, 0] += 0.8
    x[:, 4] = rng.uniform(0, L + 0.8, B)       # some past the line
    xg = x.copy()
    xg[:, 3:] = rng.normal(scale=0.5, size=(B, 3))
    u = rng.normal(scale=0.2, size=(B, 2))
    return x, xg, u


def test_plant_step_matches_f64_with_injected_noise(tracks):
    jt, tt = tracks
    B = 6
    x, xg, u = _states(B, 1, float(jt.total_len))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jcfg, tcfg = JSim(), SimConfig()
    ref = jax.vmap(lambda xi, xgi, ui, k: jdyn.plant_step(
        jdyn.PlantState(xi, xgi), ui, JVP(), jt, jcfg, k))(
        jnp.asarray(x), jnp.asarray(xg), jnp.asarray(u), keys)
    draws = jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float64))(keys)
    out = tdyn.plant_step(tdyn.PlantState(_t(x), _t(xg)), _t(u),
                          VehicleParams(), tt, tcfg, noise=_t(draws))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-12)
    np.testing.assert_allclose(out.x_glob.numpy(), np.asarray(ref.x_glob),
                               atol=1e-12)
    # noise off: no draws applied
    quiet = tdyn.plant_step(tdyn.PlantState(_t(x), _t(xg)), _t(u),
                            VehicleParams(), tt, SimConfig(noise=False),
                            noise=_t(draws))
    ref0 = jax.vmap(lambda xi, xgi, ui: jdyn.plant_step(
        jdyn.PlantState(xi, xgi), ui, JVP(), jt, JSim(noise=False), None))(
        jnp.asarray(x), jnp.asarray(xg), jnp.asarray(u))
    np.testing.assert_allclose(quiet.x.numpy(), np.asarray(ref0.x), atol=1e-12)


@pytest.mark.parametrize("substeps", [100, 50])
def test_rollout_plain_matches_pallas_interpret(substeps):
    """B3's plain version (f32) against the Pallas kernel and the XLA plant,
    including states past the finish line (the s-wrap)."""
    B = 5
    jt32 = jtrack.make_track(dtype=jnp.float32)
    tt32 = ttrack.make_track(dtype=torch.float32, device=CPU)
    x, xg, u = _states(B, 4, float(jt32.total_len))
    x, xg, u = (a.astype(np.float32) for a in (x, xg, u))
    cfg = SimConfig(noise=False, substeps=substeps)
    jcfg = JSim(noise=False, substeps=substeps)
    ox, oxg = cuda_rollout.plant_step_batch(
        torch.from_numpy(x), torch.from_numpy(xg), torch.from_numpy(u),
        VehicleParams(), tt32, cfg)
    px, pxg = pallas_rollout.plant_step_batch(
        jnp.asarray(x), jnp.asarray(xg), jnp.asarray(u), JVP(), jt32, jcfg,
        interpret=True)
    np.testing.assert_allclose(ox.numpy(), np.asarray(px), atol=1e-4)
    np.testing.assert_allclose(oxg.numpy(), np.asarray(pxg), atol=1e-4)
    ref = jax.vmap(lambda xi, xgi, ui: jdyn.plant_step(
        jdyn.PlantState(xi, xgi), ui, JVP(), jt32, jcfg, None))(
        jnp.asarray(x), jnp.asarray(xg), jnp.asarray(u))
    np.testing.assert_allclose(ox.numpy(), np.asarray(ref.x), atol=1e-5)
    np.testing.assert_allclose(oxg.numpy(), np.asarray(ref.x_glob), atol=1e-5)
    assert cuda_rollout.launches.n == 0  # CPU tensors never launch
