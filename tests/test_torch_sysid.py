"""Port sys-ID against the JAX reference: the plain path in f64, and the
B2 kernel's plain version against the Pallas kernel (interpret mode, f32)
on full, ragged and empty lap stores with queries across the finish line."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.models import sysid as jsysid
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.ops import pallas_sysid
from racinglmpc_tpu.utils.config import LMPCConfig as JL
from racinglmpc_tpu_torch.models import sysid as tsysid
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.ops import cuda_sysid
from racinglmpc_tpu_torch.utils.config import LMPCConfig

torch.set_num_threads(1)
T = 128
CASES = {"full": [100, 90, 110, 80], "ragged": [60, 25], "empty": [],
         "overlong": [150, 40, 120]}


def _laps(lengths, seed):
    rng = np.random.default_rng(seed)
    out = []
    for steps in lengths:
        n = max(steps, 1)
        x = np.zeros((n, 6))
        x[:, 0] = 1.0 + 0.5 * rng.standard_normal(n)
        x[:, 1] = 0.1 * rng.standard_normal(n)
        x[:, 2] = 0.3 * rng.standard_normal(n)
        x[:, 3] = 0.1 * rng.standard_normal(n)
        x[:, 4] = np.linspace(0, 19.0, n)
        x[:, 5] = 0.2 * rng.standard_normal(n)
        u = 0.3 * rng.standard_normal((n, 2))
        out.append((x, u, steps))
    return out


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 6))
    x[:, 0] = 1.0 + 0.3 * rng.standard_normal(n)
    x[:, 1] = 0.1 * rng.standard_normal(n)
    x[:, 2] = 0.2 * rng.standard_normal(n)
    x[:, 3] = 0.1 * rng.standard_normal(n)
    x[:, 4] = np.linspace(0.5, 21.0, n)      # crosses the wrap at L=19.23
    x[:, 5] = 0.2 * rng.standard_normal(n)
    return x, 0.3 * rng.standard_normal((n, 2))


def _stores(lengths, seed, jdt, tdt):
    js = jsysid.make_lap_store(4, T, dtype=jdt)
    ts = tsysid.make_lap_store(1, 4, T, dtype=tdt, device="cpu")
    for x, u, steps in _laps(lengths, seed):
        js = jsysid.add_lap(js, jnp.asarray(x, jdt), jnp.asarray(u, jdt),
                            jnp.int32(steps))
        ts = tsysid.add_lap(ts, torch.tensor(x, dtype=tdt)[None],
                            torch.tensor(u, dtype=tdt)[None],
                            torch.tensor([steps]))
    return js, ts


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_f64(case):
    js, ts = _stores(CASES[case], 0, jnp.float64, torch.float64)
    for name in ("x", "u", "steps"):
        np.testing.assert_array_equal(getattr(ts, name)[0].numpy(),
                                      np.asarray(getattr(js, name)))
    x, u = _queries(14, 1)
    cfg = LMPCConfig(model_pts=T)
    A0, B0, C0 = jsysid.local_linearization_horizon(
        js, jtrack.make_track(dtype=jnp.float64), jnp.asarray(x),
        jnp.asarray(u), JL(model_pts=T))
    A1, B1, C1 = tsysid.local_linearization_horizon(
        ts, ttrack.make_track(dtype=torch.float64, device="cpu"),
        torch.tensor(x)[None], torch.tensor(u)[None], cfg)
    for a, b in ((A1, A0), (B1, B0), (C1, C0)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-9,
                                   rtol=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_b2_plain_matches_pallas_interpret(case):
    js, ts = _stores(CASES[case], 2, jnp.float32, torch.float32)
    x, u = _queries(14, 3)
    x, u = x.astype(np.float32), u.astype(np.float32)
    A0, B0, C0 = pallas_sysid.local_linearization_horizon(
        js, jtrack.make_track(), jnp.asarray(x), jnp.asarray(u),
        JL(model_pts=T), interpret=True)
    A1, B1, C1 = cuda_sysid.local_linearization_horizon(
        ts, ttrack.make_track(device="cpu"), torch.from_numpy(x)[None],
        torch.from_numpy(u)[None], LMPCConfig(model_pts=T))
    for a, b in ((A1, A0), (B1, B0), (C1, C0)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3)
    assert cuda_sysid.launches.n == 0


def test_batched_scenarios_match_single():
    """A batch of scenarios with different stores equals per-scenario
    results (the reference vmaps one scenario)."""
    stores = [_stores(CASES[c], 5, jnp.float64, torch.float64)
              for c in ("full", "ragged")]
    tb = tsysid.LapStore(*(torch.cat([s[1][i] for s in stores])
                           for i in range(3)))
    x, u = _queries(14, 6)
    trk = ttrack.make_track(dtype=torch.float64, device="cpu")
    cfg = LMPCConfig(model_pts=T)
    xb = torch.tensor(x)[None].repeat(2, 1, 1)
    ub = torch.tensor(u)[None].repeat(2, 1, 1)
    Ab, _, Cb = tsysid.local_linearization_horizon(tb, trk, xb, ub, cfg)
    for i, (js, _) in enumerate(stores):
        A0, _, C0 = jsysid.local_linearization_horizon(
            js, jtrack.make_track(dtype=jnp.float64), jnp.asarray(x),
            jnp.asarray(u), JL(model_pts=T))
        np.testing.assert_allclose(Ab[i].numpy(), np.asarray(A0), atol=1e-9)
        np.testing.assert_allclose(Cb[i].numpy(), np.asarray(C0), atol=1e-9)
