"""Engagement rules of the sys-ID kernel (B2) and the rollout kernel (B3),
on the CPU.

- ``LMPCController.use_kernel_sysid`` is the reference's gate
  (``racinglmpc_tpu/controllers/lmpc.py``: float32, ``model_pts % 128 ==
  0``). Outside it the step takes the plain sys-ID, as the reference takes
  its XLA path. A ``knn_max`` above ``MAX_KNN`` stays on the kernel (its
  rescan instance), as the reference's kernel takes any ``knn_max``.
- ``runtime/loop.use_kernel_rollout`` engages B3 for scalar vehicle
  parameters only, as the reference's fused rollout does
  (``racinglmpc_tpu/runtime/experiment.py:_batched_runner``); a batched
  ``VehicleParams`` takes the plain plant step, and a batched run equals
  the runs of its scenarios one by one.

``sysid_interpret=True`` stands in for a CUDA track here: it engages the
kernel's wrapper, which runs the plain version on CPU tensors.
"""
import dataclasses

import pytest
import torch

from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.track import make_track
from racinglmpc_tpu_torch.ops import cuda_rollout, cuda_sysid
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                               VehicleParams)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trk():
    return make_track(device="cpu")


MAIN_PATH = dict(max_laps=12, max_pts=1024, model_pts=512)
CLOSED_LOOP = dict(max_laps=10, max_pts=1024, model_pts=512)


@pytest.mark.parametrize("change, engaged", [
    (dict(MAIN_PATH), True),
    (dict(CLOSED_LOOP), True),
    (dict(model_pts=1024), True),
    (dict(model_pts=511), False),
    (dict(model_pts=640), True),
    (dict(knn_max=cuda_sysid.MAX_KNN), True),
    (dict(knn_max=cuda_sysid.MAX_KNN + 1), True),
    (dict(knn_max=40), True),
    (dict(N=cuda_sysid.MAX_N + 1), True),    # the wrapper raises, as the
                                             # reference's kernel does
    (dict(use_pallas_sysid=False), False),
    (dict(sysid_interpret=False), False),    # a CPU track, no interpret
])
def test_use_kernel_sysid(trk, change, engaged):
    cfg = dataclasses.replace(
        LMPCConfig(use_pallas_sysid=True, sysid_interpret=True), **change)
    ctrl = lmpc_mod.make_lmpc(cfg, trk)
    assert ctrl.use_kernel_sysid is engaged


def test_use_kernel_sysid_float64_takes_the_plain_path(trk):
    cfg = LMPCConfig(use_pallas_sysid=True, sysid_interpret=True)
    assert lmpc_mod.make_lmpc(cfg, trk).use_kernel_sysid
    assert not lmpc_mod.make_lmpc(cfg, trk, dtype=torch.float64) \
        .use_kernel_sysid


def _sysid_calls(monkeypatch, cfg, trk, rows=128):
    """Which sys-ID the controller's step reaches on a lap store of
    ``rows`` rows: ("kernel" or "plain",) per call."""
    calls = []
    kern = cuda_sysid.local_linearization_horizon
    plain = sysid.local_linearization_horizon

    def spy_k(*a, **k):
        calls.append("kernel")
        return kern(*a, **k)

    def spy_p(*a, **k):
        calls.append("plain")
        return plain(*a, **k)

    monkeypatch.setattr(cuda_sysid, "local_linearization_horizon", spy_k)
    monkeypatch.setattr(sysid, "local_linearization_horizon", spy_p)
    ctrl = lmpc_mod.make_lmpc(cfg, trk)
    B, N = 2, cfg.N
    g = torch.Generator().manual_seed(0)
    store = sysid.LapStore(torch.randn((B, 2, rows, 6), generator=g),
                           torch.randn((B, 2, rows, 2), generator=g),
                           torch.full((B, 2), rows, dtype=torch.int32))
    A, Bm, C = ctrl.sysid(store, torch.randn((B, N, 6), generator=g),
                          torch.randn((B, N, 2), generator=g))
    assert A.shape == (B, N, 6, 6) and bool(torch.isfinite(A).all())
    return calls


@pytest.mark.parametrize("change, want", [
    (dict(), ["kernel"]),
    (dict(knn_max=cuda_sysid.MAX_KNN + 1), ["kernel"]),
    (dict(model_pts=511), ["plain"]),
])
def test_sysid_call_follows_the_rule(monkeypatch, trk, change, want):
    cfg = dataclasses.replace(
        LMPCConfig(N=6, model_pts=128, use_pallas_sysid=True,
                   sysid_interpret=True), **change)
    assert _sysid_calls(monkeypatch, cfg, trk) == want


BATCHED = VehicleParams(m=torch.tensor([1.98, 2.3]),
                        Iz=torch.tensor([0.024, 0.03]))


@pytest.mark.parametrize("vp, scalar", [
    (VehicleParams(), True),
    (VehicleParams(m=torch.tensor(2.3)), True),      # 0-dim tensor
    (BATCHED, False),
    (VehicleParams(m=torch.tensor([2.3])), False),   # (1,) is batched
])
def test_rollout_engagement_predicate(vp, scalar):
    assert loop.scalar_vp(vp) is scalar
    on = SimConfig(use_pallas_rollout=True)
    assert loop.use_kernel_rollout(on, vp) is scalar
    assert not loop.use_kernel_rollout(SimConfig(), vp)


def _pid_run(vp, batch, monkeypatch):
    calls = []
    real = cuda_rollout.plant_step_batch

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(cuda_rollout, "plant_step_batch", spy)
    cfg = exp.ExperimentConfig(
        stage_steps=40, pid_noise=False,
        sim=SimConfig(noise=False, use_pallas_rollout=True))
    res = exp.run_experiment(cfg, batch=batch, vp=vp, stages="pid",
                             device="cpu")
    return res.pid, len(calls)


def test_batched_vp_run_equals_scalar_runs(monkeypatch):
    """A batch of two vehicles through ``run_experiment`` with the rollout
    kernel asked for: the plain plant step runs (no kernel call), and each
    scenario equals its own scalar-``vp`` run, which does call the kernel's
    wrapper."""
    batched, n_b = _pid_run(BATCHED, 2, monkeypatch)
    assert n_b == 0
    for i in range(2):
        vp = VehicleParams(m=float(BATCHED.m[i]), Iz=float(BATCHED.Iz[i]))
        one, n_s = _pid_run(vp, 1, monkeypatch)
        assert n_s == 40
        torch.testing.assert_close(batched.x[i], one.x[0], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(batched.u[i], one.u[0], rtol=0,
                                   atol=1e-6)
    assert not torch.equal(batched.x[0], batched.x[1])
