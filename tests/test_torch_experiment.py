"""The port's four-stage experiment, checkpoints, metrics and presets.

- ``run_experiment(stages="pid,lti,ltv")`` against JAX's: batch 1, 25-step
  stages, plant and PID noise off, ``SolverConfig()`` (so the LTV stage
  takes the structured KKT build), float64: every stage's states to 1e-6
  and the LTI fit to 1e-8 (25 noise-free PID steps make the 8x8 normal
  matrix near singular under the 1e-7 ridge).
- Checkpoints (port only, mirroring ``tests/test_checkpoint_metrics.py``):
  round trip, shape mismatch and missing leaf refused; an LMPC run
  interrupted after lap 1 and resumed reproduces the uninterrupted run bit
  for bit (plant noise on, so the per-lap streams matter); resuming a
  completed run is a no-op that reports the whole record; a different seed
  is refused.
- All four stages run on the CPU under ``SolverConfig()``,
  ``throughput()``, ``throughput_max()``, ``balanced()`` and
  ``throughput()`` with ``pallas_fused_ns`` (interpret).
- ``summarize`` / ``latency_report`` equal JAX's on the same numbers.
- Every preset's (stages, batch, config) equals JAX's as
  ``dataclasses.asdict``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.runtime import experiment as jexp
from racinglmpc_tpu.runtime import metrics as jmetrics
from racinglmpc_tpu.runtime import presets as jpresets
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch.controllers import lmpc as tlmpc
from racinglmpc_tpu_torch.parallel import make_mesh
from racinglmpc_tpu_torch.runtime import checkpoint
from racinglmpc_tpu_torch.runtime import experiment as texp
from racinglmpc_tpu_torch.runtime import metrics as tmetrics
from racinglmpc_tpu_torch.runtime import presets as tpresets
from racinglmpc_tpu_torch.utils import config as tc
from tests.test_torch_lmpc import LKW, _oval

torch.set_num_threads(1)


def test_stages_pid_lti_ltv_match_reference():
    common = dict(N=8, stage_steps=25, pid_noise=False)
    jcfg = jexp.ExperimentConfig(sim=jc.SimConfig(noise=False), **common)
    tcfg = texp.ExperimentConfig(sim=tc.SimConfig(noise=False), **common)
    jres = jexp.run_experiment(jax.random.PRNGKey(0), jcfg, batch=1,
                               stages="pid,lti,ltv", dtype=jnp.float64)
    tres = texp.run_experiment(tcfg, batch=1, stages="pid,lti,ltv",
                               dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tres.A_lti.numpy(), np.asarray(jres.A_lti),
                               atol=1e-8)
    np.testing.assert_allclose(tres.B_lti.numpy(), np.asarray(jres.B_lti),
                               atol=1e-8)
    for name in ("pid", "lti", "ltv"):
        t, j = getattr(tres, name), getattr(jres, name)
        np.testing.assert_array_equal(t.steps.numpy(), np.asarray(j.steps))
        for f in ("x", "u", "x_glob"):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)), atol=1e-6,
                                       err_msg=f"{name}.{f}")
    assert tres.lmpc_laps is None and tres.lap_wall_s is None
    with pytest.raises(TypeError, match="ScenarioMesh"):
        texp.run_experiment(tcfg, stages="pid", device="cpu", mesh=object())
    with make_mesh("cpu") as mesh:      # a one-rank gloo mesh runs alike
        mres = texp.run_experiment(tcfg, batch=1, stages="pid,lti,ltv",
                                   dtype=torch.float64, mesh=mesh)
    for name in ("pid", "lti", "ltv"):
        np.testing.assert_array_equal(getattr(mres, name).x.numpy(),
                                      getattr(tres, name).x.numpy())


SOLVERS = {
    "default": tc.SolverConfig(),
    "throughput": tc.SolverConfig.throughput(),
    "throughput_max": tc.SolverConfig.throughput_max(),
    "balanced": tc.SolverConfig.balanced(),
    "fused": dataclasses.replace(tc.SolverConfig.throughput(),
                                 pallas_fused_ns=True,
                                 pallas_interpret=True),
}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_four_stages_run_under_every_solver(solver):
    """All four stages on the CPU under each solver preset (the structured
    build for default / balanced / throughput_max, B4's plain version for
    fused): finite states, the LTI fit, one LMPC lap recorded."""
    cfg = texp.ExperimentConfig(
        N=6, stage_steps=12, n_lmpc_laps=1, lap_max_steps=20, lap_chunk=10,
        solver=SOLVERS[solver], lmpc=tc.LMPCConfig(**LKW))
    res = texp.run_experiment(cfg, batch=1, stages="pid,lti,ltv,lmpc",
                              device="cpu")
    for sr in (res.pid, res.lti, res.ltv, res.lmpc_laps[0]):
        assert bool(torch.isfinite(sr.x[sr.mask]).all())
    assert res.A_lti.shape == (1, 6, 6) and res.lap_steps.shape == (1, 1)
    assert set(res.stage_wall_s) == {"pid", "lti", "ltv"}


def _small_state(batch=2):
    cfg = tc.LMPCConfig(max_laps=4, max_pts=64, model_pts=32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, 40, 6)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(batch, 40, 2)).astype(np.float32))
    st = tlmpc.init_lmpc_state(cfg, batch, device="cpu")
    scale = torch.arange(1, batch + 1, dtype=torch.float32)[:, None, None]
    return tlmpc.lmpc_add_trajectory(st, cfg, x * scale, u, x,
                                     torch.full((batch,), 40), 19.23)


def test_checkpoint_roundtrip_and_refusals(tmp_path):
    state = _small_state()
    plant = texp.initial_plant(2, device="cpu")
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, (state, plant), seed=123, lap=7, meta={"k": 1})
    (restored, rplant), seed, lap = checkpoint.load(
        path, (tlmpc.init_lmpc_state(tc.LMPCConfig(max_laps=4, max_pts=64,
                                                   model_pts=32), 2,
                                     device="cpu"), plant))
    assert (seed, lap) == (123, 7)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(state)),
                    jax.tree_util.tree_leaves(tuple(restored))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(rplant.x.numpy(), plant.x.numpy())
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, (_small_state(batch=3), plant))
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.load(path, (state, plant, plant.x))


def _ckpt_cfg(n_laps):
    return texp.ExperimentConfig(
        N=6, stage_steps=60, n_lmpc_laps=n_laps, lap_max_steps=40,
        lap_chunk=20, solver=tc.SolverConfig.throughput(),
        lmpc=tc.LMPCConfig(**dict(LKW, max_laps=8)))


def test_checkpoint_resume_is_bit_identical(tmp_path):
    _, trk = _oval(jnp.float32, torch.float32)
    kw = dict(batch=2, stages="pid,lmpc", trk=trk, device="cpu", seed=3)
    full = texp.run_experiment(_ckpt_cfg(2), **kw)
    ckpt = str(tmp_path / "ck")
    texp.run_experiment(_ckpt_cfg(1), checkpoint_dir=ckpt, **kw)
    res = texp.run_experiment(_ckpt_cfg(2), checkpoint_dir=ckpt,
                              resume=True, **kw)
    assert res.resume_lap == 1 and len(res.lmpc_laps) == 1
    np.testing.assert_array_equal(res.lap_steps, full.lap_steps)
    np.testing.assert_array_equal(res.lap_times, full.lap_times)
    assert len(res.lap_wall_s) == 2
    for a, b in zip(res.lmpc_laps, full.lmpc_laps[1:]):
        np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())
        np.testing.assert_array_equal(a.u.numpy(), b.u.numpy())
    np.testing.assert_array_equal(res.lmpc_state.ss.x.numpy(),
                                  full.lmpc_state.ss.x.numpy())
    # a completed run resumes as a no-op with the whole record
    again = texp.run_experiment(_ckpt_cfg(2), checkpoint_dir=ckpt,
                                resume=True, **kw)
    assert again.resume_lap == 2 and len(again.lmpc_laps) == 0
    np.testing.assert_array_equal(again.lap_steps, full.lap_steps)
    np.testing.assert_array_equal(again.lap_times, full.lap_times)
    # another seed would not reproduce the uninterrupted run
    with pytest.raises(ValueError, match="resume seed mismatch"):
        texp.run_experiment(_ckpt_cfg(2), checkpoint_dir=ckpt, resume=True,
                            **dict(kw, seed=4))


def test_metrics_match_reference():
    vals = dict(feasible=[True, True, False, True],
                pri_res=[1e-4, 2e-4, 5e-2, 1e-4],
                dua_res=[1e-3, 1e-3, 1.0, 2e-3], iters=[50, 100, 200, 50],
                lap_progress=[1.0, 2.0, 3.0, 4.0])
    j = jmetrics.summarize(jmetrics.StepMetrics(
        **{k: jnp.asarray(v) for k, v in vals.items()}))
    t = tmetrics.summarize(tmetrics.StepMetrics(
        **{k: torch.tensor(v) for k, v in vals.items()}))
    assert t.keys() == j.keys()
    for k in j:
        assert abs(t[k] - j[k]) < 1e-7 * max(1.0, abs(j[k])), k
    for s in (np.asarray([0.01, 0.02, 0.015, 0.05]), np.full(100, 0.2)):
        assert tmetrics.latency_report(s) == jmetrics.latency_report(s)
    secs = tmetrics.time_steps(lambda: torch.ones(3).sum(), 3)
    assert secs.shape == (3,) and (secs >= 0).all()


def test_presets_equal_reference():
    assert tpresets.PRESETS.keys() == jpresets.PRESETS.keys()
    for name, p in jpresets.PRESETS.items():
        t = tpresets.PRESETS[name]
        assert (t["stages"], t["batch"]) == (p["stages"], p["batch"]), name
        assert dataclasses.asdict(t["cfg"]) == dataclasses.asdict(p["cfg"]), \
            name
