"""The port's bench (``racinglmpc_tpu_torch/runtime/bench.py``) against the
root ``bench.py`` on the CPU.

- The gate's arithmetic equals the reference's ``quality_gate`` (its lap
  runner stubbed) on every case: each criterion just inside and just
  outside its bound, the missing-fixture branch, and random lap lists.
- ``gate_laps`` equals the reference's ``_run_gate_laps`` in float64: 2
  laps, batch 2, chunk 30, noise off, seeded from the committed converged
  laps. The reference's lap runner takes the dtype of its controller, its
  state and its plant; they are made float64 through the reference's own
  ``dtype`` arguments and its x0 cast where the plant is built. In float32
  (the path the card runs) the two controllers part from the first solves,
  so ``tests/test_torch_bench_f32.py`` holds that path to the reference
  within stated bounds instead.
- ``main`` on the CPU prints one JSON line with the reference's keys,
  ``device`` and the timed solves' quality figure; the launch check raises
  when a kernel did not launch once a step or a scenario streamed; the
  entry point exits non-zero without a card unless ``--device cpu``.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import bench as jbench
import chip_smoke
from racinglmpc_tpu.controllers import lmpc as jlmpc
from racinglmpc_tpu.models import dynamics as jdyn
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.runtime import experiment as jexp
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.runtime import bench as tbench
from racinglmpc_tpu_torch.runtime import experiment as texp
from racinglmpc_tpu_torch.runtime import main_path
from racinglmpc_tpu_torch.utils import config as tc

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
MISSING = str(ROOT / "fixtures" / "no_such_fixture.npz")
CFG = types.SimpleNamespace(lmpc=types.SimpleNamespace(num_ss_it=4))


def _reference(phase1, conv, batch, fixture=tbench.CONVERGED_FIXTURE):
    """The root bench.py's quality_gate on these lap lists."""
    calls = iter([phase1, conv])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbench, "_run_gate_laps", lambda *a, **k: next(calls))
        return jbench.quality_gate(CFG, None, None, None, None, None, None,
                                   None, laps=len(phase1[0]), batch=batch,
                                   conv_laps=len(conv[0]) if conv else 1,
                                   fixture=fixture)


def _port(phase1, conv, batch, fixture=tbench.CONVERGED_FIXTURE):
    if not os.path.exists(fixture):
        return tbench.gate_criteria(*phase1, batch, fixture=fixture)
    _, seed_mean = tbench.load_converged(fixture, "cpu")
    return tbench.gate_criteria(*phase1, batch, conv=conv,
                                conv_seed_mean=seed_mean, fixture=fixture)


# phase 1: 12 laps, batch 8; phase 2: 8 laps from the fixture (seed mean
# 72.0, so the pace bound is 82.8)
Z12, Z8 = [0] * 12, [0] * 8
DOWN = [120.0, 110, 100, 95, 90, 85, 80, 75, 70, 65, 60, 50]   # sum 1000
FLAT = [75.0] * 8                                               # sum 600
SLOW = [100.0, 95, 90, 85, 80, 75, 70, 65, 62]    # 0.6 x the first: 60.0
CASES = {
    # name: (phase 1 (steps, rejects, unconverged), phase 2, batch, key,
    #        its expected value)
    "improving_inside": ((SLOW + [60.0, 59.9, 59.8], Z12, Z12),
                         (FLAT, Z8, Z8), 8, "improving", True),
    "improving_outside": ((SLOW + [60.0, 60.0, 60.0], Z12, Z12),
                          (FLAT, Z8, Z8), 8, "improving", False),
    "no_spike_inside": (([100.0, 90, 80, 70, 60, 50, 65.0, 45, 40, 35, 32,
                          30], Z12, Z12), (FLAT, Z8, Z8), 8, "no_spike",
                        True),
    "no_spike_outside": (([100.0, 90, 80, 70, 60, 50, 65.1, 45, 40, 35, 32,
                           30], Z12, Z12), (FLAT, Z8, Z8), 8, "no_spike",
                         False),
    "rejects_inside": ((DOWN, [40] + Z12[1:], Z12), (FLAT, Z8, Z8), 8,
                       "rejects_ok", True),
    "rejects_outside": ((DOWN, [40, 1] + Z12[2:], Z12), (FLAT, Z8, Z8), 8,
                        "rejects_ok", False),
    "conv_pace_inside": ((DOWN, Z12, Z12), ([82.7] * 8, Z8, Z8), 8,
                         "conv_pace", True),
    "conv_pace_outside": ((DOWN, Z12, Z12), ([82.9] * 8, Z8, Z8), 8,
                          "conv_pace", False),
    "conv_spike_inside": ((DOWN, Z12, Z12), ([70.0, 91.0] + [70.0] * 6, Z8,
                                             Z8), 8, "conv_spike_ok", True),
    "conv_spike_outside": ((DOWN, Z12, Z12), ([70.0, 91.1] + [70.0] * 6,
                                              Z8, Z8), 8, "conv_spike_ok",
                           False),
    "conv_rejects_inside": ((DOWN, Z12, Z12), (FLAT, [24] + Z8[1:], Z8), 8,
                            "conv_rejects_ok", True),
    "conv_rejects_outside": ((DOWN, Z12, Z12), (FLAT, [24, 1] + Z8[2:], Z8),
                             8, "conv_rejects_ok", False),
    "conv_unconverged_inside": ((DOWN, Z12, Z12), (FLAT, Z8, [960] + Z8[1:]),
                                8, "conv_unconverged_ok", True),
    "conv_unconverged_outside": ((DOWN, Z12, Z12),
                                 (FLAT, Z8, [960, 1] + Z8[2:]), 8,
                                 "conv_unconverged_ok", False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gate_criteria_equals_reference_at_each_bound(name):
    phase1, conv, batch, key, want = CASES[name]
    ref = _reference(phase1, conv, batch)
    assert ref[key] is want          # the case sits where it says
    got = _port(phase1, conv, batch)
    assert got == ref
    assert got["pass"] is want


def test_gate_criteria_missing_fixture_equals_reference():
    phase1 = (DOWN, Z12, [3] * 12)
    ref = _reference(phase1, None, 8, fixture=MISSING)
    got = _port(phase1, None, 8, fixture=MISSING)
    assert got == ref
    assert got["converged_phase"] == f"SKIPPED: no fixture at {MISSING}"
    assert got["pass"] is True


def _laps(min_size, max_size):
    steps = st.lists(st.floats(20.0, 450.0).map(lambda v: round(v, 1)),
                     min_size=min_size, max_size=max_size)
    return steps.flatmap(lambda s: st.tuples(
        st.just(s),
        st.lists(st.integers(0, 40), min_size=len(s), max_size=len(s)),
        st.lists(st.integers(0, 600), min_size=len(s), max_size=len(s))))


@settings(max_examples=40, deadline=None)
@given(phase1=_laps(1, 14), conv=_laps(1, 10), batch=st.integers(1, 16),
       fixture=st.booleans())
def test_gate_criteria_property_equals_reference(phase1, conv, batch,
                                                 fixture):
    path = tbench.CONVERGED_FIXTURE if fixture else MISSING
    ref = _reference(phase1, conv if fixture else None, batch, path)
    assert _port(phase1, conv, batch, path) == ref


def test_gate_laps_equal_reference_float64():
    """Two laps from the converged fixture on the L track, the main path's
    LMPCConfig and ``throughput()``, noise off, batch 2, chunk 30: equal
    per-lap mean steps, rejected and unconverged counts."""
    lkw = dict(max_laps=12, max_pts=1024, model_pts=512)
    jcfg = jexp.ExperimentConfig(sim=jc.SimConfig(noise=False),
                                 solver=jc.SolverConfig.throughput(),
                                 lmpc=jc.LMPCConfig(**lkw))
    tcfg = texp.ExperimentConfig(sim=tc.SimConfig(noise=False),
                                 solver=tc.SolverConfig.throughput(),
                                 lmpc=tc.LMPCConfig(**lkw))
    fx = np.load(tbench.CONVERGED_FIXTURE)
    seeds = [[fx[f"{k}{i}"] for k in ("x", "u", "xg", "steps")]
             for i in range(int(fx["n_laps"]))]
    kw = dict(laps=2, batch=2, chunk=30, max_steps=120)
    plant = jdyn.PlantState

    def plant64(x, x_glob):
        return plant(x=jnp.asarray(x, jnp.float64),
                     x_glob=jnp.asarray(x_glob, jnp.float64))

    with pytest.MonkeyPatch.context() as mp:
        # the reference's gate leaves its controller and state at their
        # float32 defaults and builds x0 in float32
        for name in ("init_lmpc_state", "make_lmpc"):
            mp.setattr(jlmpc, name, functools.partial(getattr(jlmpc, name),
                                                      dtype=jnp.float64))
        mp.setattr(jdyn, "PlantState", plant64)
        ref = jbench._run_gate_laps(
            jcfg, jtrack.make_track(dtype=jnp.float64), jc.VehicleParams(),
            [tuple(jnp.asarray(a) for a in s) for s in seeds],
            jax.random.PRNGKey(0), log=lambda *a: None, **kw)
    got = tbench.gate_laps(
        tcfg, ttrack.make_track(dtype=torch.float64, device="cpu"),
        tc.VehicleParams(),
        [tuple(torch.from_numpy(a).double() if a.ndim
               else torch.from_numpy(a) for a in s) for s in seeds],
        device="cpu", **kw)
    assert all(v < kw["max_steps"] for v in ref[0])   # the laps finished
    assert got == tuple(ref)


def test_gate_laps_trace_holds_every_executed_solve():
    """``gate_laps``' ``trace``: one lap's executed solves (arc length,
    ADMM iterations, not at tolerance), as many as the lap's steps, its
    off-tolerance count the lap's, and ``chip_smoke.unconverged_where``
    bins every one of them by metres to the finish line."""
    tcfg = texp.ExperimentConfig(
        sim=tc.SimConfig(noise=False), solver=tc.SolverConfig.throughput(),
        lmpc=tc.LMPCConfig(max_laps=12, max_pts=1024, model_pts=512))
    trk = ttrack.make_track(dtype=torch.float64, device="cpu")
    seeds, _ = tbench.load_converged(device="cpu")
    seeds = [tuple(a.double() if a.is_floating_point() else a for a in s)
             for s in seeds]
    trace = []
    steps, _, unc = tbench.gate_laps(
        tcfg, trk, tc.VehicleParams(), seeds, laps=1, batch=2, chunk=30,
        max_steps=120, device="cpu", trace=trace)
    s, it, off = trace[0]
    assert len(trace) == 1 and s.numel() == it.numel() == off.numel()
    assert s.numel() == round(2 * steps[0]) and int(off.sum()) == unc[0]
    assert bool((it >= 0).all()) and bool((s <= trk.total_len).all())
    where = json.loads(chip_smoke.unconverged_where(
        torch, trace, float(trk.total_len), tcfg.solver.max_iter))
    rows = where["by_m_to_line_solves_and_not_at_tolerance"]
    assert sum(n for n, _ in rows.values()) == where["solves"] == s.numel()
    assert sum(u for _, u in rows.values()) == where["not_at_tolerance"]


def test_main_on_cpu_prints_the_reference_fields(monkeypatch, capsys):
    """``main`` end to end at a small size: a 40-step PID seed, 2 steps a
    chunk, and a one-lap gate of 2 steps a phase."""
    config = main_path.config
    monkeypatch.setattr(main_path, "config", lambda *a: dataclasses.replace(
        config(*a), stage_steps=40))
    monkeypatch.setattr(tbench, "quality_gate", functools.partial(
        tbench.quality_gate, laps=1, batch=1, chunk=2, max_steps=2,
        conv_laps=1))
    res = tbench.main(batch=2, steps=2, reps=1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == res
    assert set(res) == {"metric", "value", "unit", "vs_baseline",
                        "admm_iters_mean", "admm_iters_p50",
                        "admm_iters_p99", "batch", "max_preset_solves_per_s",
                        "quality", "device", "solves_timed",
                        "solves_rejected", "solves_not_at_tolerance",
                        "not_at_tolerance_ok"}
    assert res["solves_timed"] == 4
    assert 0 <= res["solves_rejected"] <= res["solves_not_at_tolerance"] <= 4
    assert res["not_at_tolerance_ok"] is (
        res["solves_not_at_tolerance"] <= 0.1 * 4)
    assert res["metric"] == tbench.CPU_METRIC and res["device"] == "cpu"
    assert res["value"] > 0 and res["batch"] == 2
    assert len(res["quality"]["laps_mean_steps"]) == 1
    assert len(res["quality"]["conv_laps_mean_steps"]) == 1


COUNTS = {"admm": 10, "admm_layouts": 10, "sysid": 10, "rollout": 10,
          "admm_streamed": 0}


def _after(steps, **change):
    return {k: v + (steps if k != "admm_streamed" else 0)
            for k, v in COUNTS.items()} | change


def test_launch_check_passes_once_per_step():
    d = tbench.check_kernel_path(COUNTS, _after(5), 5)
    assert d == {"admm": 5, "admm_layouts": 5, "sysid": 5, "rollout": 5,
                 "admm_streamed": 0}
    tbench.check_kernel_path(COUNTS, _after(5, rollout=10), 5, rollout=False)


@pytest.mark.parametrize("change", [
    {"sysid": 10}, {"rollout": 10}, {"admm": 10, "admm_layouts": 10},
    {"admm_layouts": 14}, {"admm": 16}, {"admm_streamed": 1}])
def test_launch_check_raises(change):
    with pytest.raises(tbench.KernelPathError):
        tbench.check_kernel_path(COUNTS, _after(5, **change), 5)


def test_entry_point_without_a_card_exits_nonzero():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "racinglmpc_tpu_torch.runtime.bench"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
