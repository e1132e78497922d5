"""The 40-lap lap-time criterion's fixture and the port's harness
(``racinglmpc_tpu_torch/runtime/solver_quality.py``) against the
reference's own harness, ``examples/solver_quality.py``, on the CPU.

- The fixture ``fixtures/solver_quality_40lap_v1.npz`` holds the reference
  harness's draws: its PID seed lap (``shared_seed_data``) and plant noise
  (41 laps of 1000 steps), both from ``np.random.default_rng(0)`` in that
  order, equal to a fresh draw bit for bit; the track length, equal to the
  reference's float64 track's; and the float64 oracle's 40 lap steps,
  equal to the record's (``BENCH_solver_quality_40lap_tpu.json``,
  ``oracle_f64``), beside a rerun of the oracle on these draws under
  another numpy, which gives the record's steps on laps 0-26 and differs
  from lap 27 on (the oracle is chaotic too), within 0.1% cumulative of
  it. A ``slow`` test replays the oracle's first 3 laps on these draws:
  equal steps.
- The port's float64 track has the reference's breakpoints, curvatures
  and length bit for bit, so the curvature lookup the card's check builds
  from it is the oracle's.
- :func:`solver_quality.summary` gives the record's own differences
  (rounded as the record rounds them) for the reference's float32 run.
- The port's harness in float64 with ``SolverConfig.parity()`` gives the
  lap steps, rejected and off-tolerance counts of the reference's
  ``run_jax`` with the same preset on the same draws, for 2 laps: equal.
- The same with ``throughput()`` (the criterion's preset, its plain
  solver, ``use_pallas=False``) in float64 for 3 laps: equal; a ``slow``
  test holds it for all 40 laps, where both give 3,485 steps, 1.07% off
  the oracle: the preset itself, without float32, misses the 1%.
- ``chip_smoke.quality_laps`` on the CPU (the kernels' plain versions, the
  phase-11 configuration) runs one lap: finished, finite, nothing
  rejected, within 15 steps of the oracle's lap (float32 runs that differ
  only in rounding ran 206-217 against the oracle's 203, the reference's
  213 on its TPU); phase 11's B2
  comparison hook sees no difference there and moves no bit, and the
  triage's one-ulp nudge moves one component at one step, and its
  rank-sum statistic has Mann-Whitney's value on a hand-ranked case.
"""
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.ops import cuda_sysid
from racinglmpc_tpu_torch.runtime import solver_quality as sq
from racinglmpc_tpu_torch.utils import config as tc
from tests.oracles import ref_plant

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / chip_smoke.QUALITY_RECORD).read_text())["presets"]
PARITY_LAPS = 2
THROUGHPUT_LAPS = 3
# the first float32 lap against the oracle's 203 steps: float32 runs
# that differ only in rounding gave 206-217 (the reference's on its TPU 213)
ONE_LAP_STEPS = 15


def _harness():
    """``examples/solver_quality.py``, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "solver_quality_example", ROOT / "examples" / "solver_quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """(the reference harness, its float64 track, curvature lookup)."""
    trk = jtrack.make_track(dtype=jnp.float64)
    return _harness(), trk, ref_plant.np_curvature_fn(trk)


@pytest.fixture(scope="module")
def fx():
    return sq.load_fixture()


def test_fixture_draws_equal_a_fresh_draw(ref, fx):
    h, trk, curv = ref
    L = float(trk.total_len)
    rng = np.random.default_rng(0)
    xs, us = h.shared_seed_data(curv, L, rng)
    laps = len(fx.oracle)
    noise = np.clip(rng.standard_normal((laps + 1, 1000, 3))
                    * np.array([0.01, 0.01, 0.005]), -0.05, 0.05)
    assert fx.track_len == L
    np.testing.assert_array_equal(fx.xs, xs)
    np.testing.assert_array_equal(fx.us, us)
    np.testing.assert_array_equal(fx.noise, noise)


def test_fixture_oracle_steps_equal_the_record(fx):
    assert fx.oracle.tolist() == RECORD["oracle_f64"]["lap_steps"]
    assert len(fx.oracle) == len(fx.oracle_rerun) == chip_smoke.QUALITY_LAPS
    # the rerun: equal laps up to lap 26, 0.1% cumulative of the record
    np.testing.assert_array_equal(fx.oracle_rerun[:27], fx.oracle[:27])
    assert sq.summary(fx.oracle_rerun, fx.oracle)["total_rel_diff_pct"] < 0.1


def test_port_float64_track_is_the_reference_track(ref):
    _, trk, _ = ref
    got = ttrack.make_track(dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(got.s0.numpy(), np.asarray(trk.s0))
    np.testing.assert_array_equal(got.curv.numpy(), np.asarray(trk.curv))
    assert float(got.total_len) == float(trk.total_len)


def test_summary_gives_the_records_differences(fx):
    rec = RECORD["throughput_f32"]
    got = sq.summary(rec["lap_steps"], fx.oracle)
    assert round(got["total_rel_diff_pct"], 2) == rec["total_rel_diff_pct"]
    assert (round(got["final_lap_rel_diff_pct"], 2)
            == rec["final_lap_rel_diff_pct"])


def test_port_float64_equals_reference_harness_two_laps(ref, fx):
    """Both harnesses in float64 with ``parity()`` on the fixture's draws:
    lap steps, rejected and off-tolerance counts equal (exact)."""
    h, trk, curv = ref
    want, diag = h.run_jax(trk, curv, fx.track_len, fx.xs, fx.us, fx.noise,
                           PARITY_LAPS, jc.SolverConfig.parity(),
                           jnp.float64)
    got = sq.run_laps(ttrack.make_track(dtype=torch.float64, device="cpu"),
                      ref_plant.plant_step, curv, fx, PARITY_LAPS,
                      tc.SolverConfig.parity(), dtype=torch.float64,
                      device="cpu")
    assert got.steps == want, (got, want)
    assert got.rejected == [d["rejects"] for d in diag], (got, diag)
    assert got.unconverged == [d["unconverged"] for d in diag], (got, diag)
    assert got.finite


def _throughput_both(ref, fx, laps):
    """``throughput()`` with its plain solver in float64 through both
    harnesses: (the port's Laps, the reference's steps, its diagnostics)."""
    import dataclasses

    h, trk, curv = ref
    want, diag = h.run_jax(
        trk, curv, fx.track_len, fx.xs, fx.us, fx.noise, laps,
        dataclasses.replace(jc.SolverConfig.throughput(), use_pallas=False),
        jnp.float64)
    got = sq.run_laps(
        ttrack.make_track(dtype=torch.float64, device="cpu"),
        ref_plant.plant_step, curv, fx, laps,
        dataclasses.replace(tc.SolverConfig.throughput(), use_pallas=False),
        dtype=torch.float64, device="cpu")
    return got, want, diag


def _assert_equal_laps(got, want, diag):
    assert got.steps == want, (got, want)
    assert got.rejected == [d["rejects"] for d in diag], (got, diag)
    assert got.unconverged == [d["unconverged"] for d in diag], (got, diag)
    assert got.finite


def test_port_float64_throughput_equals_reference_harness(ref, fx):
    """The criterion's preset in float64 (exact): the port's semantics
    are the reference's on the criterion's own draws."""
    _assert_equal_laps(*_throughput_both(ref, fx, THROUGHPUT_LAPS))


@pytest.mark.slow
def test_port_float64_throughput_equals_reference_harness_40_laps(ref, fx):
    got, want, diag = _throughput_both(ref, fx, chip_smoke.QUALITY_LAPS)
    _assert_equal_laps(got, want, diag)
    # 3,485 steps: the preset misses the 1% in float64 too
    assert sq.summary(got.steps, fx.oracle)["total_rel_diff_pct"] > 1


def test_quality_laps_one_float32_lap_on_the_plain_versions(fx):
    """One lap of phase 11's run with its B2 comparison hook: on the CPU
    both sides are the plain version, so they agree exactly, and the hook
    moves no bit of the lap."""
    shadow = chip_smoke.SysidShadow(cuda_sysid)
    r, _, wall = chip_smoke.quality_laps(torch, "cpu", laps=1, hook=shadow)
    assert r.finite and r.rejected == [0], r
    assert abs(r.steps[0] - int(fx.oracle[0])) <= ONE_LAP_STEPS, r
    assert wall > 0
    assert shadow.calls == r.steps[0]
    assert shadow.max_abs == 0.0 and shadow.worst[0] == 0.0
    assert all(ratio == 0.0 for *_, ratio, _ in shadow.bias())
    bare, _, _ = chip_smoke.quality_laps(torch, "cpu", laps=1)
    assert bare == r, (bare, r)


def test_nudge_moves_the_controllers_state_one_ulp_once():
    nudge = chip_smoke.Nudge(torch, 1, 4)
    xs = [torch.tensor([[0.5, 0.0, 0.0, 0.0, 10.0, 0.1]]) for _ in range(3)]
    before = [x.clone() for x in xs]
    for x in xs:
        nudge(None, None, x)
    assert torch.equal(xs[0], before[0]) and torch.equal(xs[2], before[2])
    assert float(xs[1][0, 4]) == float(np.nextafter(np.float32(10.0),
                                                    np.float32(11.0)))
    assert torch.equal(xs[1][0, :4], before[1][0, :4])


def test_rank_sum_z_by_hand():
    """a = (1, 3), b = (2, 4, 5): ranks 1, 3 sum to 4 against a mean of
    6 and a variance of 2 * 3 * 6 / 12 = 3; ties share their mean rank."""
    assert chip_smoke.rank_sum_z([1.0, 3.0], [2.0, 4.0, 5.0]) == \
        pytest.approx(-2 / 3 ** 0.5, rel=1e-12)
    assert chip_smoke.rank_sum_z([2.0, 2.0], [2.0]) == 0.0


@pytest.mark.slow
def test_oracle_replays_its_first_three_laps(ref, fx):
    h, _, curv = ref
    steps = h.run_oracle(curv, fx.track_len, fx.xs, fx.us, fx.noise, 3)
    assert steps == fx.oracle[:3].tolist()
