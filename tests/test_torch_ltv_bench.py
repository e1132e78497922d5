"""The benchmark's LTV-MPC deployment (cell ``ltv_b256.pid_store``) on the
CPU: its plain-PyTorch float64 reference, the port's step against it, and
``correct`` at batch 4.

- ``lmpc_bench/reference/ref_ltv_torch.py`` equals the NumPy oracle
  ``RefMPC`` (``lmpc_bench/reference/ref_controller.py``) on seeded stores
  and states to 1e-7 in the input and the prediction;
- the port's LTV step (``controllers/mpc.make_ltv_mpc``) at batch 4 on
  seeded stores and states equals the reference: on the float64 plain
  path to 1e-6; on the float32 fused path (B4's plain version, the cell's
  own settings) to :data:`F32_INPUT` and :data:`F32_PRED`, which B4 at
  ``pallas_iter_precision="default"`` misses;
- ``run.measure`` on the cell at batch 4, its episodes cut to a few steps,
  is correct; a plant that adds 0.02 to the input it applies, or keeps its
  state in bfloat16, is not.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lmpc_bench import cell as cell_mod
from lmpc_bench import control, run, spec
from lmpc_bench.reference import ref_controller, ref_ltv_torch, ref_plant
from lmpc_bench.reference import track as ref_track
from lmpc_bench.roofline import fused as fused_roof
from lmpc_bench.stages import ltv
from racinglmpc_tpu_torch.controllers import mpc as mpc_mod
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import make_track
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
CELL = "ltv_b256.pid_store"
SEED = 3_000_000_017       # wider than 32 signed bits
B = 4
N = 14
# B4's ADMM loop stops at eps_abs = eps_rel = 1e-3 on the scaled
# residuals, in float32: its inputs land within ~2.4e-3 of the exact
# optimum on these cases and its predictions within ~6.8e-3 (the float64
# plain path, polished, within 1e-8); B4 at "default" reads 0.29-0.65
# and 4.5-10.3
F32_INPUT = 1e-2
F32_PRED = 5e-2


def _cell():
    return spec.cell(CELL)


def _settings():
    return ref_ltv_torch.settings(_cell().config["upstream"])


def _ref_track():
    tb = ref_track.table()
    return ref_ltv_torch.track(tb.s0, tb.curv, tb.total_len)


def _cases(seed: int, count: int):
    """Seeded stores (the PID lap with noise wide enough that each
    neighbourhood's regression is well posed) and states along them:
    (lap x, lap u, x0, x_lin, u_lin, u_old) each."""
    f = np.load(spec.ROOT / _cell().traffic["seed_laps"]["file"])
    xs, us = f["xs"], f["us"]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        x = xs + rng.normal(0, 1, xs.shape) * [0.05, 0.05, 0.1, 0.002, 0,
                                                0.002]
        u = us + rng.normal(0, 1, us.shape) * [0.05, 0.1]
        t = int(rng.integers(1, len(xs) - N - 2))
        x0 = x[t] + rng.normal(0, 1, 6) * [0.02, 0.01, 0.02, 0.005, 0.01,
                                           0.01]
        out.append((x, u, x0, x[t + 1:t + N + 2], u[t + 1:t + N + 1],
                    u[t - 1]))
    return out


def test_reference_equals_the_numpy_oracle():
    st, trk = _settings(), _ref_track()
    up = _cell().config["upstream"]
    curv = ref_plant.np_curvature_fn(ref_track.table())
    for x, u, x0, x_lin, u_lin, u_old in _cases(1, 5):
        r = ref_ltv_torch.step(st, [(x, u)], trk, x0, x_lin, u_lin, u_old)
        pm = ref_controller.RefPredictiveModel(
            curv, 1, h=st.h, max_pts=st.max_pts, dt=st.dt)
        pm.add_trajectory(x, u)
        rm = ref_controller.RefMPC(
            N, np.asarray(up["Q"]), np.asarray(up["R"]),
            np.asarray(up["dR"]), np.asarray(up["Qf"]),
            tuple(up["Qslack"]), np.asarray([up["vt"], 0, 0, 0, 0, 0]),
            up["bx"][0], up["bu"][0], up["bu"][2], pm=pm, time_varying=True)
        rm.x_lin, rm.u_lin, rm.u_old = x_lin.copy(), u_lin.copy(), u_old
        u_np = rm.solve(x0)
        assert r.converged and rm.qp_converged
        np.testing.assert_allclose(r.u.numpy(), u_np, atol=1e-7)
        np.testing.assert_allclose(r.x_pred.numpy(), rm.x_pred, atol=1e-7)
        np.testing.assert_allclose(r.x_lin.numpy(), rm.x_lin, atol=1e-7)
        np.testing.assert_allclose(r.u_old.numpy(), u_np, atol=1e-7)


def _port_step(cases, dtype, solver, lcfg):
    c = _cell()
    mcfg = ltv.port_configs(c.config, c.traffic)[0]
    cat = [torch.tensor(np.stack(a), dtype=dtype) for a in zip(*cases)]
    x, u, x0, x_lin, u_lin, u_old = cat
    store = sysid.add_lap(
        sysid.make_lap_store(B, 1, lcfg.model_pts, dtype=dtype,
                             device="cpu"), x, u,
        torch.full((B,), x.shape[1]))
    ctrl, st = mpc_mod.make_ltv_mpc(mcfg, store, make_track(
        dtype=dtype, device="cpu"), lcfg, solver, 0.1, dtype=dtype)
    st = st._replace(x_lin=x_lin, u_lin=u_lin, u_old=u_old)
    return ctrl(st, x0)


def _gaps(cases, new, u):
    st, trk = _settings(), _ref_track()
    du = dp = 0.0
    for b, (x, uu, x0, x_lin, u_lin, u_old) in enumerate(cases):
        r = ref_ltv_torch.step(st, [(x, uu)], trk, x0, x_lin, u_lin, u_old)
        du = max(du, float((u[b].double() - r.u).abs().max()))
        dp = max(dp, float((new.x_pred[b].double() - r.x_pred).abs().max()))
    return du, dp


def test_port_float64_plain_step_equals_the_reference():
    """The plain path, float64, polished: to 1e-6. The port's regression
    adds a ridge of ``reg_jitter`` (1e-9) to its normal equations, where
    the upstream's lambda is 0; set to 0 here, so that both solve the
    same equations."""
    c = _cell()
    _, lcfg, _, _ = ltv.port_configs(c.config, c.traffic)
    lcfg = dataclasses.replace(lcfg, reg_jitter=0.0)
    cases = _cases(2, B)
    new, u = _port_step(cases, torch.float64, SolverConfig(), lcfg)
    assert not bool(new.rejected.any())
    du, dp = _gaps(cases, new, u)
    assert du < 1e-6 and dp < 1e-6, (du, dp)


@pytest.mark.parametrize("prec", ["highest", "default"])
def test_port_float32_fused_step_against_the_reference(prec):
    """The cell's own settings, float32, B4's plain version: within
    :data:`F32_INPUT` and :data:`F32_PRED` at "highest"; beyond them at
    "default" (one bfloat16 pass a product)."""
    c = _cell()
    _, lcfg, solver, _ = ltv.port_configs(
        c.config, c.traffic, {"solver": {"pallas_interpret": True,
                                         "pallas_iter_precision": prec}})
    assert solver.pallas_fused_ns and solver.use_pallas
    cases = _cases(3, B)
    new, u = _port_step(cases, torch.float32, solver, lcfg)
    du, dp = _gaps(cases, new, u)
    ok = du < F32_INPUT and dp < F32_PRED
    assert ok == (prec == "highest"), (du, dp)
    assert bool((new.ns_iters > 0).all())


STEPS = 12


@pytest.fixture(scope="module")
def cpu_cell():
    """The cell at batch 4 on B4's plain version, its episodes cut to
    :data:`STEPS` steps and its sample to 24 steps."""
    bench = spec.benchmark()
    c = spec.cell(CELL, bench)
    c = c._replace(traffic=dict(c.traffic, episode_steps=STEPS),
                   limits=dict(c.limits, check=dict(
                       c.limits["check"], step_range=STEPS, samples=24)))
    S = cell_mod.setup(c, "cpu", {"solver": {"pallas_interpret": True}}, B)
    cell_mod.warm_up(S)
    return bench, c, S


def _measure(cpu_cell, breaker=None):
    bench, c, S = cpu_cell
    # this test process holds JAX (``tests/conftest.py``), which a run of
    # the benchmark refuses; the card's runs keep that check
    forbidden = run.forbidden_modules
    run.forbidden_modules = list
    try:
        return run.measure(bench, c, S, SEED, 0.0, False, breaker=breaker,
                           log=lambda *a: None)
    finally:
        run.forbidden_modules = forbidden


def test_a_sound_run_is_correct(cpu_cell):
    out = _measure(cpu_cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] == B * STEPS and out["failed"] == 0
    assert out["_numbers"]["sampled"] == 24
    assert set(out["metrics"]) == {"solves_per_s"}
    assert list(out)[-1] == "checks"


def test_an_input_offset_in_the_plant_is_not_correct(cpu_cell, monkeypatch):
    step = loop.plant_step

    def offset(plant, u, vp, trk, sim_cfg, draws, table):
        return step(plant, u + torch.tensor([0.0, 0.02]), vp, trk, sim_cfg,
                    draws, table)
    monkeypatch.setattr(loop, "plant_step", offset)
    out = _measure(cpu_cell)
    assert not out["correct"]
    chk = out["checks"]["plant_gap"]
    assert chk["value"] > chk["limit"]


def test_a_bfloat16_plant_is_not_correct(cpu_cell, monkeypatch):
    monkeypatch.setattr(loop, "plant_step", loop.plant_step)
    control.bf16_plant(loop)
    out = _measure(cpu_cell)
    assert not out["correct"]
    chk = out["checks"]["plant_gap"]
    assert chk["value"] > chk["limit"]


def test_a_broken_roll_is_a_mismatch(cpu_cell):
    def broken(clock, S):
        step = clock.step

        def rolled_twice(st, x, draws):
            new, u = step(st, x, draws)
            return new._replace(x_lin=torch.roll(new.x_lin, -1, 1)), u
        clock.step = rolled_twice
    out = _measure(cpu_cell, broken)
    assert not out["correct"] and out["checks"]["mismatches"]["value"] > 0


def test_a_port_without_the_solve_information_fails_at_set_up(monkeypatch):
    """A program whose LTV state lacks the per-step solve information (a
    checkout before it) fails at once, not inside the window."""
    class Old(mpc_mod.MPCState):
        _fields = tuple(f for f in mpc_mod.MPCState._fields
                        if f not in mpc_mod.SOLVE_INFO)
    monkeypatch.setattr(mpc_mod, "MPCState", Old)
    with pytest.raises(RuntimeError, match="solve information"):
        cell_mod.setup(_cell(), "cpu", None, 2)


def test_the_start_is_the_mixs_store_and_x0(cpu_cell):
    """The episode's start is the mix's x0 and its store the seed lap;
    a start moved off x0 is counted entry by entry."""
    bench, c, S = cpu_cell
    assert ltv.start_mismatches(S, range(B)) == 0
    assert torch.equal(S.plant0.x, torch.tensor(
        [c.traffic["x0"]] * B, dtype=torch.float32))
    broken = S._replace(plant0=PlantState(x=S.plant0.x + 1e-3,
                                          x_glob=S.plant0.x_glob))
    assert ltv.start_mismatches(broken, [0]) == 6


def test_work_and_the_fused_readers(cpu_cell):
    """``work`` counts B4's lanes, warm lanes, lane-iterations and warm
    tests from the kept per-step fields; the three readers read them, and
    return nothing where B4 did not run (no ``fused`` counts) or the
    profile lacks its prologue launch."""
    bench, c, S = cpu_cell
    win = cell_mod.window(S, SEED, 0.0)
    w = ltv.work(S, win)["fused"]
    ep = win.episodes[0]
    ns, warm, valid = ep.sr.fused
    assert (w["n"], w["m"]) == (146, 202)
    assert w["lanes"] == 0 and win.profiled == 0     # untraced: none
    w.update(ltv.fused_counts(S, win.episodes))       # as if profiled
    assert w["lanes"] == w["window"]["lanes"] == B * STEPS
    assert w["ns_lane_iters"] == int(ns.sum()) >= B * STEPS
    assert w["warm_lanes"] == int(warm.sum())
    assert w["warm_tests"] == int(valid[:, :-1].sum())
    read = {m["name"]: run.metric_reader(m["name"]) for m in
            bench["per_layer"] if m["name"].startswith("fused.")}
    assert set(read) == {"fused.roofline_pct", "fused.ns_iters_mean",
                         "fused.warm_pct"}
    card = "NVIDIA H100 80GB HBM3"
    ops, nbytes = fused_roof.work(w)
    least = max(ops / 67e12, nbytes / 3.35e12)
    rec = {"work": {"fused": w}, "card": card, "trace": {
        "device_s_by_name": {"admm_fused_prologue": 4 * least}}}
    assert read["fused.roofline_pct"](rec) == pytest.approx(25.0)
    assert read["fused.ns_iters_mean"](rec) == pytest.approx(
        int(ns.sum()) / (B * STEPS))
    assert read["fused.warm_pct"](rec) == pytest.approx(
        100 * int(warm.sum()) / (B * STEPS))
    rec["trace"]["device_s_by_name"] = {}
    assert read["fused.roofline_pct"](rec) is None
    for r in read.values():
        assert r({"work": {}, "card": card, "trace": None}) is None
    off = S._replace(solver=dataclasses.replace(S.solver,
                                                pallas_fused_ns=False))
    assert ltv.work(off, win) == {}
