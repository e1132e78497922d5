"""The LTV-MPC step under the port's tracer (``runtime/tracing.py``) on
the CPU, with the fused-prologue kernel B4 on its plain version.

Armed, a few steps at batch 2 give spans under the LMPC step's names,
nested as the step runs (``ctrl.step`` > ``ctrl.sysid``, ``ctrl.assemble``,
``qp.solve`` > ``qp.prologue``, ``qp.admm``, ``qp.finish``, and
``ctrl.accept``); B4's ``fused.*`` counters equal the sums of its
per-lane outputs, those the state carries and those of ``FusedResult``;
disarmed, the steps give the same bits and count nothing.
"""
import dataclasses

import numpy as np
import pytest
import torch

from racinglmpc_tpu_torch.controllers import mpc as mpc_mod
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.track import make_track
from racinglmpc_tpu_torch.ops import cuda_qp_fused
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import tracing
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, MPCConfig,
                                               SolverConfig)
from racinglmpc_tpu_torch.utils.qp_cases import random_qps

torch.set_num_threads(1)
B = 2
STEPS = 3
SOLVER = dataclasses.replace(SolverConfig.throughput(), pallas_fused_ns=True,
                             pallas_interpret=True)
FUSED = ("lanes", "warm_lanes", "ns_lane_iters", "rescued_lanes")


def _controller():
    """LTV-MPC at N = 14 over a store of one seeded lap, and its plant
    states: the state a few rows along the lap, nudged."""
    g = torch.Generator().manual_seed(11)
    T = 120
    t = torch.arange(T, dtype=torch.float32)
    x = torch.zeros(T, 6)
    x[:, 0] = 0.8 + 0.05 * torch.sin(t / 7)
    x[:, 1] = 0.02 * torch.sin(t / 5)
    x[:, 2] = 0.1 * torch.cos(t / 9)
    x[:, 4] = 0.08 * t
    x[:, 5] = 0.05 * torch.sin(t / 11)
    u = torch.stack([0.05 * torch.sin(t / 6), 0.2 * torch.cos(t / 8)], 1)
    x = x + 0.01 * torch.randn(x.shape, generator=g)
    u = u + 0.01 * torch.randn(u.shape, generator=g)
    store = sysid.add_lap(
        sysid.make_lap_store(B, 1, 128, device="cpu"),
        x[None].expand(B, -1, -1), u[None].expand(B, -1, -1),
        torch.full((B,), T))
    cfg = dataclasses.replace(MPCConfig(), time_varying=True)
    lcfg = LMPCConfig(model_laps=1, model_pts=128)
    ctrl, st = mpc_mod.make_ltv_mpc(cfg, store, make_track(device="cpu"),
                                    lcfg, SOLVER, 0.1)
    xs = x[3:3 + STEPS, None].expand(-1, B, -1) + 0.01 * torch.randn(
        (STEPS, B, 6), generator=g)
    return ctrl, st, xs


def _run(ctrl, st, xs):
    outs = []
    for x in xs:
        st, u = ctrl(st, x)
        outs.append((st, u))
    return outs


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return []


@pytest.fixture(scope="module")
def traced():
    ctrl, st, xs = _controller()
    plain = _run(ctrl, st, xs)
    with tracing.session() as rec:
        armed = _run(ctrl, st, xs)
    return ctrl, st, xs, plain, armed, rec


def test_span_tree_has_the_lmpc_steps_names(traced):
    *_, rec = traced
    spans = rec.spans
    names = [s.name for s in spans]

    def children(i):
        return [s.name for s in spans if s.parent == i]

    steps = [i for i, s in enumerate(spans) if s.name == "ctrl.step"]
    assert len(steps) == STEPS and all(spans[i].parent == -1 for i in steps)
    for i in steps:
        assert children(i) == ["ctrl.sysid", "ctrl.assemble", "qp.solve",
                               "ctrl.accept"]
        solve = next(j for j, s in enumerate(spans)
                     if s.parent == i and s.name == "qp.solve")
        assert children(solve) == ["qp.prologue", "qp.admm", "qp.finish"]
        pro = next(j for j, s in enumerate(spans)
                   if s.parent == solve and s.name == "qp.prologue")
        assert children(pro) == ["qp.ruiz"]
    assert set(names) == {"ctrl.step", "ctrl.sysid", "ctrl.assemble",
                          "qp.solve", "qp.prologue", "qp.ruiz", "qp.admm",
                          "qp.finish", "ctrl.accept"}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_fused_counters_equal_the_states_per_lane_sums(traced):
    *_, armed, rec = traced
    c = rec.counts
    states = [st for st, _ in armed]
    assert c["fused.lanes"] == B * STEPS
    assert c["fused.warm_lanes"] == sum(int(st.warm.sum()) for st in states)
    assert c["fused.ns_lane_iters"] == sum(int(st.ns_iters.sum())
                                           for st in states)
    assert c["fused.ns_lane_iters"] >= B * STEPS     # a pass runs once
    for st in states:
        assert st.iters.dtype == torch.int32 and bool((st.iters > 0).all())
        assert not bool((st.rejected & st.feasible).any())


def test_disarmed_the_step_is_unchanged(traced):
    ctrl, st, xs, plain, armed, _ = traced
    for (s0, u0), (s1, u1) in zip(plain, armed):
        assert torch.equal(u0, u1)
        for a, b in zip(_leaves(s0), _leaves(s1)):
            assert torch.equal(a, b)
    before = cuda_qp_fused.work.values()
    _run(ctrl, st, xs[:1])
    assert cuda_qp_fused.work.values() == before
    assert not tracing.armed()


def test_fused_counters_equal_the_results_sums():
    """Around one call of B4's plain version: lanes, warm lanes (a warm
    cache on half the lanes), Newton-Schulz lane-iterations and rescued
    lanes are the sums of ``FusedResult``'s fields."""
    qps = random_qps(6, device="cpu")
    cfg = dataclasses.replace(SOLVER, rescue_max_iter=50, max_iter=30,
                              check_every=10, eps_abs=1e-6, eps_rel=1e-6)
    fac = qp_mod.solve(qps, cfg).fac
    fac = fac._replace(valid=torch.arange(6) % 2 == 0)
    kw = qp_mod.fused_inputs(qps, cfg, None, fac)
    with tracing.session() as rec:
        r = cuda_qp_fused.admm_iterate_fused(**kw)
    c = rec.counts
    assert [c[f"fused.{k}"] for k in FUSED] == [
        6, int(r.warm.sum()), int(r.ns_iters.sum()), int(r.rescued.sum())]
    assert 0 < int(r.warm.sum()) <= 3
    assert np.isfinite(r.x.numpy()).all()
