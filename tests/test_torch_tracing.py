"""The port's tracer (``runtime/tracing.py``) on the CPU.

Disarmed, a few LMPC steps at batch 2 record nothing; armed, they give the
same bits and spans that nest as the control step does, each with its
batched step; the Newton-Schulz counters equal a hand count; the rescue's
counter counts the plain version's rescued lanes; the spans share the
profiler's clock; the overlay puts kernels and idle gaps where a fixed
event list says, and partitions the idle time that the benchmark's own
reduction (``lmpc_bench/trace.py``) labels.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from lmpc_bench import trace as bench_trace
from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.ops import cuda_qp
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import bench as tbench
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop, main_path, rescue_replay
from racinglmpc_tpu_torch.runtime import tracing
from racinglmpc_tpu_torch.utils.config import VehicleParams
from racinglmpc_tpu_torch.utils.qp_cases import random_qps

torch.set_num_threads(1)
B = 2
STEPS = 4


@pytest.fixture(scope="module")
def lap():
    """The main path's controller (B1, B2, B3 on their plain versions) at
    batch 2, seeded from the converged laps, and a runner of its lap."""
    cfg = main_path.config()
    solver = dataclasses.replace(cfg.solver, pallas_interpret=True)
    lcfg = dataclasses.replace(cfg.lmpc, sysid_interpret=True)
    trk = make_track(device="cpu")
    ctrl = lmpc_mod.make_lmpc(lcfg, trk, solver, cfg.sim.dt)
    st = lmpc_mod.init_lmpc_state(lcfg, B, solver=solver, device="cpu")
    seeds, _ = tbench.load_converged(device="cpu")
    for x, u, xg, n in seeds:
        st = lmpc_mod.lmpc_add_trajectory(
            st, lcfg, *(a[None].expand(B, -1, -1) for a in (x, u, xg)),
            n.to(torch.int32).expand(B), trk.total_len)
    plant = exp.initial_plant(B, device="cpu")
    table = track_table(trk)

    def run():
        gen = torch.Generator().manual_seed(5)
        noise = loop.gaussian_noise(B, 0, cfg.sim, gen, device="cpu")

        def runner(s, p, done, step0):
            return loop.run_lap(ctrl.step, s, p, trk=trk, vp=VehicleParams(),
                                sim_cfg=cfg.sim, max_steps=2, done0=done,
                                step0=step0, noise=noise, table=table,
                                collect_fn=lambda s: s.iters)
        return exp.run_lap_chunked(runner, st, plant, STEPS, 2, STEPS)
    return run


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return []


class _Clock:
    def __init__(self):
        self.calls = 0

    def time_ns(self):
        self.calls += 1
        return 0


def test_disarmed_steps_record_nothing(lap, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)
    before = cuda_qp.rescue_work.values()
    lap()
    assert clock.calls == 0 and not tracing.armed() and tracing._rec is None
    assert tracing.span("a") is tracing.span("b")       # the shared no-op
    assert cuda_qp.rescue_work.values() == before


def test_armed_steps_give_the_same_bits_and_nested_spans(lap):
    off = _leaves(lap())
    with tracing.session(device="cpu") as rec:
        on = _leaves(lap())
    assert len(off) == len(on) and all(torch.equal(a, b)
                                       for a, b in zip(off, on))
    spans = rec.spans
    names = {s.name for s in spans}
    assert names >= {"lap.noise", "lap.plant", "lap.freeze", "lap.exit",
                     "ctrl.step", "ctrl.terminal_set", "ctrl.sysid",
                     "ctrl.assemble", "ctrl.accept", "qp.solve",
                     "qp.prologue", "qp.ruiz", "qp.build_k", "qp.ns",
                     "qp.admm", "qp.finish"}
    parent = {"ctrl.terminal_set": "ctrl.step", "ctrl.sysid": "ctrl.step",
              "ctrl.assemble": "ctrl.step", "ctrl.accept": "ctrl.step",
              "qp.solve": "ctrl.step", "qp.prologue": "qp.solve",
              "qp.ruiz": "qp.prologue", "qp.build_k": "qp.prologue",
              "qp.ns": "qp.prologue", "qp.admm": "qp.solve",
              "qp.finish": "qp.solve"}
    for s in spans:
        want = parent.get(s.name)
        if want is None:
            assert s.parent == -1, s
        else:
            p = spans[s.parent]
            assert p.name == want and (p.episode, p.step) == (s.episode,
                                                              s.step)
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    steps = [(s.episode, s.step) for s in spans if s.name == "ctrl.step"]
    assert steps == [(1, t) for t in range(STEPS)]
    assert len({(s.episode, s.step) for s in spans}) == STEPS
    assert sum(s.name == "lap.exit" for s in spans) == 2     # two chunks
    # self time: duration less the children's cover, so each root's
    # subtree's self times add up to the root's duration
    self_ns = tracing.self_ns(spans)
    root = {}
    for i, s in enumerate(spans):
        root[i] = i if s.parent < 0 else root[s.parent]
    for i, s in enumerate(spans):
        if s.parent < 0:
            assert sum(v for j, v in enumerate(self_ns)
                       if root[j] == i) == s.end_ns - s.start_ns
    assert all(v >= 0 for v in self_ns)
    # one Newton-Schulz inverse per solve, each over the batch
    assert rec.counts["ns.lanes"] == B * STEPS
    assert rec.counts["ns.final.passes"] == STEPS
    assert rec.counts["ns.first.passes"] >= 1


def test_self_time_of_nested_spans():
    S = tracing.Span
    spans = [S("a", 0, 100, -1, 1, 0), S("b", 10, 40, 0, 1, 0),
             S("c", 20, 30, 1, 1, 0), S("d", 50, 60, 0, 1, 0),
             S("e", 120, 130, -1, 1, 1)]
    assert tracing.self_ns(spans) == [60, 20, 10, 10, 10]


def _hand_ns(K, X0, warm_ok, tol, max_iters):
    """Per lane, unbatched and in float64: the iterations of the first
    and the restart run of ``qp._ns_inverse``."""
    first, restart = [], []
    n = K.shape[1]
    I = torch.eye(n, dtype=torch.float64)
    for k, x0, w in zip(K.double(), X0.double(), warm_ok.tolist()):
        d = 1.0 / torch.clamp(torch.diagonal(k), min=1e-12)
        cj = float(torch.sqrt(((I - k * d[None, :]) ** 2).sum()))
        Xj = torch.diag(d) / max(cj, 1.0)
        X, r = Xj, 1e5
        if w:
            R0 = I - k @ x0
            v = torch.full((n,), 1.0 / math.sqrt(n), dtype=torch.float64)
            for _ in range(12):
                wv = R0 @ v
                nrm = float(torch.sqrt((wv * wv).sum()))
                v = wv / max(nrm, 1e-30)
            r0 = float(R0.abs().max())
            if math.isfinite(nrm) and nrm < 0.9 and math.isfinite(r0):
                X, r = x0, r0

        def run(X, r):
            it = 0
            while r > tol and r < 1e6 and it < max_iters:
                R = I - k @ X
                X = X + X @ R
                r = float(R.abs().max())
                it += 1
            return X, r, it
        X, r, it = run(X, r)
        first.append(it)
        if not math.isfinite(r) or r > 50 * tol:
            X, r = Xj, 1e5
        restart.append(run(X, r)[2])
    return first, restart


def test_ns_counters_equal_a_hand_count():
    """Lane 0 warm from its exact inverse (no pass), lane 1 warm from a
    perturbed one, lanes 2 and 3 cold; lane 3 ill-conditioned, so its
    first run ends far from tolerance and it restarts from Jacobi."""
    g = torch.Generator().manual_seed(3)
    n, tol, max_iters = 8, 1e-10, 12
    M = torch.randn((4, n, n), generator=g, dtype=torch.float64)
    K = M @ M.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)
    K[3] = K[3] + 400.0 * torch.outer(M[3, 0], M[3, 0])
    inv = torch.linalg.inv(K)
    X0 = inv.clone()
    X0[1] = inv[1] * (1 + 1e-3 * torch.randn((n, n), generator=g,
                                             dtype=torch.float64))
    warm_ok = torch.tensor([True, True, False, False])
    first, restart = _hand_ns(K, X0, warm_ok, tol, max_iters)
    assert first[0] == 0 and 0 < first[1] < first[2] and restart[3] > 0
    with tracing.session(device="cpu") as rec:
        qp_mod._ns_inverse(K, X0, warm_ok, tol, max_iters)
    c = rec.counts
    assert (c["ns.first.passes"], c["ns.first.lane_iters"]) == (
        max(first), sum(first))
    assert (c["ns.restart.passes"], c["ns.restart.lane_iters"]) == (
        max(restart), sum(restart))
    assert (c["ns.final.passes"], c["ns.final.lane_iters"],
            c["ns.lanes"]) == (1, 4, 4)
    assert [s.name for s in rec.spans] == ["qp.ns"]


def test_rescue_counter_counts_the_plain_rescued_lanes():
    """B1's forced rescue on random QPs through the plain version: armed,
    the rescue's counter holds every rescued lane (``flags[:, 2]``), their
    Newton-Schulz iterations and no warm test (B1's pad block); disarmed
    it does not move."""
    qp = random_qps(4, device="cpu")
    scfg = rescue_replay.forced_rescue(
        dataclasses.replace(main_path.config().solver, pallas_interpret=True))
    args, kw = rescue_replay.admm_args(qp, scfg, None, None)
    with tracing.session(device="cpu") as rec:
        out = cuda_qp.admm_iterate(*args, **kw)
    before = cuda_qp.rescue_work.values()
    again = cuda_qp.admm_iterate(*args, **kw)
    assert cuda_qp.rescue_work.values() == before
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    lanes = int(out[6].sum())
    assert lanes == 4 and rec.counts["admm.rescue.lanes"] == lanes
    assert lanes <= rec.counts["admm.rescue.ns_iters"] <= (
        2 * lanes * kw["ns_max_iters"])
    assert rec.counts["admm.rescue.warm_tests"] == 0
    assert [s.name for s in rec.spans] == ["qp.admm"]


def test_spans_share_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile, record_function
    with tracing.session(device="cpu") as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.span("outer"):
                with record_function("inner"):
                    torch.ones(16).sum()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "inner"]
    (s,) = rec.spans
    assert len(ev) == 1
    assert s.start_ns <= ev[0].start_ns()
    assert ev[0].start_ns() + ev[0].duration_ns() <= s.end_ns


# a fixed trace: one step (ctrl.step with qp.admm inside), then the plant
SPANS = [tracing.Span("ctrl.step", 100, 200, -1, 1, 0),
         tracing.Span("qp.admm", 120, 150, 0, 1, 0),
         tracing.Span("lap.plant", 210, 260, -1, 1, 0)]
RUNTIME = [tracing.RuntimeCall(105, 108, "cudaLaunchKernel", 6),
           tracing.RuntimeCall(125, 127, "cudaLaunchKernel", 7),
           tracing.RuntimeCall(160, 190, "cudaStreamSynchronize", 9),
           tracing.RuntimeCall(215, 217, "cudaLaunchKernel", 8),
           tracing.RuntimeCall(262, 264, "cudaMemcpyAsync", 10)]
DEVICE = [tracing.DeviceOp(109, 118, 6, "fill"),
          tracing.DeviceOp(130, 170, 7, "admm_main_resident"),
          tracing.DeviceOp(220, 240, 8, "rollout_kernel"),
          tracing.DeviceOp(266, 268, 10, "Memcpy DtoH")]


def test_overlay_of_a_fixed_trace():
    ov = tracing.overlay(SPANS, DEVICE, RUNTIME, window=(100, 280))
    sp = ov["spans"]
    assert ov["steps"] == 1 and ov["window_ms"] == pytest.approx(180e-6)
    assert ov["busy_ms"] == pytest.approx(71e-6)
    # kernels by their launch call's correlation id
    assert sp["ctrl.step"]["device_ms"] == pytest.approx(9e-6)
    assert sp["qp.admm"]["device_ms"] == pytest.approx(40e-6)
    assert sp["lap.plant"]["device_ms"] == pytest.approx(20e-6)
    assert sp[tracing.OUTSIDE]["device_ms"] == pytest.approx(2e-6)
    # idle gaps by their midpoint's innermost span: [100, 109] and
    # [170, 220] (mid 195) in ctrl.step, [118, 130] (mid 124) in qp.admm,
    # [240, 266] (mid 253) in lap.plant, [268, 280] outside
    assert sp["ctrl.step"]["idle_ms"] == pytest.approx(59e-6)
    assert sp["qp.admm"]["idle_ms"] == pytest.approx(12e-6)
    assert sp["lap.plant"]["idle_ms"] == pytest.approx(26e-6)
    assert sp[tracing.OUTSIDE]["idle_ms"] == pytest.approx(12e-6)
    assert ov["idle_ms"] == pytest.approx(109e-6)
    assert (sp["ctrl.step"]["launches"], sp["qp.admm"]["launches"],
            sp["ctrl.step"]["syncs"]) == (1, 1, 1)
    assert sp["ctrl.step"]["host_self_ms"] == pytest.approx(70e-6)
    assert sp["ctrl.step"]["calls"] == 1 and sp[tracing.OUTSIDE][
        "calls"] == 0
    assert "qp.admm" in tracing.table(ov)


class _Event:
    def __init__(self, name, start, end, act, corr):
        self._v = (name, start, end - start, act, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def activity_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type(
            "R", (), {"events": lambda _self: events})()


def test_overlay_partitions_the_benchmarks_idle_time():
    """On the fixed trace the overlay reads from a profiler (as
    ``profiler_events`` does), its idle time (under spans and outside)
    equals the total of the idle gaps that the benchmark's reduction
    labels over the same window, and it counts the same launches and
    syncs."""
    events = ([_Event(r.name, r.start_ns, r.end_ns, "cuda_runtime",
                      r.correlation) for r in RUNTIME]
              + [_Event(d.name, d.start_ns, d.end_ns,
                        "gpu_memcpy" if d.name.startswith("Memcpy")
                        else "kernel", d.correlation) for d in DEVICE])
    prof = _Prof(events)
    dev, host = tracing.profiler_events(prof)
    assert sorted(dev) == sorted(DEVICE) and sorted(host) == sorted(RUNTIME)
    red = bench_trace.reduce(prof, 180e-9)
    ov = tracing.overlay(SPANS, dev, host, window=(105, 285))
    assert ov["idle_ms"] == pytest.approx(
        1e3 * sum(v for _, v in red["idle_gaps"]))
    assert ov["busy_ms"] == pytest.approx(1e3 * red["busy_s"])
    rows = ov["spans"].values()
    assert sum(r["launches"] for r in rows) == red["launches"] == 3
    assert sum(r["syncs"] for r in rows) == red["syncs"] == 1
    assert np.isclose(sum(r["idle_ms"] for r in rows), ov["idle_ms"])
