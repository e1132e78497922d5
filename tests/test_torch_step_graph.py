"""The controller step without its constant host syncs, and the CUDA-graph
helper (``runtime/step_graph.py``), on the CPU.

- The Ruiz count taken from the factor cache a step is handed
  (``ops/qp.SweepCount``) is the count the step's own tensors gave
  (``int(n_sweeps.max())``), and the solves keep their bits, over a short
  LTV sequence with a refresh (a cache aged 50) and a lane made invalid.
- The input box, the input-rate weights and the noise scales are built
  once: ``_clip_u``, ``assemble_qp`` and ``apply_noise`` make no tensor from
  host data per call, and give the bits of the per-call copies.
- The helper with a CPU stand-in for the capture: fresh outputs, inputs
  untouched, counters that advance on a replay, the eager fallback where a
  capture is refused, and the LTV step through it equal to the eager step.
- ``run_lap`` multi-lap from a fresh start (nothing frozen) equals the
  frozen path with no scenario done.
"""
import dataclasses

import numpy as np
import pytest
import torch

from racinglmpc_tpu_torch.controllers import mpc as mpc_mod
from racinglmpc_tpu_torch.controllers import ocp
from racinglmpc_tpu_torch.models import dynamics, sysid
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import make_track
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import loop, step_graph, tracing
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, MPCConfig,
                                               SimConfig, SolverConfig,
                                               VehicleParams)

torch.set_num_threads(1)
B = 8
SOLVER = dataclasses.replace(SolverConfig.throughput(), pallas_fused_ns=True,
                             pallas_interpret=True)


def _ltv():
    """LTV-MPC at N = 6 over a store of one seeded lap, batch 8, and plant
    states along the lap."""
    g = torch.Generator().manual_seed(5)
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
    cfg = MPCConfig(N=6, dR=(0.3, 1.7), time_varying=True)
    ctrl, st = mpc_mod.make_ltv_mpc(cfg, store, make_track(device="cpu"),
                                    LMPCConfig(model_laps=1, model_pts=128),
                                    SOLVER, 0.1)
    xs = x[3:9, None].expand(-1, B, -1) + 0.01 * torch.randn(
        (6, B, 6), generator=g)
    return ctrl, st, xs


def _age(st, age=None, invalid=None):
    """The state with its cache aged (every lane) or one lane invalid."""
    fac = st.fac
    if age is not None:
        fac = fac._replace(age=torch.full_like(fac.age, age))
    if invalid is not None:
        valid = fac.valid.clone()
        valid[invalid] = False
        fac = fac._replace(valid=valid)
    return st._replace(fac=fac)


def _steps(step, ctrl, st, xs):
    """The sequence: a cold cache, warm steps, a cache aged 50 (every
    lane refreshes), a lane made invalid, a warm step."""
    out = []
    for k, x in enumerate(xs):
        if k == 3:
            st = _age(st, age=50)
        if k == 4:
            st = _age(st, invalid=3)
        st, u = step(ctrl, st, x)
        out.append((st, u))
    return out


def _equal(a, b):
    la, lb = step_graph.leaves(a), step_graph.leaves(b)
    assert len(la) == len(lb)
    return all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(x, y) for x, y in zip(la, lb))


def test_ruiz_count_from_the_cache_is_the_steps_own(monkeypatch):
    ctrl, st, xs = _ltv()
    mine = _steps(lambda c, s, x: c(s, x), ctrl, st, xs)

    real = qp_mod._ruiz_equilibrate
    seen = []

    def parent(qp, total, init=None, sweeps=None):
        # the parent's count: a read of the step's per-lane counts
        n = total if sweeps is None else int(sweeps.max())
        seen.append((total, n))
        return real(qp, n, init=init, sweeps=sweeps)

    monkeypatch.setattr(qp_mod, "_ruiz_equilibrate", parent)
    theirs = _steps(lambda c, s, x: c(s, x), ctrl, st, xs)
    assert [n for _, n in seen] == [10, 2, 2, 10, 10, 2]
    assert all(t == n for t, n in seen)
    for a, b in zip(mine, theirs):
        assert _equal(a, b)


def test_sweep_count_known_and_without_a_cache():
    cfg = SolverConfig.throughput()
    assert qp_mod.SweepCount.of(7).total == 7
    assert qp_mod.SweepCount(cfg, None).total == cfg.scaling_iters
    fac = qp_mod.init_factor_cache(4, 3, 2, device="cpu")
    assert qp_mod.SweepCount(cfg, fac).total == 10          # invalid
    fac = fac._replace(valid=torch.ones(4, dtype=torch.bool),
                       age=torch.tensor([1, 2, 49, 51], dtype=torch.int32))
    assert qp_mod.SweepCount(cfg, fac).total == 2
    fac = fac._replace(age=torch.tensor([1, 100, 3, 4], dtype=torch.int32))
    assert qp_mod.SweepCount(cfg, fac).total == 10


@pytest.fixture
def host_copies(monkeypatch):
    """Counts torch.tensor / torch.as_tensor calls made from host data."""
    calls = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(data, *a, _real=real, _name=name, **k):
            if not isinstance(data, torch.Tensor):
                calls.append(_name)
            return _real(data, *a, **k)
        monkeypatch.setattr(torch, name, counted)
    return calls


def test_constants_are_built_once(host_copies):
    ctrl, st, xs = _ltv()
    cfg, dims, tmpl = ctrl.cfg, ctrl.dims, ctrl.tmpl
    g = torch.Generator().manual_seed(2)
    u = 0.8 * torch.randn((B, 2), generator=g)
    u[0, 1] = 12.0
    dyn = ctrl.sysid(st)
    noise = torch.randn((B, 3), generator=g)
    sim = SimConfig(noise_sigma=(0.02, 0.01, 0.005))
    dynamics.apply_noise(xs[0], noise, sim)        # its scales, once
    del host_copies[:]

    clipped = mpc_mod._clip_u(u, tmpl.u_box)
    qp = ocp.assemble_qp(dims, tmpl, dyn, xs[0], u, tmpl.dR)
    noisy = dynamics.apply_noise(xs[0], noise, sim)
    assert host_copies == []

    # the parent's per-call copies
    bounds = torch.tensor([cfg.delta_max, cfg.a_max])
    assert torch.equal(clipped, torch.clamp(u, -bounds, bounds))
    n = len(host_copies)
    parent = ocp.assemble_qp(dims, tmpl, dyn, xs[0], u, cfg.dR)
    assert host_copies[n:] == ["as_tensor"]         # numbers: copied
    assert _equal(qp, parent)
    sig = torch.as_tensor(sim.noise_sigma, dtype=xs.dtype)
    add = sim.noise_gain * torch.clamp(noise * sig, -sim.noise_clip,
                                       sim.noise_clip)
    assert torch.equal(noisy, torch.cat([xs[0][:, :3] + add, xs[0][:, 3:]],
                                        -1))


def _stand_in(run):
    """A CPU stand-in for a CUDA graph: the outputs live in fixed tensors
    that every replay overwrites."""
    out = run()

    def replay():       # as a graph's: no wrapper counts
        counters = tracing.launch_counters()
        before = [c.n for c in counters]
        with tracing.detached():
            new = run()
        for c, n in zip(counters, before):
            c.n = n
        for d, s in zip(step_graph.leaves(out), step_graph.leaves(new)):
            d.copy_(s)
    return replay, out


def _refused(run):
    raise RuntimeError("operation not permitted when stream is capturing")


COUNTER = tracing.LaunchCounter("test_step_graph_fn")


def _fn(inputs, key):
    """A step: a passthrough, a tensor returned twice, a host count."""
    (a, b), x = inputs
    COUNTER.n += 1
    tracing.count("test.calls")
    y = a * key + x
    return (y, b), y


def _inputs(k):
    g = torch.Generator().manual_seed(k)
    return ((torch.randn(4, 3, generator=g), torch.arange(4)),
            torch.randn(4, 3, generator=g))


@pytest.mark.parametrize("capture", [_stand_in, _refused])
def test_helper_returns_fresh_tensors(capture):
    sg = step_graph.StepGraph(_fn, capture=capture)
    COUNTER.reset()
    held, kept = [], []
    refused = capture is _refused
    with pytest.warns(UserWarning, match="refused") if refused else \
            _nothing():
        for k in range(8):
            inp = _inputs(k)
            copy = step_graph.fresh(inp)
            out = sg(inp, lambda static: 2 if k % 3 else 3)
            key = 2 if k % 3 else 3
            (a, b), x = copy
            assert _equal(out, ((a * key + x, b), a * key + x))
            assert _equal(inp, copy)                  # the inputs untouched
            ptrs = {t.data_ptr() for t in step_graph.leaves(inp)}
            (y, bo), y2 = out
            assert y is y2 and bo is not inp[0][1]
            for t in (y, bo):
                assert t.data_ptr() not in ptrs
            held.append(out)
            kept.append(step_graph.fresh(out))
    for out, copy in zip(held, kept):                 # never written again
        assert _equal(out, copy)
    assert COUNTER.n == 8


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_helper_counts_a_replay_as_its_capture():
    sg = step_graph.StepGraph(_fn, capture=_stand_in)
    COUNTER.reset()
    r0 = tracing.graph_replays.n
    c0 = tracing.graph_captures.n
    with tracing.session() as rec:
        for k in range(5):
            sg(_inputs(k), lambda static: 2)
    assert COUNTER.n == 5
    assert tracing.graph_captures.n - c0 == 1
    assert tracing.graph_replays.n - r0 == 4
    assert rec.counts["test.calls"] == 5
    assert rec.counts["ctrl.graph.replays"] == 4
    assert rec.counts["ctrl.graph.captures"] == 1
    names = {s.name for s in rec.spans}
    assert names == {"ctrl.graph"}


def test_ltv_step_through_the_helper_equals_the_eager_step():
    ctrl, st, xs = _ltv()
    assert not ctrl.graphed(st)                      # the CPU runs eagerly
    sg = step_graph.StepGraph(ctrl._graph_step, capture=_stand_in)
    graphed = _steps(lambda c, s, x: sg((s, x), c._graph_key), ctrl, st, xs)
    eager = _steps(lambda c, s, x: c.step(s, x), ctrl, st, xs)
    for a, b in zip(graphed, eager):
        assert _equal(a, b)
    assert len(sg._graphs) == 2                      # 10 sweeps and 2


def _toy_step(st, x, _draw):
    """A controller whose state moves with the plant's."""
    u = torch.stack([0.1 * torch.sin(x[:, 5]), 0.3 - 0.1 * x[:, 0]], -1)
    return (st[0] + x[:, :2], st[1] + 1), u


def test_run_lap_multi_lap_fresh_start_freezes_nothing():
    trk = make_track(device="cpu")
    sim = SimConfig(substeps=5)
    x0 = torch.tensor([[0.5, 0.0, 0.0, 0.0, 0.1 * i, 0.0]
                       for i in range(4)])
    plant = PlantState(x=x0, x_glob=x0.clone())
    st = (torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32))

    def noise(t):
        g = torch.Generator().manual_seed(t)
        return None, torch.randn((4, 3), generator=g)
    kw = dict(trk=trk, vp=VehicleParams(), sim_cfg=sim, max_steps=6,
              multi_lap=True, noise=noise, collect_fn=lambda s: s[0])
    fresh = loop.run_lap(_toy_step, st, plant, **kw)
    frozen = loop.run_lap(_toy_step, st, plant,
                          done0=torch.zeros(4, dtype=torch.bool), **kw)
    assert _equal(tuple(fresh), tuple(frozen))
    assert bool(fresh.mask.all()) and np.all(fresh.steps.numpy() == 6)
