"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (every kernel
needs one; there is no interpret mode). On a machine with a card
(``--noconftest``: ``tests/conftest.py`` imports JAX, which these tests do
not need):

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

import chip_smoke

from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.controllers import mpc as mpc_mod
from racinglmpc_tpu_torch.models import dynamics, sysid
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.ops import (cuda_build, cuda_ns, cuda_qp,
                                      cuda_qp_fused, cuda_rollout,
                                      cuda_sysid)
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import (loop, main_path, rescue_replay,
                                          stage_path, step_graph, tracing)
from racinglmpc_tpu_torch.utils.config import SolverConfig, VehicleParams
from racinglmpc_tpu_torch.utils.qp_cases import random_qps

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
B = 16


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    mp, st, plant, _ = main_path.setup(B, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x0 = plant.x + 0.01 * torch.randn(plant.x.shape, generator=g,
                                      device="cuda")
    return mp.cfg, mp.trk, st, x0


def test_rollout_matches_plain(setup):
    cfg, trk, _, x0 = setup
    u = torch.full((B, 2), 0.1, device="cuda")
    k = cuda_rollout.plant_step_batch(x0, x0.clone(), u, VehicleParams(),
                                      trk, cfg.sim, table=track_table(trk))
    p = cuda_rollout.plant_step_batch_plain(x0, x0.clone(), u,
                                            VehicleParams(), trk, cfg.sim)
    for a, b in zip(k, p):
        assert float((a - b).abs().max()) < 1e-4


def test_sysid_matches_plain(setup):
    cfg, trk, st, _ = setup
    xl = st.x_lin[:, :cfg.lmpc.N].contiguous()
    ul = st.u_lin.contiguous()
    steps = st.store.steps.clone()
    steps[:, 2] = sysid._EMPTY
    for store in (st.store, st.store._replace(steps=steps)):
        k = cuda_sysid.local_linearization_horizon(store, trk, xl, ul,
                                                   cfg.lmpc, 0.1)
        p = cuda_sysid.local_linearization_horizon_plain(store, trk, xl, ul,
                                                         cfg.lmpc, 0.1)
        for a, b in zip(k, p):
            assert float((a - b).abs().max()) < 1e-3


def _sysid_vs_plain(cfg, trk, st, store):
    xl = st.x_lin[:, :cfg.lmpc.N].contiguous()
    ul = st.u_lin.contiguous()
    k = cuda_sysid.local_linearization_horizon(store, trk, xl, ul, cfg.lmpc,
                                               0.1)
    p = cuda_sysid.local_linearization_horizon_plain(store, trk, xl, ul,
                                                     cfg.lmpc, 0.1)
    return k, max(float((a - b).abs().max()) for a, b in zip(k, p))


def test_sysid_store_of_1024_rows(setup):
    """The default model_pts: the store zero-padded to T = 1024 (two lap
    buffers still fit two CTAs per SM)."""
    cfg, trk, st, _ = setup
    pad = (0, 0, 0, 1024 - st.store.x.shape[2])
    store = sysid.LapStore(torch.nn.functional.pad(st.store.x, pad),
                           torch.nn.functional.pad(st.store.u, pad),
                           st.store.steps)
    assert _sysid_vs_plain(cfg, trk, st, store)[1] < 1e-3


def test_sysid_ties_go_to_the_first_index(setup):
    """Rows 2i and 2i+1 share their features but not their successors, so
    the 7th pick of a lap (one row of a tied pair) decides C: taking the
    later index would give it another successor."""
    cfg, trk, st, _ = setup
    x, u = st.store.x.clone(), st.store.u.clone()
    T = x.shape[2]
    src = torch.arange(T, device="cuda") // 2
    x[:, :, :, :3] = st.store.x[:, :, src, :3]
    u[:] = st.store.u[:, :, src]
    store = sysid.LapStore(x, u, st.store.steps)
    assert _sysid_vs_plain(cfg, trk, st, store)[1] < 1e-3


def test_sysid_ragged_and_empty_laps(setup):
    """A lap with fewer valid rows than knn (its other picks weigh 0), a
    short lap and an empty one."""
    cfg, trk, st, _ = setup
    steps = st.store.steps.clone()
    steps[:, 0] = 4
    steps[:, 1] = 37
    steps[:, 3] = sysid._EMPTY
    store = st.store._replace(steps=steps)
    assert _sysid_vs_plain(cfg, trk, st, store)[1] < 1e-3


def test_rollout_crosses_a_segment_and_the_finish_line(setup):
    """Scenarios that leave a segment, and the track, inside one period:
    the carried segment index must be found again."""
    cfg, trk, _, x0 = setup
    table = track_table(trk)
    x = x0.clone()
    x[:, 0] = 1.0
    x[:, 1:4] = 0.0
    x[:, 5] = 0.05
    starts = [table.s0[1 + i % (len(table.s0) - 1)] for i in range(B // 2)]
    x[0::2, 4] = torch.tensor(starts, device="cuda") - 0.02
    x[1::2, 4] = table.total_len - 0.03
    u = torch.full((B, 2), 0.05, device="cuda")
    k = cuda_rollout.plant_step_batch(x, x.clone(), u, VehicleParams(), trk,
                                      cfg.sim, table=table)
    p = cuda_rollout.plant_step_batch_plain(x, x.clone(), u,
                                            VehicleParams(), trk, cfg.sim)
    for a, b in zip(k, p):
        assert float((a - b).abs().max()) < 1e-4
    assert bool((k[0][1::2, 4] > table.total_len).all())
    seg = torch.tensor(table.s0, device="cuda")
    assert bool((torch.searchsorted(seg, k[0][0::2, 4].contiguous(),
                                    right=True)
                 > torch.searchsorted(seg, x[0::2, 4].contiguous(),
                                      right=True)).all())


def test_rollout_and_sysid_same_bits_twice(setup):
    cfg, trk, st, x0 = setup
    u = torch.full((B, 2), 0.1, device="cuda")
    runs = [cuda_rollout.plant_step_batch(x0, x0.clone(), u, VehicleParams(),
                                          trk, cfg.sim, table=track_table(trk))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    runs = [_sysid_vs_plain(cfg, trk, st, st.store)[0] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_sysid_plan_matches_kernel_source(setup):
    cfg, _, st, _ = setup
    K, T = st.store.x.shape[1:3]
    N = cfg.lmpc.N
    for rows in (T, 1024):
        for knn in (cuda_sysid.MAX_KNN, cuda_sysid.MAX_KNN + 1, 40):
            pl = cuda_sysid.plan(K, rows, N, B, knn)
            assert cuda_sysid.smem_bytes_on_card(rows, N, pl.nbuf,
                                                 knn) == pl.nbytes
            assert cuda_sysid.ctas_per_sm_on_card(rows, N, pl.nbuf,
                                                  knn) == pl.ctas_per_sm


@pytest.mark.parametrize("knn", [cuda_sysid.MAX_KNN + 1, 40])
def test_sysid_knn_above_the_list_takes_the_rescan_instance(setup, knn):
    """knn_max above a lane's list (one chunk of picks, and two): the
    controller's step launches B2's rescan instance once, which agrees with
    the plain version on the store and on tied rows, with equal bits over
    two calls."""
    cfg, trk, st, x0 = setup
    lcfg = dataclasses.replace(cfg.lmpc, knn_max=knn)
    ctrl = lmpc_mod.make_lmpc(lcfg, trk, cfg.solver, 0.1)
    assert ctrl.use_kernel_sysid
    cuda_sysid.launches.reset()
    _, u = ctrl.step(st, x0)
    torch.cuda.synchronize()
    assert cuda_sysid.launches.n == 1
    assert bool(torch.isfinite(u).all())
    c = dataclasses.replace(cfg, lmpc=lcfg)
    x = st.store.x.clone()
    src = torch.arange(x.shape[2], device="cuda") // 2
    x[:, :, :, :3] = st.store.x[:, :, src, :3]
    ties = sysid.LapStore(x, st.store.u[:, :, src].contiguous(),
                          st.store.steps)
    for store in (st.store, ties):
        k, err = _sysid_vs_plain(c, trk, st, store)
        assert err < 1e-3
        assert _same_bits(k, _sysid_vs_plain(c, trk, st, store)[0])


def test_sysid_model_pts_off_the_gate_takes_the_plain_path(setup):
    """model_pts = 511 with use_pallas_sysid: off the reference's gate, so
    the controller's step takes the plain sys-ID (no B2 launch)."""
    cfg, trk, st, x0 = setup
    lcfg = dataclasses.replace(cfg.lmpc, model_pts=511)
    assert lcfg.use_pallas_sysid
    ctrl = lmpc_mod.make_lmpc(lcfg, trk, cfg.solver, 0.1)
    assert not ctrl.use_kernel_sysid
    cuda_sysid.launches.reset()
    _, u = ctrl.step(st, x0)
    torch.cuda.synchronize()
    assert cuda_sysid.launches.n == 0
    assert bool(torch.isfinite(u).all())


@pytest.fixture(scope="module")
def ltv_cell():
    """The benchmark's LTV cell (``ltv_b256.pid_store``) at batch 8: the
    PID lap's store (K = 1, T = 512), N = 14, knn 7, float32, B4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from lmpc_bench import spec
    from lmpc_bench.stages import ltv
    return ltv.setup(spec.cell("ltv_b256.pid_store"), "cuda", batch=8)


def _ltv_sysid_plain(ctrl, state):
    return cuda_sysid.local_linearization_horizon_plain(
        ctrl.store, ctrl.trk, state.x_lin[:, :ctrl.cfg.N], state.u_lin,
        ctrl.lmpc_cfg, ctrl.dt_ctrl)


def test_ltv_step_launches_sysid_once(ltv_cell):
    """One LTV step at the cell's shapes launches B2 once; its models agree
    with the plain sys-ID's within 1e-3, before and after the roll."""
    s = ltv_cell
    ctrl, st = s.ctrl, s.state0
    assert tuple(ctrl.store.x.shape) == (8, 1, 512, 6)
    assert ctrl.cfg.N == 14 and ctrl.lmpc_cfg.knn_max == 7
    cuda_sysid.launches.reset()
    new, u = ctrl(st, s.plant0.x)
    torch.cuda.synchronize()
    assert cuda_sysid.launches.n == 1
    assert bool(torch.isfinite(u).all())
    for state in (st, new):
        k = ctrl.sysid(state)
        for a, b in zip(k, _ltv_sysid_plain(ctrl, state)):
            assert float((a - b).abs().max()) < 1e-3
    assert cuda_sysid.launches.n == 3


def test_ltv_store_off_the_kernel_raises(ltv_cell):
    """A float32 store on the card that B2 cannot take (an odd T) raises in
    the LTV step's sys-ID: no quiet fall back to the plain version."""
    s = ltv_cell
    st = s.ctrl.store
    store = sysid.LapStore(st.x[:, :, :511].contiguous(),
                           st.u[:, :, :511].contiguous(),
                           st.steps.clamp(max=511))
    ctrl = dataclasses.replace(s.ctrl, store=store)
    cuda_sysid.launches.reset()
    with pytest.raises(ValueError, match="T must be even"):
        ctrl.sysid(s.state0)
    assert cuda_sysid.launches.n == 0


def test_ltv_float64_controller_takes_the_plain_sysid(ltv_cell):
    """The same controller in float64: no B2 launch, the plain sys-ID's
    bits."""
    s = ltv_cell
    store = sysid.LapStore(s.ctrl.store.x.double(), s.ctrl.store.u.double(),
                           s.ctrl.store.steps)
    trk = make_track(dtype=torch.float64, device="cuda")
    ctrl, st = mpc_mod.make_ltv_mpc(s.mcfg, store, trk, s.lcfg, s.solver,
                                    s.sim.dt, dtype=torch.float64)
    cuda_sysid.launches.reset()
    new, u = ctrl(st, s.plant0.x.double())
    torch.cuda.synchronize()
    assert cuda_sysid.launches.n == 0
    assert bool(torch.isfinite(u).all())
    for a, b in zip(ctrl.sysid(new), _ltv_sysid_plain(ctrl, new)):
        assert torch.equal(a, b)
    assert cuda_sysid.launches.n == 0


def _launch_counts() -> dict:
    return {c.name: c.n for c in tracing.launch_counters()
            if not c.name.startswith("ctrl.graph")}


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}


def test_ltv_graph_equals_the_eager_step_at_256_lanes():
    """300 steps of the LTV cell's set-up at batch 256 in lockstep, the
    step replayed as CUDA graphs against the same step run eagerly: every
    output and state field equal bit for bit (the Ruiz count 10 on the
    cold and refresh steps, 2 elsewhere), the launch counters advanced
    alike, two captures, and what a step returned unchanged five steps
    later."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from lmpc_bench import spec
    from lmpc_bench.stages import ltv
    s = ltv.setup(spec.cell("ltv_b256.pid_store"), "cuda")
    ctrl = s.ctrl
    assert ctrl.graphed(s.state0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1303)
    caps, reps = tracing.graph_captures.n, tracing.graph_replays.n
    sg = se = s.state0
    pg = pe = s.plant0
    dg, de, sweeps, held = {}, {}, [], {}
    for t in range(300):
        sweeps.append(qp_mod.SweepCount(ctrl.solver_cfg, sg.fac).total)
        c0 = _launch_counts()
        new_g, ug = ctrl(sg, pg.x)
        c1 = _launch_counts()
        new_e, ue = ctrl.step(se, pe.x)
        c2 = _launch_counts()
        for k, v in _delta(c0, c1).items():
            dg[k] = dg.get(k, 0) + v
        for k, v in _delta(c1, c2).items():
            de[k] = de.get(k, 0) + v
        lg = (ug,) + tuple(new_g._asdict().values())
        le = (ue,) + tuple(new_e._asdict().values())
        names = ("u",) + new_g._fields
        for name, a, b in zip(names, lg, le):
            for x, y in zip(step_graph.leaves(a), step_graph.leaves(b)):
                assert x.dtype == y.dtype and torch.equal(x, y), (t, name)
        if t % 50 == 7:
            held[t] = (new_g, ug, step_graph.fresh((new_g, ug)))
        for k in [k for k in held if k + 5 == t]:
            out, u, copy = held.pop(k)
            for x, y in zip(step_graph.leaves((out, u)),
                            step_graph.leaves(copy)):
                assert torch.equal(x, y), k
        draws = torch.randn((256, 3), generator=gen, device="cuda")
        pg = loop.plant_step(pg, ug, s.vp, s.trk, s.sim, draws, s.table)
        pe = loop.plant_step(pe, ue, s.vp, s.trk, s.sim, draws, s.table)
        sg, se = new_g, new_e
    torch.cuda.synchronize()
    assert not held
    assert sweeps.count(10) >= 6 and sweeps.count(2) >= 280
    assert dg == de and dg["fused_admm"] == 300 and dg["sysid"] == 300
    assert tracing.graph_captures.n - caps == 2
    assert tracing.graph_replays.n - reps == 298


def test_rollout_with_batched_vehicle_params(setup):
    """use_pallas_rollout with a (B,) vehicle parameter: the plain plant
    step runs (no B3 launch), equal to dynamics.plant_step."""
    cfg, trk, _, x0 = setup
    vp = VehicleParams(m=torch.linspace(1.9, 2.1, B, device="cuda"))
    sim = dataclasses.replace(cfg.sim, use_pallas_rollout=True, noise=False)
    plant = dynamics.PlantState(x=x0, x_glob=x0.clone())
    u = torch.full((B, 2), 0.1, device="cuda")
    cuda_rollout.launches.reset()
    out = loop.plant_step(plant, u, vp, trk, sim, None, track_table(trk))
    torch.cuda.synchronize()
    assert cuda_rollout.launches.n == 0
    ref = dynamics.plant_step(plant, u, vp, trk, sim)
    assert torch.equal(out.x, ref.x) and torch.equal(out.x_glob, ref.x_glob)
    assert bool(torch.isfinite(out.x).all())


def test_admm_matches_plain(setup):
    cfg, trk, st, x0 = setup
    ctrl = lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver, 0.1)
    qp = ctrl.build_qp(st, x0)[0]
    names = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0",
             "z0", "y0")
    fixed = dataclasses.replace(cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    for scfg in (fixed, cfg.solver):
        pro, kinv, _ = qp_mod.admm_inputs(qp, scfg)
        kw = qp_mod.kernel_args(pro, kinv, scfg)
        args = [kw.pop(n) for n in names]
        k = cuda_qp.admm_iterate(*args, **kw)
        p = cuda_qp.admm_iterate_plain(*args, **kw)
        assert float((k[0] - p[0]).abs().max()) < 3e-2
        assert bool(k[5].all()) or scfg is fixed
    with pytest.raises(ValueError, match="contiguous"):
        cuda_qp.admm_iterate(args[0].transpose(1, 2), *args[1:], **kw)


ADMM_NAMES = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0",
              "z0", "y0")


@pytest.mark.parametrize("layout", ["resident", "stream"])
def test_rescue_counter_counts_the_rescued_lanes(setup, layout):
    """B1's forced rescue on the main path's FTOCPs: with the rescue's
    work counter armed the kernel gives the same bits as with its pointer
    null, counts every lane ``flags[:, 2]`` marks, and as many as the
    plain version counts."""
    cfg, trk, st, x0 = setup
    ctrl = lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver, 0.1)
    qp = ctrl.build_qp(st, x0)[0]
    args, kw = rescue_replay.admm_args(
        qp, rescue_replay.forced_rescue(cfg.solver), None, None)
    off = cuda_qp.admm_iterate(*args, **kw, layout=layout)
    with tracing.session() as rec:
        on = cuda_qp.admm_iterate(*args, **kw, layout=layout)
    with tracing.session() as rec_plain:
        cuda_qp.admm_iterate_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    lanes = int(off[6].sum())
    c = rec.counts
    assert lanes == B and c["admm.rescue.lanes"] == lanes
    for k in ("lanes", "ns_iters", "warm_tests"):
        assert c[f"admm.rescue.{k}"] == rec_plain.counts[f"admm.rescue.{k}"]
    assert lanes <= c["admm.rescue.ns_iters"] <= 2 * lanes * kw[
        "ns_max_iters"]
    assert c["admm.rescue.warm_tests"] == 0
    assert lanes <= c["admm.rescue.ctas"] <= 8 * lanes


def _rescue_split_runs(run, args, n, m):
    """``run(args)`` (a kernel call) on lanes of ``args`` (FTOCPs of n
    variables and m constraints) that rescue every lane, cycled from its
    first: 3 lanes, then one more than each cluster launch but the last
    takes, then 256; armed, each run's lanes take a cluster of the split
    its count calls for each, 256 one CTA each. Returns each run's output
    and the warm tests it counted."""
    _, tiers = cuda_qp.rescue_plan_on_card(n, m)
    assert tuple(c for c, _ in tiers) == cuda_qp.rescue_splits(n) == (8, 4,
                                                                       2)
    assert 3 <= tiers[0][1] and tiers[-1][1] < 256
    counts = [(3, tiers[0][0])] + [(hi + 1, c) for (_, hi), (c, _) in
                                   zip(tiers, tiers[1:])] + [(256, 1)]
    B0 = args[0].shape[0]
    outs, warm = [], []
    for F, split in counts:
        with tracing.session() as rec:
            out = run(rescue_replay.lanes(
                args, torch.arange(F, device="cuda") % B0))
        assert rec.counts["admm.rescue.lanes"] == F
        assert rec.counts["admm.rescue.ctas"] == F * split
        outs.append(out)
        warm.append(rec.counts["admm.rescue.warm_tests"])
    return outs, warm


def test_rescue_split_keeps_the_bits_main_path(setup):
    """B1's rescue prologue on the main path's FTOCPs (n = 200), every lane
    rescued: 3 lanes, each on a cluster of 8 CTAs, give the bits they get
    among more lanes on clusters of 4 and of 2, and as 3 of 256 lanes on
    one CTA each (every output of ``admm_iterate`` and the rescue's
    inverse in the workspace); the inverse lies within the
    refreshed-inverse gate, 50 ns_tol of max|I - K2 X|, as the plain
    version's does."""
    cfg, trk, st, x0 = setup
    ctrl = lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver, 0.1)
    qp = ctrl.build_qp(st, x0)[0]
    args, kw = rescue_replay.admm_args(
        qp, rescue_replay.forced_rescue(cfg.solver), None, None)
    n = args[0].shape[1]

    def run(a):
        ws = torch.zeros((a[0].shape[0], 4, n, n), device="cuda")
        return cuda_qp.admm_iterate(*a, **kw, workspace=ws), ws[:, 0]

    ((few, wf), *rest), _ = _rescue_split_runs(run, args, n,
                                               args[2].shape[1])
    assert bool(few[6].all())
    for many, wm in rest:
        assert bool(many[6].all())
        for a, b in zip(few, many):
            assert torch.equal(a, b[:3])
        assert torch.equal(wf, wm[:3])
    P, A, Kinv, rho = (t[:3] for t in (args[0], args[2], args[1], args[6]))
    s = kw["rescue_rho_scale"]
    X = cuda_qp._rescue_kinv(P, A, Kinv, torch.zeros(3, device="cuda"), rho,
                             kw["sigma"], s, kw["ns_tol"], kw["ns_max_iters"])
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    K2 = (P.double() + kw["sigma"] * eye + s * A.double().transpose(1, 2)
          @ (A.double() * rho.double()[:, :, None]))
    for inv in (wf, X):
        assert float((eye - K2 @ inv.double()).abs().amax()) < 50 * kw[
            "ns_tol"]


@pytest.mark.parametrize("scale", [None, 1.0])
def test_rescue_split_keeps_the_bits_ltv_stage(stages, scale):
    """B4's launch of B1's rescue on the LTV stage's FTOCPs (n = 146),
    every lane rescued: 3 lanes on clusters of 8 give every output of
    ``admm_iterate_fused`` that they give among more lanes on clusters of
    4 and of 2, and as 3 of 256 lanes on one CTA each. At the solver's
    rescue rho scale the pad block rules the warm test out; at a scale of
    1 every lane runs it (B4's refreshed inverse carries its pad block as
    the scalar 1, which over s = 1 leaves that block no residual), so each
    cluster's CTAs decide the warm start together from one residual that
    none of them overwrites before all have read it."""
    cfg, trk, res = stages
    f = stage_path.stage_ftocps(res, cfg, "ltv", trk)
    forced = dataclasses.replace(cfg.solver, rescue_trigger=0.0)
    if scale is not None:
        forced = dataclasses.replace(forced, rescue_rho_scale=scale)
    kw = qp_mod.fused_inputs(f.qp, forced, f.warm, f.fac)
    args = [kw.pop(n) for n in FUSED_NAMES]
    n = args[0].shape[1]
    assert n == 146 and kw["rescue_max_iter"] > 0
    (few, *rest), warm = _rescue_split_runs(
        lambda a: cuda_qp_fused.admm_iterate_fused(*a, **kw), args, n,
        args[1].shape[1])
    F = [3] + [len(m.rescued) for m in rest]
    assert warm == (F if scale == 1.0 else [0] * len(F))
    assert bool(few.rescued.all())
    for many in rest:
        assert bool(many.rescued.all())
        for a, b in zip(few, many):
            assert torch.equal(a, b[:3])


def test_rescue_plan_matches_kernel_source():
    """The rescue prologue's splits, bands and shared memory as the kernel
    source computes them equal :func:`cuda_qp.rescue_splits`,
    :func:`cuda_qp.rescue_band` and :func:`cuda_qp.rescue_smem`; each
    cluster launch takes more rescued lanes than the one before, and all
    of them fewer than the forced rescue's 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for n, m in ((1, 1), (8, 6), (9, 6), (30, 26), (146, 202), (200, 257)):
        smem, tiers = cuda_qp.rescue_plan_on_card(n, m)
        assert smem == cuda_qp.rescue_smem(n, m)
        assert tuple(c for c, _ in tiers) == cuda_qp.rescue_splits(n)
        his = [hi for _, hi in tiers]
        assert his == sorted(set(his)) and all(0 < h < 256 for h in his)
        for c in cuda_qp.rescue_splits(n) + (1,):
            for rank in range(c):
                assert cuda_qp.rescue_band_on_card(n, c, rank) == \
                    cuda_qp.rescue_band(n, c, rank)


@pytest.mark.parametrize("prec", ["bf16x3", "default"])
def test_admm_iteration_precision_matches_plain(setup, prec):
    """B1 at a lowered iteration precision, both layouts, against the plain
    version as ``chip_smoke.py`` phase 3 holds it (within twice the plain
    version's own spread under float64 accumulation at bf16x3; the median
    lane after one iteration at default, which diverges); two calls give
    the same bits; the main kernel's instantiation runs one CTA per SM."""
    cfg, trk, st, x0 = setup
    ctrl = lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver, 0.1)
    qp = ctrl.build_qp(st, x0)[0]
    its = chip_smoke.FIXED_ITERS[prec]
    fixed = dataclasses.replace(cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=its, check_every=its,
                                rescue_max_iter=0,
                                pallas_iter_precision=prec)
    pro, kinv, _ = qp_mod.admm_inputs(qp, fixed)
    kw = qp_mod.kernel_args(pro, kinv, fixed)
    args = [kw.pop(n) for n in ADMM_NAMES]
    p = cuda_qp.admm_iterate_plain(*args, **kw)
    for layout in cuda_qp.LAYOUTS:
        cuda_qp.precision_launches[prec].reset()
        k = cuda_qp.admm_iterate(*args, **kw, layout=layout)
        assert cuda_qp.precision_launches[prec].n == 1
        assert _same_bits(k, cuda_qp.admm_iterate(*args, **kw,
                                                  layout=layout))
        n, m = qp.q.shape[1], qp.l.shape[1]
        assert cuda_qp.ctas_per_sm_on_card(
            n, m, cuda_qp.pick_layout(n, m, layout), prec) == 1
    with chip_smoke.float64_products(cuda_qp):
        c = cuda_qp.admm_iterate_plain(*args, **kw)
    for layout in cuda_qp.LAYOUTS:
        k = cuda_qp.admm_iterate(*args, **kw, layout=layout)
        ok, detail, _ = chip_smoke.variant_agrees(torch, prec, k[0], p[0],
                                                  c[0])
        assert ok, detail


@pytest.mark.parametrize("kernel,layout", [("admm", "resident"),
                                           ("admm", "stream"),
                                           ("fused_admm", None)])
def test_iteration_precision_one_iteration_random_qps(kernel, layout):
    """B1 (each layout) and B4 at each lowered precision after one
    iteration on random QPs, as ``chip_smoke.py`` phases 3 and 6 hold them:
    within the ``SHARP`` limits of the plain version, every other
    precision's kernel beyond them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    run_k, run_p = chip_smoke.sharp_runs(qp_mod, cuda_qp, cuda_qp_fused,
                                         kernel, layout)
    xs = {prec: run_k(prec) for prec in cuda_qp.ITER_PRECISIONS}
    for prec in chip_smoke.VARIANTS:
        ok, detail, _ = chip_smoke.sharp_agrees(
            prec, xs, *chip_smoke.sharp_plain(cuda_qp, run_p, prec))
        assert ok, (prec, detail)


@pytest.mark.parametrize("prec", ["bf16x3", "default"])
def test_admm_iteration_precision_at_tolerance(setup, prec):
    """B1 at a lowered precision at the main path's tolerance solves as
    many FTOCPs in as many iterations as its plain version
    (``chip_smoke.tolerance_agrees``)."""
    cfg, trk, st, x0 = setup
    ctrl = lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver, 0.1)
    qp = ctrl.build_qp(st, x0)[0]
    scfg = dataclasses.replace(cfg.solver, pallas_iter_precision=prec)
    pro, kinv, _ = qp_mod.admm_inputs(qp, scfg, (st.warm_x, st.warm_y),
                                      st.fac)
    kw = qp_mod.kernel_args(pro, kinv, scfg)
    args = [kw.pop(n) for n in ADMM_NAMES]
    k = cuda_qp.admm_iterate(*args, **kw)
    p = cuda_qp.admm_iterate_plain(*args, **kw)
    ok, detail = chip_smoke.tolerance_agrees(k[5], k[4], p[5], p[4])
    assert ok, detail


def test_admm_highest_is_the_default_and_unchanged(setup):
    """``iter_precision="highest"`` is the call without it (same bits), held
    to the plain version at the reference kernels' 3e-2."""
    cfg, trk, st, x0 = setup
    ctrl = lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver, 0.1)
    qp = ctrl.build_qp(st, x0)[0]
    fixed = dataclasses.replace(cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    pro, kinv, _ = qp_mod.admm_inputs(qp, fixed)
    kw = qp_mod.kernel_args(pro, kinv, fixed)
    assert kw.pop("iter_precision") == "highest"
    args = [kw.pop(n) for n in ADMM_NAMES]
    k = cuda_qp.admm_iterate(*args, **kw)
    assert _same_bits(k, cuda_qp.admm_iterate(*args, **kw,
                                              iter_precision="highest"))
    p = cuda_qp.admm_iterate_plain(*args, **kw)
    assert float((k[0] - p[0]).abs().max()) < 3e-2


FUSED_NAMES = ("P", "A", "kinv0", "warm_ok", "q", "l", "u", "rho", "D", "E",
               "c", "x0", "z0", "y0")


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _kinv_residual_ok(args, k, kw):
    """max|I - K Kinv| < 50 ns_tol for the kernel's refreshed inverse
    (chip_smoke.py phase 6's gate)."""
    K = cuda_qp_fused.build_k(args[0], args[1], args[7], kw["sigma"])
    eye = torch.eye(K.shape[-1], device=K.device)
    assert float((eye - K @ k.kinv).abs().amax()) < 50 * kw["ns_tol"]


def _fused_vs_plain(qp, cfg, warm=None, fac=None):
    fixed = dataclasses.replace(cfg, eps_abs=0.0, eps_rel=0.0, max_iter=16,
                                check_every=16, rescue_max_iter=0)
    outs = []
    for scfg in (fixed, cfg):
        kw = qp_mod.fused_inputs(qp, scfg, warm, fac)
        args = [kw.pop(n) for n in FUSED_NAMES]
        k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
        p = cuda_qp_fused.admm_iterate_fused_plain(*args, **kw)
        if scfg is fixed:
            assert float((k.x - p.x).abs().max()) < 3e-2
        else:
            assert int(k.solved.sum()) >= 0.9 * k.x.shape[0]
        assert bool((k.warm == p.warm).all())
        assert float(k.ns_resid.max()) < kw["ns_tol"]
        _kinv_residual_ok(args, k, kw)
        assert _same_bits(k, cuda_qp_fused.admm_iterate_fused(*args, **kw))
        outs.append(k)
    return outs


def test_fused_admm_small_n_cold_and_warm():
    """B4 at n = 30: cold from Jacobi, then warm from the cold solve's
    cache; against the plain version, bits equal over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = SolverConfig(max_iter=200, polish=False, adaptive_rho=False,
                       eps_abs=3e-4, eps_rel=3e-4, use_pallas=True,
                       pallas_fused_ns=True)
    qps = random_qps(B)
    cold = _fused_vs_plain(qps, cfg)[1]
    assert not bool(cold.warm.any())
    fac = qp_mod.solve(qps, cfg).fac
    warm = _fused_vs_plain(qps, cfg, fac=fac)[1]
    assert bool(warm.warm.all())
    assert int(warm.ns_iters.max()) < int(cold.ns_iters.min())


def test_fused_admm_main_path_ftocps(setup):
    """B4 on the main path's LMPC FTOCPs (n = 200: two passes of the
    product rows), against the plain version."""
    cfg, trk, st, x0 = setup
    ctrl = lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver, 0.1)
    qp = ctrl.build_qp(st, x0)[0]
    assert qp.q.shape[1] == 200 and cuda_qp_fused.plan(200, 257).passes == 2
    assert cuda_qp_fused.core(200) == "product"
    _fused_vs_plain(qp, dataclasses.replace(cfg.solver, pallas_fused_ns=True),
                    (st.warm_x, st.warm_y), st.fac)


@pytest.mark.parametrize("prec", ["bf16x3", "default"])
def test_fused_admm_iteration_precision_matches_plain(setup, prec):
    """B4 at a lowered iteration precision on the main path's FTOCPs: the
    prologue gives highest's bits, the ADMM phase is held to the plain loop
    on B4's own refreshed inverse, two calls give the same bits."""
    cfg, trk, st, x0 = setup
    ctrl = lmpc_mod.make_lmpc(cfg.lmpc, trk, cfg.solver, 0.1)
    qp = ctrl.build_qp(st, x0)[0]
    its = chip_smoke.FIXED_ITERS[prec]
    fixed = dataclasses.replace(cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=its, check_every=its,
                                rescue_max_iter=0, pallas_fused_ns=True,
                                pallas_iter_precision=prec)
    kw = qp_mod.fused_inputs(qp, fixed, (st.warm_x, st.warm_y), st.fac)
    args = [kw.pop(n) for n in FUSED_NAMES]
    cuda_qp_fused.precision_launches[prec].reset()
    k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
    assert cuda_qp_fused.precision_launches[prec].n == 1
    assert _same_bits(k, cuda_qp_fused.admm_iterate_fused(*args, **kw))
    kh = cuda_qp_fused.admm_iterate_fused(
        *args, **dict(kw, iter_precision="highest"))
    for name in ("kinv", "ns_resid", "kinv_pad", "warm", "ns_iters"):
        assert torch.equal(getattr(k, name), getattr(kh, name))
    a = dict(zip(FUSED_NAMES, args))

    def loop():
        return cuda_qp.admm_iterate_plain(
            a["P"], k.kinv, a["A"], a["q"], a["l"], a["u"], a["rho"], a["D"],
            a["E"], a["c"], a["x0"], a["z0"], a["y0"], kinv_pad=k.kinv_pad,
            **kw)

    p = loop()
    with chip_smoke.float64_products(cuda_qp):
        c = loop()
    ok, detail, _ = chip_smoke.variant_agrees(torch, prec, k.x, p[0], c[0])
    assert ok, detail


def test_fused_plan_matches_kernel_source_and_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for n, m in ((146, 202), (200, 257), (30, 26), (152, 202), (153, 202)):
        pl = cuda_qp_fused.plan(n, m)
        assert cuda_qp_fused.smem_bytes_on_card(n, m) == pl.nbytes
        assert cuda_qp_fused.ctas_per_sm_on_card(n, m) == pl.ctas_per_sm
        assert cuda_qp_fused.source_plan(n) == (pl.core,
                                                cuda_qp_fused.ws_floats(n))


@pytest.fixture(scope="module")
def stages():
    """A 150-step PID, LTI and LTV run at batch 16 with the fused kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    solver = dataclasses.replace(SolverConfig.throughput(),
                                 pallas_fused_ns=True)
    cfg = exp.ExperimentConfig(stage_steps=150, solver=solver)
    trk = make_track(device="cuda")
    cuda_qp.launches.reset()
    cuda_qp_fused.launches.reset()
    res = exp.run_experiment(cfg, batch=B, stages="pid,lti,ltv", trk=trk)
    assert cuda_qp_fused.launches.n > 0 and cuda_qp.launches.n == 0
    return cfg, trk, res


@pytest.mark.parametrize("stage", ["lti", "ltv"])
def test_fused_admm_matches_plain(stages, stage):
    """B4 on the stage's FTOCPs (LTI: warm cache; LTV: cold build)."""
    cfg, trk, res = stages
    f = stage_path.stage_ftocps(res, cfg, stage, trk)
    fixed = dataclasses.replace(cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    for scfg in (fixed, cfg.solver):
        kw = qp_mod.fused_inputs(f.qp, scfg, f.warm, f.fac)
        args = [kw.pop(n) for n in FUSED_NAMES]
        k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
        p = cuda_qp_fused.admm_iterate_fused_plain(*args, **kw)
        assert float((k.x - p.x).abs().max()) < 3e-2
        assert bool((k.warm == p.warm).all())
        # LTI's constant K contracts the warm start; LTV's drift does not
        assert bool(k.warm.float().mean() > 0.5) == (stage == "lti")
        assert float(k.ns_resid.max()) < kw["ns_tol"]
        _kinv_residual_ok(args, k, kw)
        assert _same_bits(k, cuda_qp_fused.admm_iterate_fused(*args, **kw))
        if scfg is not fixed:
            assert int(k.solved.sum()) >= 0.9 * B
    with pytest.raises(ValueError, match="contiguous"):
        cuda_qp_fused.admm_iterate_fused(args[0].transpose(1, 2), *args[1:],
                                         **kw)
    with pytest.raises(ValueError, match="shape"):
        cuda_qp_fused.admm_iterate_fused(*args[:5], args[5][:, :-1],
                                         *args[6:], **kw)


def test_fused_resident_core_on_256_ltv_lanes(stages):
    """B4's resident core at (n, m) = (146, 202) on 256 lanes of the LTV
    stage's FTOCPs, cold and warm lanes mixed (a third handed the refreshed
    inverse of a first call, a fifth no warm start): per lane the plain
    version's warm decision and Newton-Schulz count, a refreshed inverse
    within the gate, the same bits over two calls, and one launch of the
    resident core a call, none of the product core."""
    cfg, trk, res = stages
    f = stage_path.stage_ftocps(res, cfg, "ltv", trk)
    kw = qp_mod.fused_inputs(f.qp, cfg.solver, f.warm, f.fac)
    a = {k: v.repeat((256 // B,) + (1,) * (v.dim() - 1)).contiguous()
         for k, v in ((n, kw.pop(n)) for n in FUSED_NAMES)}
    assert a["P"].shape == (256, 146, 146) and a["A"].shape[1] == 202
    assert cuda_qp_fused.core(146) == "resident"
    first = cuda_qp_fused.admm_iterate_fused(*(a[n] for n in FUSED_NAMES),
                                             **kw)
    lane = torch.arange(256, device=a["P"].device)
    a["kinv0"] = torch.where((lane % 3 == 0)[:, None, None], first.kinv,
                             a["kinv0"]).contiguous()
    a["warm_ok"] = a["warm_ok"] & (lane % 5 != 2)
    args = [a[n] for n in FUSED_NAMES]
    before = {c: cuda_qp_fused.core_launches[c].n for c in cuda_qp_fused.CORES}
    k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
    p = cuda_qp_fused.admm_iterate_fused_plain(*args, **kw)
    assert bool(k.warm.any()) and not bool(k.warm.all())
    assert torch.equal(k.warm, p.warm)
    assert torch.equal(k.ns_iters, p.ns_iters)
    _kinv_residual_ok(args, k, kw)
    assert _same_bits(k, cuda_qp_fused.admm_iterate_fused(*args, **kw))
    assert cuda_qp_fused.core_launches["resident"].n == before["resident"] + 2
    assert cuda_qp_fused.core_launches["product"].n == before["product"]


@pytest.mark.parametrize("stage", ["lti", "ltv"])
def test_fused_counters_sum_the_per_lane_outputs(stages, stage):
    """Armed, B4 adds its lanes, warm lanes, Newton-Schulz lane-iterations
    and rescued lanes to the tracer's device counters: the sums of
    ``FusedResult``'s fields, with no host sync in the call (PyTorch's
    sync check raises on one); disarmed it adds nothing."""
    cfg, trk, res = stages
    f = stage_path.stage_ftocps(res, cfg, stage, trk)
    kw = qp_mod.fused_inputs(f.qp, cfg.solver, f.warm, f.fac)
    args = [kw.pop(n) for n in FUSED_NAMES]
    cuda_qp_fused.admm_iterate_fused(*args, **kw)
    torch.cuda.synchronize()
    with tracing.session() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            r = cuda_qp_fused.admm_iterate_fused(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    c = rec.counts
    assert [c["fused.lanes"], c["fused.warm_lanes"], c["fused.ns_lane_iters"],
            c["fused.rescued_lanes"]] == [
        B, int(r.warm.sum()), int(r.ns_iters.sum()), int(r.rescued.sum())]
    assert c["fused.ns_lane_iters"] >= B
    before = cuda_qp_fused.work.values()
    cuda_qp_fused.admm_iterate_fused(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_qp_fused.work.values() == before


def test_bench_headline_launches_each_kernel_once_a_step(setup):
    """The bench's headline at batch 16, 5 steps a chunk: B1, B2 and B3
    launch once a step and no scenario streams (``time_chunks`` raises
    otherwise)."""
    from racinglmpc_tpu_torch.runtime import bench

    mp, st, plant, _ = main_path.setup(B, device="cuda")
    out = bench.time_chunks(mp, st, plant, steps=5, reps=2)
    assert out.counts == [{"admm": 5, "admm_layouts": 5, "sysid": 5,
                           "rollout": 5, "admm_streamed": 0}] * 2
    assert out.solves_per_s > 0 and out.iters.shape == (2 * 5 * B,)


# ---- the Newton-Schulz kernel (ops/cuda_ns.py) ---------------------------

NS_B = 256


@pytest.fixture(scope="module")
def ns_inputs():
    """The inverse's inputs on the main path at batch 256 (n = 200), step 21
    after 20 steps on the plain inverse; lanes 0-7 warm from their float64
    inverse, lanes 8-15 from one perturbed to I - K X0 ~ 1e-2, a NaN entry
    in lane 20's K and an infinite one in lane 21's: (K, X0, warm_ok, tol,
    max_iters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    mp, st, plant, _ = main_path.setup(NS_B, device="cuda")
    seen = []
    real = cuda_ns.ns_inverse

    def capture(K, X0, warm_ok, tol, max_iters, staged=False, stats=None):
        seen[:] = [(K.clone(), X0.clone(), warm_ok.clone(), tol, max_iters)]
        return cuda_ns.ns_inverse_plain(K, X0, warm_ok, tol, max_iters,
                                        staged, stats)

    cuda_ns.ns_inverse = capture
    try:
        state, plant = main_path.run_chunk(mp, st, plant, 20)[:2]
        mp.ctrl.step(state, plant.x)
    finally:
        cuda_ns.ns_inverse = real
    K, X0, warm, tol, max_iters = seen[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    inv = torch.linalg.inv(K[:16].double())
    X0[:8] = inv[:8].float()
    n = K.shape[-1]
    E = 1e-2 / n ** 0.5 * torch.randn((8, n, n), generator=g, device="cuda",
                                      dtype=torch.float64)
    X0[8:16] = (inv[8:16] @ (torch.eye(n, device="cuda",
                                       dtype=torch.float64) + E)).float()
    warm[:16] = True
    K[20, 3, 5] = float("nan")
    K[21, 7, 7] = float("inf")
    return K, X0, warm, tol, max_iters


def _true_residual(K, X):
    I = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (I - K.double() @ X.double()).abs().amax((1, 2))


def _flip(t):
    return t.flip(-1).flip(-2)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("max_iters", [None, 10])
def test_ns_kernel_matches_plain_on_main_path_ftocps(ns_inputs, staged,
                                                     max_iters):
    """The kernel against the plain version on the main path's FTOCPs:
    warm and cold lanes, two non-finite ones, the runs staged or not, and
    at 10 iterations a run, where lanes hit the budget and restart. The
    warm decisions are equal on every lane. Iteration counts near the
    float32 floor (max|I - K X| ~ tol) move with any change of summation
    order: the plain version on the same FTOCPs with the k order of every
    sum reversed (K and X0 flipped, the same mathematics) is the control.
    The kernel's counts equal the plain version's on 99% of lanes or on as
    many as the control's do, and lie more than 1 apart on no more lanes
    than the control's (or 1%); the residual reaches the tolerance wherever
    the plain one does but on no more lanes than the control misses; per
    lane, max|I - K X| is at most twice the plain version's."""
    K, X0, warm, tol, mi = ns_inputs
    mi = max_iters or mi
    sp, sk, sc = {}, {}, {}
    Xp, rp = cuda_ns.ns_inverse_plain(K, X0, warm, tol, mi, staged, sp)
    Xk, rk = cuda_ns.ns_inverse(K, X0, warm, tol, mi, staged, sk)
    Xc, rc = cuda_ns.ns_inverse_plain(_flip(K), _flip(X0), warm, tol, mi,
                                      staged, sc)
    Xc = _flip(Xc)
    torch.cuda.synchronize()
    assert torch.equal(sk["warm"], sp["warm"]) and bool(sp["warm"][:16].all())
    fin = torch.isfinite(rp)
    assert not bool(fin[20]) and not bool(fin[21]) and int(fin.sum()) > 200
    assert torch.equal(torch.isfinite(rk), fin)
    assert torch.equal(torch.isfinite(Xk).all(-1).all(-1),
                       torch.isfinite(Xp).all(-1).all(-1))
    for run in ("first", "restart"):
        eq_k = float((sk[run] == sp[run]).float().mean())
        eq_c = float((sc[run] == sp[run]).float().mean())
        off_k = int(((sk[run] - sp[run]).abs() > 1).sum())
        off_c = int(((sc[run] - sp[run]).abs() > 1).sum())
        assert eq_k >= min(0.99, eq_c), (run, eq_k, eq_c)
        assert off_k <= max(off_c, NS_B // 100), (run, off_k, off_c)
    if max_iters:    # lanes at the budget (a run's sum over its levels
        # when staged) restart from Jacobi
        assert bool(sk["restarted"].any())
        assert staged or bool((sk["first"] == mi).any())
    lost_k = int(((rp <= tol) & ~(rk <= tol)).sum())
    lost_c = int(((rp <= tol) & ~(rc <= tol)).sum())
    assert lost_k <= lost_c, (lost_k, lost_c)
    tk, tp = _true_residual(K[fin], Xk[fin]), _true_residual(K[fin], Xp[fin])
    assert bool((tk <= 2 * tp).all()), float((tk / tp).max())


@pytest.mark.parametrize("n", [7, 41, 146, 200])
def test_ns_kernel_equal_counts_on_well_conditioned_spd(n):
    """Each padded size of the kernel (40 to 200) on SPD matrices of
    condition ~1e2, half the lanes warm from a perturbed inverse: far from
    the float32 floor every lane takes the plain version's warm decision
    and iteration counts, and the inverses agree to float32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n)
    Bn = 64
    M = torch.randn((Bn, n, n), generator=g, device="cuda",
                    dtype=torch.float64)
    Q = torch.linalg.qr(M)[0]
    ev = torch.logspace(0, 2, n, device="cuda", dtype=torch.float64)
    K64 = Q @ torch.diag_embed(ev.expand(Bn, n)) @ Q.transpose(1, 2)
    X0 = torch.linalg.inv(K64) * (1 + 1e-3 * torch.randn(
        (Bn, n, n), generator=g, device="cuda", dtype=torch.float64))
    K, X0 = K64.float().contiguous(), X0.float().contiguous()
    warm = torch.arange(Bn, device="cuda") % 2 == 0
    sp, sk = {}, {}
    Xp, rp = cuda_ns.ns_inverse_plain(K, X0, warm, 1e-3, 40, False, sp)
    Xk, rk = cuda_ns.ns_inverse(K, X0, warm, 1e-3, 40, False, sk)
    for k in cuda_ns.STATS:
        assert torch.equal(sk[k], sp[k].to(sk[k].dtype)), k
    assert bool(sk["warm"].any()) and bool((rk <= 1e-3).all())
    tk, tp = _true_residual(K, Xk), _true_residual(K, Xp)
    assert bool((tk <= 2 * tp + 1e-6).all())


def test_ns_kernel_counts_its_lanes(ns_inputs):
    """Armed, the kernel adds its lanes, warm gates and lane-iterations to
    the counters the plain version's host counts use, and no pass (a host
    sync); disarmed, it counts nothing."""
    K, X0, warm, tol, mi = ns_inputs
    st = {}
    with tracing.session() as rec:
        cuda_ns.ns_inverse(K, X0, warm, tol, mi, False, st)
    c = rec.counts
    assert c["ns.kernel_lanes"] == c["ns.lanes"] == NS_B
    assert c["ns.final.lane_iters"] == NS_B
    assert c["ns.warm_gate_lanes"] == int(warm.sum())
    assert c["ns.first.lane_iters"] == int(st["first"].sum())
    assert c["ns.restart.lane_iters"] == int(st["restart"].sum())
    assert not any(k.endswith(".passes") and v for k, v in c.items())
    before = cuda_ns.work.values()
    cuda_ns.ns_inverse(K, X0, warm, tol, mi)
    torch.cuda.synchronize()
    assert cuda_ns.work.values() == before


def test_ns_kernel_rejects_what_it_does_not_take(ns_inputs):
    """The wrapper's checks, the kernel's size limit as the source has it,
    and a larger n on the plain version."""
    K, X0, warm, tol, mi = ns_inputs
    lib = cuda_ns._launchers(cuda_build.library())
    assert lib["max_n"]() == cuda_ns.NMAX
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ns.ns_inverse(K, X0.transpose(1, 2), warm, tol, mi)
    with pytest.raises(TypeError, match="bool"):
        cuda_ns.ns_inverse(K, X0, warm.int(), tol, mi)
    n = cuda_ns.NMAX + 8     # beyond the kernel's size: the plain version
    big = torch.eye(n, device="cuda").expand(2, n, n).contiguous()
    launches = cuda_ns.launches.n
    X, r = cuda_ns.ns_inverse(big, big, torch.zeros(2, dtype=torch.bool,
                                                    device="cuda"), tol, mi)
    assert cuda_ns.launches.n == launches and bool((r <= tol).all())


def test_main_path_launches_the_ns_kernel_once_a_step(setup):
    """The main path's solve inverts K by the kernel, one launch a step."""
    cfg, trk, st, x0 = setup
    mp, state, plant, _ = main_path.setup(B, device="cuda")
    n0 = cuda_ns.launches.n
    main_path.run_chunk(mp, state, plant, 3)
    torch.cuda.synchronize()
    assert cuda_ns.launches.n - n0 == 3


# ---- the mesh and the giant path on a one-rank NCCL group ---------------

@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on the card")
    from racinglmpc_tpu_torch.parallel import make_mesh

    with make_mesh() as mesh:
        yield mesh


def test_mesh_run_equals_unsharded_and_launches_kernels(nccl_mesh):
    """``run_experiment(mesh=...)`` on one NCCL rank equals the run
    without a mesh lap for lap, with B1, B2 and B3 launched in it."""
    from racinglmpc_tpu_torch.parallel import cross_scenario_metrics
    from racinglmpc_tpu_torch.utils.config import LMPCConfig, SimConfig

    cfg = exp.ExperimentConfig(
        stage_steps=450, n_lmpc_laps=2, lap_max_steps=500, lap_chunk=125,
        solver=SolverConfig.throughput(),
        sim=SimConfig(use_pallas_rollout=True),
        lmpc=LMPCConfig(max_laps=8, max_pts=1024, model_pts=512,
                        use_pallas_sysid=True))
    plain = exp.run_experiment(cfg, batch=4, stages="pid,lmpc", seed=0)
    counters = (cuda_qp.launches, cuda_sysid.launches, cuda_rollout.launches)
    for c in counters:
        c.reset()
    res = exp.run_experiment(cfg, batch=4, stages="pid,lmpc", seed=0,
                             mesh=nccl_mesh)
    assert all(c.n > 0 for c in counters), [c.n for c in counters]
    assert (res.lap_steps == plain.lap_steps).all()
    assert torch.equal(res.lmpc_state.ss.x, plain.lmpc_state.ss.x)
    s = res.lmpc_laps[-1].x[:, 0, 4]
    met = cross_scenario_metrics(s, nccl_mesh)
    assert torch.equal(met["min"], s.min()) and torch.equal(met["max"],
                                                           s.max())
    assert float((met["mean"] - s.mean()).abs()) <= 1e-6 * float(s.mean())


def test_giant_n40_float64_matches_oracle(nccl_mesh):
    """The giant FTOCP (N = 40, float64) through the sharded solver on the
    card, against the interior-point oracle with the criteria of
    ``tests/test_giant_ftocp.py``."""
    import numpy as np

    from chip_smoke import load_oracle, pid_lap
    from racinglmpc_tpu_torch.controllers import giant_ftocp
    from racinglmpc_tpu_torch.ops import qp_sharded
    from racinglmpc_tpu_torch.parallel import make_mesh
    from racinglmpc_tpu_torch.utils.config import LMPCConfig

    qp_ip = load_oracle("qp_ip")

    bmesh = make_mesh(axis_name=qp_sharded.BLOCK_AXIS)   # the same group
    xs, us = pid_lap(make_track(dtype=torch.float64, device="cpu"))
    g = giant_ftocp.assemble_giant_ftocp(
        make_track(dtype=torch.float64, device="cuda"),
        torch.from_numpy(xs).cuda(), torch.from_numpy(us).cuda(), len(xs),
        N=40, K=48, cfg=LMPCConfig(), dtype=torch.float64)
    sol = qp_sharded.solve_sharded(g.qp, bmesh, qp_sharded.ShardedSolverConfig(
        max_iter=4000, eps_abs=1e-7, eps_rel=1e-7, cg_tol=1e-10,
        cg_max_iter=500))
    assert bool(sol.solved)
    H, q, A, l, u = (t[0].cpu().numpy() for t in g.qp)
    eq = np.isfinite(l) & (u - l < 1e-12)
    z_ref, *_, ok = qp_ip.solve_qp(H, q, A[eq], u[eq], A[~eq], u[~eq])
    assert ok
    x = sol.x.cpu().numpy()

    def obj(z):
        return 0.5 * z @ H @ z + q @ z

    assert abs(obj(x) - obj(z_ref)) / max(abs(obj(z_ref)), 1.0) < 1e-6
    assert max((A @ x - u).max(), (l - A @ x).max()) < 1e-6
    lam = x[g.dims.off_lambda:g.dims.off_lambda + g.dims.K]
    assert abs(lam.sum() - 1.0) < 1e-5 and lam.min() > -1e-6
    # the CG iteration as a CUDA graph and launched op by op: same bits
    short = qp_sharded.ShardedSolverConfig(
        max_iter=25, eps_abs=1e-7, eps_rel=1e-7, cg_tol=1e-10,
        cg_max_iter=500, polish=False)
    a = qp_sharded.solve_sharded(g.qp, bmesh, short)
    b = qp_sharded.solve_sharded(g.qp, bmesh, short, graph=False)
    assert int(a.cg_iters) == int(b.cg_iters) and torch.equal(a.x, b.x)
