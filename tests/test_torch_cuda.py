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
from racinglmpc_tpu_torch.models import dynamics, sysid
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.ops import (cuda_qp, cuda_qp_fused, cuda_rollout,
                                      cuda_sysid)
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop, main_path, stage_path
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
    for n, m in ((146, 202), (200, 257), (30, 26)):
        pl = cuda_qp_fused.plan(n, m)
        assert cuda_qp_fused.smem_bytes_on_card(n, m) == pl.nbytes
        assert cuda_qp_fused.ctas_per_sm_on_card(n, m) == pl.ctas_per_sm


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
