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
