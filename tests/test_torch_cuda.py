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
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.ops import (cuda_qp, cuda_qp_fused, cuda_rollout,
                                      cuda_sysid)
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import main_path, stage_path
from racinglmpc_tpu_torch.utils.config import SolverConfig, VehicleParams

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
    for rows in (T, 1024):
        pl = cuda_sysid.plan(K, rows, cfg.lmpc.N)
        assert cuda_sysid.smem_bytes_on_card(rows, cfg.lmpc.N,
                                             pl.nbuf) == pl.nbytes
        assert cuda_sysid.ctas_per_sm_on_card(rows, cfg.lmpc.N,
                                              pl.nbuf) == pl.ctas_per_sm


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
        if scfg is not fixed:
            assert int(k.solved.sum()) >= 0.9 * B
    with pytest.raises(ValueError, match="contiguous"):
        cuda_qp_fused.admm_iterate_fused(args[0].transpose(1, 2), *args[1:],
                                         **kw)
    with pytest.raises(ValueError, match="shape"):
        cuda_qp_fused.admm_iterate_fused(*args[:5], args[5][:, :-1],
                                         *args[6:], **kw)
