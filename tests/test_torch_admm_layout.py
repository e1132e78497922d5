"""Kernel B1's two layouts (``ops/cuda_qp.py``: ``smem_plan``,
``choose_layout``, ``streams``; ``csrc/qp_common.cuh``).

Resident: Kinv and the compressed A and P in shared memory, one read of
the matrices per solve. Stream: dense P, Kinv and A read from global
memory in every product. On the CPU: the shared-memory plan fits the
main-path (1 CTA per SM) and MPC-stage (2 CTAs per SM) shapes, n = 230
(N = 17, 48 safe-set points) streams, the nonzeros of real FTOCPs fit the
plan's cap, and every layout runs the plain version on CPU tensors (held
against the Pallas kernel in interpret mode). Marked ``cuda`` (skipped
without a card): both layouts against the plain version, the forced
rescue under both, the same bits from both layouts and from two resident
calls, B4 on the resident core, and the plan against the kernel source's
own count. On a machine with a card:

    python -m pytest -m cuda --noconftest tests/test_torch_admm_layout.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from racinglmpc_tpu_torch.controllers import ocp as tocp
from racinglmpc_tpu_torch.controllers.ocp import FTOCPDims
from racinglmpc_tpu_torch.models.track import make_track
from racinglmpc_tpu_torch.ops import cuda_build, cuda_qp, cuda_qp_fused
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import main_path, stage_path
from racinglmpc_tpu_torch.utils.config import LMPCConfig, SolverConfig

torch.set_num_threads(1)
NAMES = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0", "z0",
         "y0")
FUSED_NAMES = ("P", "A", "kinv0", "warm_ok", "q", "l", "u", "rho", "D", "E",
               "c", "x0", "z0", "y0")
MAIN = FTOCPDims(N=14, K=48)      # the main path's LMPC FTOCP
MPC = FTOCPDims(N=14)             # the LTI / LTV-MPC stages' FTOCP


def _nm(dims):
    return dims.nz, dims.me + dims.mi


@pytest.mark.parametrize("dims,ctas", [(MAIN, 1), (MPC, 2)],
                         ids=["main_path", "mpc_stage"])
def test_plan_fits_shapes(dims, ctas):
    n, m = _nm(dims)
    assert (n, m) == ((200, 257) if dims is MAIN else (146, 202))
    plan = cuda_qp.choose_layout(n, m)
    assert plan.name == "resident" and plan.ctas_per_sm == ctas
    assert plan.nbytes <= cuda_qp.SMEM_PER_CTA
    assert ctas * (plan.nbytes + cuda_qp.SMEM_RESERVED) <= cuda_qp.SMEM_PER_SM
    # the count by hand: header, vectors (padded to 4), Kinv + 4 floats,
    # 14 bytes per nonzero, int16 pointers
    r4 = lambda k: -(-k // 4) * 4  # noqa: E731
    ctx = 4 * (7 * r4(n) + 8 * r4(m) + 512 + 64)
    ptrs = 2 * (m + 1 + 2 * (n + 1))
    assert plan.nbytes == 80 + ctx + 4 * (n * n + 4) + \
        -(-(14 * plan.nnz_cap + ptrs) // 16) * 16
    assert plan.nnz_cap >= cuda_qp.MIN_DENSITY * (m * n + n * n)
    assert cuda_qp.smem_plan(n, m, plan.nnz_cap) == (plan.nbytes,
                                                     plan.ctas_per_sm)


def test_plan_streams_n230():
    dims = FTOCPDims(N=17, K=48)
    n, m = _nm(dims)
    assert n == 230
    # Kinv (211,600 B) and the vectors leave room for ~60 nonzeros, where
    # A and P hold ~1,100
    room = (cuda_qp.SMEM_PER_CTA - cuda_qp.smem_plan(n, m, 0)[0]) // 14
    assert room < cuda_qp.MIN_DENSITY * (m * n + n * n)
    plan = cuda_qp.choose_layout(n, m)
    assert plan.name == "stream" and plan.nnz_cap == 0
    assert plan.nbytes == 4 * cuda_qp.ctx_floats(n, m)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_qp.pick_layout(n, m, "resident")
    assert cuda_qp.pick_layout(200, 257, "stream").name == "stream"


def test_streams_counts_nonzeros_of_a_and_p():
    P = torch.zeros((3, 4, 4))
    A = torch.zeros((3, 5, 4))
    P[1, 0, 0] = 1.0
    A[1, 2, 3] = -2.0
    A[2] = 1.0
    assert cuda_qp.streams(P, A, 2).tolist() == [False, False, True]
    assert cuda_qp.streams(P, A, 1).tolist() == [False, True, True]


def test_phase_clock_build_is_a_library_of_its_own():
    """-DQP_PHASES changes the library's name, so a phase-clock build
    never replaces the kernels that run."""
    assert cuda_build._flags(("QP_PHASES",))[-1] == "-DQP_PHASES"
    assert cuda_build._digest(()) != cuda_build._digest(("QP_PHASES",))
    assert cuda_build.DEFINES == ()


def test_scenario_counter_sums_on_its_device():
    c = cuda_build.ScenarioCounter("streamed")
    t = c.tensor("cpu")
    assert c.tensor("cpu") is t and t.dtype == torch.int32
    t += 3
    assert c.value() == 3
    c.reset()
    assert c.value() == 0


def test_main_path_nnz_fits_cap():
    mp, st, plant, _ = main_path.setup(2, device="cpu")
    qp = mp.ctrl.build_qp(st, plant.x)[0]
    pro, kinv, _ = qp_mod.admm_inputs(qp, mp.cfg.solver,
                                      (st.warm_x, st.warm_y), st.fac)
    kw = qp_mod.kernel_args(pro, kinv, mp.cfg.solver)
    n, m = kw["q"].shape[1], kw["l"].shape[1]
    assert (n, m) == _nm(MAIN)
    plan = cuda_qp.choose_layout(n, m)
    assert not bool(cuda_qp.streams(kw["P"], kw["A"], plan.nnz_cap).any())
    nnz = (kw["A"] != 0).sum((1, 2)) + (kw["P"] != 0).sum((1, 2))
    assert int(nnz.max()) <= plan.nnz_cap // 2   # room to spare


@pytest.fixture(scope="module")
def mpc_stages():
    """A 40-step PID, LTI and LTV run at batch 2 on the CPU (B4's plain
    version, as the fused presets run it)."""
    solver = dataclasses.replace(SolverConfig.throughput(),
                                 pallas_fused_ns=True, pallas_interpret=True)
    cfg = exp.ExperimentConfig(stage_steps=40, solver=solver)
    trk = make_track(device="cpu")
    res = exp.run_experiment(cfg, batch=2, stages="pid,lti,ltv", trk=trk,
                             device="cpu")
    return cfg, trk, res


@pytest.mark.parametrize("stage", ["lti", "ltv"])
def test_mpc_stage_nnz_fits_cap(mpc_stages, stage):
    cfg, trk, res = mpc_stages
    f = stage_path.stage_ftocps(res, cfg, stage, trk, steps=2)
    kw = qp_mod.fused_inputs(f.qp, cfg.solver, f.warm, f.fac)
    n, m = kw["q"].shape[1], kw["l"].shape[1]
    assert (n, m) == _nm(MPC)
    plan = cuda_qp.choose_layout(n, m)
    assert plan.ctas_per_sm == 2
    assert not bool(cuda_qp.streams(kw["P"], kw["A"], plan.nnz_cap).any())


def _small_kernel_args(seed=0, B=3):
    """Kernel inputs of a batch of small LMPC FTOCPs (N = 6, K = 12) built
    from numpy data, at 16 fixed iterations."""
    N, K = 6, 12
    lc = LMPCConfig()
    dims, tmpl = tocp.make_templates(
        N=N, Q=lc.Q, R=lc.R, dR=lc.dR, Qf=(0.0,) * 6, q_slack=lc.q_slack,
        x_ref=(0.0,) * 6, ey_max=lc.ey_max, delta_max=lc.delta_max,
        a_max=lc.a_max, K=K, q_terminal_slack=lc.q_terminal_slack,
        dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x0 = np.zeros((B, 6))
    x0[:, 0] = 0.5 + 0.3 * rng.uniform(size=B)
    qp = tocp.assemble_qp(
        dims, tmpl, tocp.StageDynamics(
            f(np.eye(6) + 0.05 * rng.normal(size=(B, N, 6, 6))),
            f(0.1 * rng.normal(size=(B, N, 6, 2))),
            f(0.01 * rng.normal(size=(B, N, 6)))),
        f(x0), f(0.1 * rng.normal(size=(B, 2))), lc.dR,
        ss_points=f(rng.normal(size=(B, 6, K))),
        qfun_sel=f(rng.uniform(1, 50, size=(B, K))))
    cfg = dataclasses.replace(SolverConfig.throughput(), eps_abs=0.0,
                              eps_rel=0.0, max_iter=16, check_every=16,
                              rescue_max_iter=0)
    pro, kinv, _ = qp_mod.admm_inputs(qp, cfg)
    kw = qp_mod.kernel_args(pro, kinv, cfg)
    return [kw.pop(k) for k in NAMES], kw


@pytest.mark.parametrize("layout", [None, "resident", "stream"])
def test_every_layout_runs_plain_on_cpu(layout):
    import jax
    import jax.numpy as jnp

    from racinglmpc_tpu.ops import pallas_qp

    args, kw = _small_kernel_args()
    cuda_qp.launches.reset()
    out = cuda_qp.admm_iterate(*args, **kw, layout=layout)
    ref = cuda_qp.admm_iterate_plain(*args, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert cuda_qp.launches.n == 0
    kw.pop("ns_tol")
    kw.pop("ns_max_iters")
    pal = jax.vmap(lambda *a: pallas_qp.admm_iterate(
        *a, interpret=True, **kw))(*(jnp.asarray(a.numpy()) for a in args))
    dx = np.abs(out[0].numpy() - np.asarray(pal[0])).max()
    assert dx < 3e-2, dx


def test_unknown_layout_raises():
    args, kw = _small_kernel_args(B=1)
    with pytest.raises(ValueError, match="layout"):
        cuda_qp.admm_iterate(*args, **kw, layout="dense")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
B = 32


@pytest.fixture(scope="module")
def card():
    """Main-path FTOCPs at batch 32 on the card and their kernel inputs at
    16 fixed iterations, at tolerance and under the forced rescue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    mp, st, plant, _ = main_path.setup(B, device="cuda")
    qp = mp.ctrl.build_qp(st, plant.x)[0]
    warm = (st.warm_x, st.warm_y)
    solver = mp.cfg.solver
    fixed = dataclasses.replace(solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    rescue = dataclasses.replace(
        solver, rho=1e-4, rho_eq_scale=1.0, max_iter=40, check_every=10,
        scaling_iters=0, eps_abs=1e-4, eps_rel=1e-4, rescue_max_iter=400,
        rescue_rho_scale=100.0)
    out = {}
    for key, scfg, fac in (("fixed", fixed, st.fac), ("tol", solver, st.fac),
                           ("rescue", rescue, None)):
        pro, kinv, _ = qp_mod.admm_inputs(qp, scfg, warm, fac)
        kw = qp_mod.kernel_args(pro, kinv, scfg)
        out[key] = ([kw.pop(k) for k in NAMES], kw)
    kw = qp_mod.fused_inputs(qp, fixed, warm, st.fac)
    out["fused"] = ([kw.pop(k) for k in FUSED_NAMES], kw)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["resident", "stream"])
def test_layout_matches_plain(card, layout):
    cuda_qp.streamed.reset()
    counter = cuda_qp.layout_launches[layout]
    counter.reset()
    args, kw = card["fixed"]
    k = cuda_qp.admm_iterate(*args, **kw, layout=layout)
    p = cuda_qp.admm_iterate_plain(*args, **kw)
    assert float((k[0] - p[0]).abs().max()) < 3e-2
    args, kw = card["tol"]
    k = cuda_qp.admm_iterate(*args, **kw, layout=layout)
    assert int(k[5].sum()) >= 0.9 * B
    assert counter.n == 2
    assert cuda_qp.streamed.value() == (0 if layout == "resident" else 2 * B)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["resident", "stream"])
def test_forced_rescue_layout(card, layout):
    args, kw = card["rescue"]
    k = cuda_qp.admm_iterate(*args, **kw, layout=layout)
    p = cuda_qp.admm_iterate_plain(*args, **kw)
    assert bool(k[6].all())
    assert torch.equal(k[6], p[6])
    assert torch.equal(k[4], p[4])


@pytest.mark.cuda
def test_resident_layout_deterministic(card):
    args, kw = card["tol"]
    a = cuda_qp.admm_iterate(*args, **kw)
    b = cuda_qp.admm_iterate(*args, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fixed", "tol", "rescue"])
def test_layouts_give_the_same_bits(card, config):
    """The resident products sum in the streaming core's order."""
    args, kw = card[config]
    r = cuda_qp.admm_iterate(*args, **kw, layout="resident")
    s = cuda_qp.admm_iterate(*args, **kw, layout="stream")
    for u, v in zip(r, s):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_fused_on_resident_core(card):
    cuda_qp_fused.streamed.reset()
    args, kw = card["fused"]
    k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
    p = cuda_qp_fused.admm_iterate_fused_plain(*args, **kw)
    assert float((k.x - p.x).abs().max()) < 3e-2
    assert torch.equal(k.warm, p.warm)
    assert cuda_qp_fused.streamed.value() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [MAIN, MPC], ids=["main_path", "mpc_stage"])
def test_plan_matches_kernel_source(card, dims):
    n, m = _nm(dims)
    plan = cuda_qp.choose_layout(n, m)
    assert cuda_qp.smem_bytes_on_card(n, m, plan) == plan.nbytes
    # the plan counts shared memory; the registers hold the card to one CTA
    assert cuda_qp.ctas_per_sm_on_card(n, m, plan) == 1
