"""The port's bindings to the native C++ runtime (``runtime/native.py``)
against the port's float64 plant and QP solver, mirroring
``tests/test_native.py``; they take the port's types (tensors, ``Track``,
``VehicleParams``). Skipped where the library cannot be built (no make or
g++), as the reference's tests are."""
import numpy as np
import pytest
import torch

from racinglmpc_tpu_torch.controllers import ocp
from racinglmpc_tpu_torch.models import track as track_mod
from racinglmpc_tpu_torch.models.dynamics import PlantState, plant_step
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import native
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                               SolverConfig, VehicleParams)

from tests.oracles import qp_ip

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("native toolchain unavailable (make / g++)")


def _random_qp():
    rng = np.random.default_rng(4)
    n, me, mi = 24, 6, 16
    M = rng.normal(size=(n, n))
    P = M @ M.T / n + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    G = rng.normal(size=(me, n))
    F = rng.normal(size=(mi, n))
    z0 = rng.normal(size=n) * 0.3
    g = G @ z0
    b = F @ z0 + np.abs(rng.normal(size=mi)) + 0.1
    A = np.vstack([F, G])
    l = np.concatenate([-np.inf * np.ones(mi), g])
    u = np.concatenate([b, g])
    return P, q, A, l, u, (G, g, F, b)


def _port_solve(P, q, A, l, u):
    data = qp_mod.QPData(*(torch.as_tensor(np.asarray(a))[None]
                           for a in (P, q, A, l, u)))
    return qp_mod.solve(data, SolverConfig.parity())


def test_native_admm_matches_interior_point_and_port_solver(lib):
    P, q, A, l, u, (G, g, F, b) = _random_qp()
    x, _, info = native.solve_qp_admm(torch.tensor(P), torch.tensor(q),
                                      torch.tensor(A), torch.tensor(l),
                                      torch.tensor(u), max_iter=4000)
    assert info["solved"], info
    z_ref, _, _, ok = qp_ip.solve_qp(P, q, G=G, g=g, F=F, b=b)
    assert ok
    np.testing.assert_allclose(x, z_ref, atol=5e-5)
    sol = _port_solve(P, q, A, l, u)
    assert bool(sol.solved[0])
    np.testing.assert_allclose(sol.x[0].numpy(), x, atol=5e-5)


def test_native_rollout_matches_port_plant(lib):
    rng = np.random.default_rng(5)
    B = 4
    trk = track_mod.make_track(dtype=torch.float64, device="cpu")
    vp = VehicleParams()
    cfg = SimConfig(noise=False)
    x = rng.normal(scale=0.1, size=(B, 6))
    x[:, 0] += 0.8
    x[:, 4] = rng.uniform(0, 19, B)
    u = rng.normal(scale=0.2, size=(B, 2))
    xt, ut = torch.tensor(x), torch.tensor(u)

    segs, L = native.track_segs(trk)
    nx, nxg = native.rollout(xt, xt.clone(), ut, native.vehicle_vals(vp),
                             segs, L, substeps=cfg.substeps,
                             dt_sub=cfg.delta_t)
    ref = plant_step(PlantState(xt, xt.clone()), ut, vp, trk, cfg)
    np.testing.assert_allclose(nx, ref.x.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(nxg, ref.x_glob.numpy(), rtol=1e-9,
                               atol=1e-9)


def test_native_admm_on_lmpc_shaped_problem(lib):
    """A 200-variable FTOCP assembled by the port's ``ocp``: the native
    solve is feasible for the safe-set simplex and matches the port's
    solver."""
    cfg = LMPCConfig()
    K, N = cfg.num_ss_points, cfg.N
    dims, tmpl = ocp.make_templates(
        N=N, Q=cfg.Q, R=cfg.R, dR=cfg.dR, Qf=(0.0,) * 6,
        q_slack=cfg.q_slack, x_ref=(0.0,) * 6, ey_max=cfg.ey_max,
        delta_max=cfg.delta_max, a_max=cfg.a_max, K=K,
        q_terminal_slack=cfg.q_terminal_slack, device="cpu")
    rng = np.random.default_rng(6)
    A_dyn = np.tile(np.eye(6), (N, 1, 1))
    A_dyn[:, 4, 0] = 0.1
    B_dyn = np.zeros((N, 6, 2))
    B_dyn[:, 0, 1] = 0.1
    B_dyn[:, 2, 0] = 0.5
    x0 = np.array([0.8, 0, 0, 0, 1.0, 0.0])
    ss = np.tile(x0[:, None], (1, K)) + 0.05 * rng.normal(size=(6, K))
    ss[4] += 0.1 * N * x0[0]
    qfun = np.linspace(60, 40, K)
    t = lambda a: torch.tensor(a)[None]  # noqa: E731
    qp = ocp.assemble_qp(
        dims, tmpl, ocp.StageDynamics(t(A_dyn), t(B_dyn),
                                      t(np.zeros((N, 6)))),
        t(x0), torch.zeros((1, 2), dtype=torch.float64), cfg.dR,
        ss_points=t(ss), qfun_sel=t(qfun))
    x, _, info = native.solve_qp_admm(qp.P[0], qp.q[0], qp.A[0], qp.l[0],
                                      qp.u[0], max_iter=4000)
    assert info["solved"], info
    lam = ocp.unpack(dims, torch.tensor(x)[None])[3]
    assert abs(float(lam.sum()) - 1.0) < 1e-4
    sol = qp_mod.solve(qp, SolverConfig.parity())
    assert bool(sol.solved[0])
    P, q = qp.P[0].numpy(), qp.q[0].numpy()

    def obj(z):
        return 0.5 * z @ P @ z + q @ z

    assert abs(obj(sol.x[0].numpy()) - obj(x)) <= 1e-3 * max(1.0,
                                                           abs(obj(x)))


def test_native_inputs_are_checked(lib):
    P, q, A, l, u, _ = _random_qp()
    with pytest.raises(ValueError):
        native.solve_qp_admm(P, q, A[:, :-1], l, u)
    with pytest.raises(ValueError):
        native.rollout(np.zeros((2, 6)), np.zeros((2, 6)), np.zeros((3, 2)),
                       np.zeros(10), np.zeros((4, 3)), 1.0)
