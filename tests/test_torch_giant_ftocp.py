"""The port's giant-horizon FTOCP (``controllers/giant_ftocp.py``) against
the JAX package's, and through the port's sharded solver against the
float64 interior-point oracle; mirrors ``tests/test_giant_ftocp.py``.

- Structure (N = 40, K = 48, float64): the layout's shapes, the equality
  rows, the terminal safe-set block and the dynamics blocks; the assembly
  equals JAX's: P, q, the linearization trajectory and the safe set
  exactly, and A, l, u exactly outside the identified rows (vx, vy, wz) of
  the dynamics. Those rows solve the local regression's 5x5 normal
  equations over four copies of the same 7 neighbours of a noise-free lap
  (regularized by 1e-9 only), so the port's and XLA's float64 sums in
  another order move them by up to 2e-5 relative; they are held to 1e-4
  relative.
- The sharded solve against the oracle (of the port's assembly and of the
  reference's, carried across), with the reference test's solver
  settings and criteria: relative objective gap < 1e-6, feasibility
  < 1e-6, the argmin within 2e-3, lambda on the simplex. Here at N = 16 on
  a one-rank gloo mesh: at N = 40 these settings take ~350k CG iterations,
  each a few eager host-launched operations, too many for a CPU test. The
  N = 40 solve runs on the card, on a one-rank NCCL mesh
  (``chip_smoke.py`` phase 8 and ``tests/test_torch_cuda.py``); the
  sharded solver's 2-rank cases are in ``tests/test_torch_qp_sharded.py``.
- A horizon longer than the stored lap tiles the lap cyclically, and the
  QP stays well-posed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.controllers import giant_ftocp as jg
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.utils.config import LMPCConfig as JLMPCConfig
from racinglmpc_tpu_torch import convert
from racinglmpc_tpu_torch.controllers import giant_ftocp as tg
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.ops import qp_sharded as tqs
from racinglmpc_tpu_torch.parallel import mesh as mesh_mod
from racinglmpc_tpu_torch.utils.config import LMPCConfig
from tests.oracles import qp_ip
from tests.test_giant_ftocp import _pid_lap

torch.set_num_threads(1)

SOLVE = dict(max_iter=4000, eps_abs=1e-7, eps_rel=1e-7, cg_tol=1e-10,
             cg_max_iter=500)


def _port(xs, us, N=40, K=48, T=None):
    T = len(xs) if T is None else T
    return tg.assemble_giant_ftocp(
        ttrack.make_track(dtype=torch.float64, device="cpu"),
        torch.from_numpy(xs[:T]), torch.from_numpy(us[:T]), T, N=N, K=K,
        cfg=LMPCConfig(), dtype=torch.float64)


@pytest.fixture(scope="module")
def lap():
    return _pid_lap(jtrack.make_track(dtype=jnp.float64))


def test_structure_and_assembly_equal_reference(lap):
    xs, us = lap
    g = _port(xs, us)
    d = g.dims
    assert d.nz == 6 * 41 + 2 * 40 + 2 * 40 + 48 + 6
    P, q, A, l, u = (t[0].numpy() for t in g.qp)
    assert P.shape == (d.nz, d.nz) and A.shape == (d.mi + d.me, d.nz)
    eq = np.isfinite(l) & (u - l < 1e-12)
    assert eq.sum() == d.me
    tr = d.mi + d.nx_tot
    np.testing.assert_array_equal(
        A[tr:tr + 6, d.off_lambda:d.off_lambda + d.K], -g.ss_points.numpy())
    assert np.abs(A[d.mi + 6:d.mi + 12, :6]).max() > 0

    j = jg.assemble_giant_ftocp(
        jtrack.make_track(dtype=jnp.float64), jnp.asarray(xs),
        jnp.asarray(us), len(xs), N=40, K=48, cfg=JLMPCConfig(),
        dtype=jnp.float64)
    np.testing.assert_array_equal(P, np.asarray(j.qp.P))
    np.testing.assert_array_equal(q, np.asarray(j.qp.q))
    for name in ("x_lin", "ss_points", "qfun_sel"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(j, name)))
    ident = np.zeros(A.shape[0], dtype=bool)    # vx, vy, wz of each stage
    for k in range(3):
        ident[d.mi + 6 + k:d.mi + d.nx_tot:6] = True
    for a, b in ((A, j.qp.A), (l, j.qp.l), (u, j.qp.u)):
        b = np.asarray(b)
        np.testing.assert_array_equal(a[~ident], b[~ident])
        np.testing.assert_allclose(a[ident], b[ident], rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("source", ["port", "reference"])
def test_sharded_solve_matches_oracle(lap, source):
    """The reference test's solver settings and criteria, on a one-rank
    gloo mesh at N = 16 (see the module docstring), for the port's
    assembly and for the reference's carried across
    (``convert.giant_from_jax``)."""
    xs, us = lap
    if source == "port":
        g = _port(xs, us, N=16)
    else:
        j = jg.assemble_giant_ftocp(
            jtrack.make_track(dtype=jnp.float64), jnp.asarray(xs),
            jnp.asarray(us), len(xs), N=16, K=48, cfg=JLMPCConfig(),
            dtype=jnp.float64)
        g = convert.giant_from_jax(j._replace(qp=j.qp._asdict()),
                                   device="cpu")
    H, q, A, l, u = (t[0].numpy() for t in g.qp)
    eq = np.isfinite(l) & (u - l < 1e-12)
    z_ref, *_, ok = qp_ip.solve_qp(H, q, A[eq], u[eq], A[~eq], u[~eq])
    assert ok
    with mesh_mod.make_mesh("cpu", axis_name=tqs.BLOCK_AXIS) as mesh:
        sol = tqs.solve_sharded(g.qp, mesh, tqs.ShardedSolverConfig(**SOLVE))
    assert bool(sol.solved)
    x = sol.x.numpy()

    def obj(z):
        return 0.5 * z @ H @ z + q @ z

    gap = abs(obj(x) - obj(z_ref)) / max(abs(obj(z_ref)), 1.0)
    assert gap < 1e-6, gap
    Az = A @ x
    assert max((Az - u).max(), (l - Az).max()) < 1e-6
    np.testing.assert_allclose(x, z_ref, atol=2e-3)
    d = g.dims
    du = np.abs(x[d.off_u:d.off_u + d.nu_tot]
                - z_ref[d.off_u:d.off_u + d.nu_tot]).max()
    assert du < 2e-3, du
    lam = x[d.off_lambda:d.off_lambda + d.K]
    assert abs(lam.sum() - 1.0) < 1e-5
    assert lam.min() > -1e-6


def test_horizon_wraps_lap(lap):
    xs, us = lap
    T = 100                      # truncate the lap so N > T
    g = _port(xs, us, N=120, K=24, T=T)
    x_lin = g.x_lin.numpy()
    np.testing.assert_allclose(x_lin[0], xs[0], atol=1e-12)
    np.testing.assert_allclose(x_lin[T], xs[0], atol=1e-12)
    np.testing.assert_allclose(x_lin[T + 5], xs[5], atol=1e-12)
    A = g.qp.A[0].numpy()
    assert np.isfinite(A).all()
    tr = g.dims.mi + 6
    assert np.abs(A[tr:g.dims.mi + g.dims.nx_tot, :]).max() > 0
    assert float(g.qfun_sel.min()) > 0

