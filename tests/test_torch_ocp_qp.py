"""Port FTOCP assembly + QP solver against the JAX reference.

- assemble_qp / shift_warm / unpack: equal in f64;
- qp.solve in f64 (default and parity() configs, cold and warm-started
  through the factor cache): x within 1e-7, identical iteration counts;
- the B1 kernel's plain version against pallas_qp.admm_iterate in
  interpret mode (f32): a fixed 16-iteration run on real-shaped LMPC
  FTOCPs (|dx| < 3e-2, the bound examples/tpu_smoke.py sets for the
  Pallas kernel) and the forced rho-escalation rescue of
  tests/test_pallas_qp.py (rescued flags and iteration counts equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.controllers import ocp as jocp
from racinglmpc_tpu.ops import pallas_qp
from racinglmpc_tpu.ops import qp as jqp
from racinglmpc_tpu.utils.config import SolverConfig as JS
from racinglmpc_tpu_torch.controllers import ocp as tocp
from racinglmpc_tpu_torch.ops import cuda_qp
from racinglmpc_tpu_torch.ops import qp as tqp
from racinglmpc_tpu_torch.utils.config import LMPCConfig, SolverConfig
from tests.test_pallas_qp import _hard_rho_qp

torch.set_num_threads(1)
N, K = 6, 12


def _tmpl_kw(cfg):
    return dict(N=N, Q=cfg.Q, R=cfg.R, dR=cfg.dR, Qf=(0.0,) * 6,
                q_slack=cfg.q_slack, x_ref=(0.0,) * 6, ey_max=cfg.ey_max,
                delta_max=cfg.delta_max, a_max=cfg.a_max, K=K,
                q_terminal_slack=cfg.q_terminal_slack)


def _problem_data(B, seed):
    rng = np.random.default_rng(seed)
    A = np.eye(6) + 0.05 * rng.normal(size=(B, N, 6, 6))
    Bm = 0.1 * rng.normal(size=(B, N, 6, 2))
    C = 0.01 * rng.normal(size=(B, N, 6))
    x0 = np.zeros((B, 6))
    x0[:, 0] = 0.5 + 0.3 * rng.uniform(size=B)
    x0[:, 5] = 0.2 * rng.normal(size=B)
    u_old = 0.1 * rng.normal(size=(B, 2))
    ss = rng.normal(size=(B, 6, K))
    qf = rng.uniform(1, 50, size=(B, K))
    return A, Bm, C, x0, u_old, ss, qf


def _both_qps(B, seed, dt_np=np.float64):
    cfg = LMPCConfig()
    jdt = jnp.float64 if dt_np == np.float64 else jnp.float32
    tdt = torch.float64 if dt_np == np.float64 else torch.float32
    dims, jt = jocp.make_templates(**_tmpl_kw(cfg), dtype=jdt)
    tdims, tt = tocp.make_templates(**_tmpl_kw(cfg), dtype=tdt, device="cpu")
    A, Bm, C, x0, u_old, ss, qf = (a.astype(dt_np)
                                   for a in _problem_data(B, seed))
    jq = jax.vmap(lambda a, b, c, x, uo, s, q: jocp.assemble_qp(
        dims, jt, jocp.StageDynamics(a, b, c), x, uo, cfg.dR,
        ss_points=s, qfun_sel=q))(*map(jnp.asarray,
                                       (A, Bm, C, x0, u_old, ss, qf)))
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    tq = tocp.assemble_qp(tdims, tt, tocp.StageDynamics(T(A), T(Bm), T(C)),
                          T(x0), T(u_old), cfg.dR, ss_points=T(ss),
                          qfun_sel=T(qf))
    return dims, tdims, jq, tq


def test_assemble_shift_unpack_equal():
    dims, tdims, jq, tq = _both_qps(3, 0)
    assert (tdims.nz, tdims.me, tdims.mi) == (dims.nz, dims.me, dims.mi)
    for name in ("P", "q", "A", "l", "u"):
        np.testing.assert_array_equal(getattr(tq, name).numpy(),
                                      np.asarray(getattr(jq, name)))
    rng = np.random.default_rng(1)
    z = rng.normal(size=(3, dims.nz))
    y = rng.normal(size=(3, dims.mi + dims.me))
    jz, jy = jax.vmap(lambda a, b: jocp.shift_warm(dims, a, b))(
        jnp.asarray(z), jnp.asarray(y))
    tz, ty = tocp.shift_warm(tdims, torch.from_numpy(z), torch.from_numpy(y))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    for a, b in zip(tocp.unpack(tdims, torch.from_numpy(z)),
                    jax.vmap(lambda a: jocp.unpack(dims, a))(jnp.asarray(z))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _to_t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@pytest.mark.parametrize("preset", ["default", "parity"])
def test_solve_f64_matches_reference(preset):
    """Cold solve, then a warm solve through the returned cache, as the
    LMPC step does."""
    dims, _, jq, tq = _both_qps(2, 2)
    jcfg = JS() if preset == "default" else JS.parity()
    tcfg = SolverConfig() if preset == "default" else SolverConfig.parity()
    jsol = jax.vmap(lambda p: jqp.solve(p, jcfg))(jq)
    tsol = tqp.solve(tq, tcfg)
    np.testing.assert_array_equal(tsol.iters.numpy(), np.asarray(jsol.iters))
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x), atol=1e-7)
    np.testing.assert_array_equal(tsol.solved.numpy(), np.asarray(jsol.solved))
    # warm start + factor cache on a perturbed problem
    _, _, jq2, tq2 = _both_qps(2, 3)
    jsol2 = jax.vmap(lambda p, x, y, f: jqp.solve(p, jcfg, warm=(x, y),
                                                   fac=f))(
        jq2, jsol.x, jsol.y, jsol.fac)
    tfac = tqp.FactorCache(*_to_t(tuple(jsol.fac)))
    tsol2 = tqp.solve(tq2, tcfg, warm=(torch.from_numpy(np.array(jsol.x)),
                                       torch.from_numpy(np.array(jsol.y))),
                      fac=tfac)
    np.testing.assert_array_equal(tsol2.iters.numpy(), np.asarray(jsol2.iters))
    np.testing.assert_allclose(tsol2.x.numpy(), np.asarray(jsol2.x), atol=1e-7)


def test_solve_f64_rescue_path_matches_reference():
    """The non-kernel rescue (rho escalation) in f64, batched with a lane
    that does not need it."""
    qp, base = _hard_rho_qp(np.random.default_rng(5))
    on = dataclasses.replace(base, use_pallas=False, rescue_max_iter=400,
                             rescue_rho_scale=100.0)
    qp2, _ = _hard_rho_qp(np.random.default_rng(6))
    jb = jax.tree_util.tree_map(lambda *a: jnp.stack(a).astype(jnp.float64),
                                qp, qp2)
    jsol = jax.vmap(lambda p: jqp.solve(p, on))(jb)
    tcfg = SolverConfig(**dataclasses.asdict(on))
    tsol = tqp.solve(tqp.QPData(*_to_t(tuple(jb))), tcfg)
    np.testing.assert_array_equal(tsol.iters.numpy(), np.asarray(jsol.iters))
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x), atol=1e-7)


def _pallas_batch(args, **kw):
    return jax.vmap(lambda *a: pallas_qp.admm_iterate(*a, interpret=True,
                                                      **kw))(*args)


def test_b1_plain_matches_pallas_fixed_iterations():
    _, _, _, tq = _both_qps(4, 7, np.float32)
    cfg = dataclasses.replace(SolverConfig.throughput(), eps_abs=0.0,
                              eps_rel=0.0, max_iter=16, check_every=16,
                              rescue_max_iter=0)
    pro, Kinv1, _ = tqp.admm_inputs(tq, cfg)
    kw = tqp.kernel_args(pro, Kinv1, cfg)
    names = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0",
             "z0", "y0")
    arrays = [kw.pop(k) for k in names]
    kw.pop("ns_tol")
    kw.pop("ns_max_iters")
    out = cuda_qp.admm_iterate(*arrays, **kw)
    ref = _pallas_batch([jnp.asarray(a.numpy()) for a in arrays], **kw)
    dx = np.abs(out[0].numpy() - np.asarray(ref[0])).max()
    assert dx < 3e-2, dx
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    assert cuda_qp.launches.n == 0


def test_b1_plain_matches_pallas_forced_rescue():
    qp, base = _hard_rho_qp(np.random.default_rng(3))
    cfg = dataclasses.replace(base, use_pallas=True, pallas_interpret=True,
                              rescue_max_iter=400, rescue_rho_scale=100.0)
    qp2, _ = _hard_rho_qp(np.random.default_rng(4))
    tq = tqp.QPData(*(torch.from_numpy(np.stack([np.asarray(a), np.asarray(b)])
                                       .astype(np.float32))
                      for a, b in zip(qp, qp2)))
    tcfg = SolverConfig(**dataclasses.asdict(cfg))
    pro, Kinv1, _ = tqp.admm_inputs(tq, tcfg)
    kw = tqp.kernel_args(pro, Kinv1, tcfg)
    names = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0",
             "z0", "y0")
    arrays = [kw.pop(k) for k in names]
    out = cuda_qp.admm_iterate(*arrays, **kw)
    ref = _pallas_batch([jnp.asarray(a.numpy()) for a in arrays], **kw)
    x, _, pri, _, iters, solved, rescued = out
    assert bool(rescued.all())
    np.testing.assert_array_equal(rescued.numpy(), np.asarray(ref[6]))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(solved.numpy(), np.asarray(ref[5]))
    assert float(pri.max()) < cfg.rescue_exit
    np.testing.assert_allclose(x.numpy(), np.asarray(ref[0]), atol=2e-3)
