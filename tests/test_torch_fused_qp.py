"""Kernel B4's plain version against the Pallas fused kernel
(``pallas_qp.admm_iterate_fused``, interpret mode), in float32.

- Random QPs of ``tests/test_pallas_qp.py`` (n = 30, so n is padded by 98
  and the pad scalar matters) at that file's batched-fused settings (eps
  3e-4: at 1e-4 these problems sit on the tolerance at a check, and
  float32 rounding moves lanes by one chunk either way), cold (Jacobi
  build) and warm (the cold solve's refreshed inverse as the cache, ADMM
  from zero so it iterates): equal ADMM iteration counts, equal
  Newton-Schulz iteration counts and warm/cold decisions, the refreshed
  Kinv to 1e-4 relative to its max, x to 5e-4 (B1's plain loop alone, fed
  the Pallas kernel's own Kinv, differs from it by 2.1e-4 here after 50
  float32 iterations: summation order).
- Real N = 14 FTOCPs assembled by JAX (cond(K) ~ 1e6, so no elementwise
  Kinv comparison): the same warm/cold decision, both ns_resid below
  ns_tol, x to 3e-2 after 16 fixed iterations, the same solved flag at
  tolerance under ``throughput()``.
- ``qp.solve`` with ``pallas_fused_ns`` against JAX's on the same random
  QPs, cold and warm through the returned cache (equal iteration counts
  and cache validity, x to 2e-3, the solver's own eps scale), and the
  precedence of the structured build over the fused kernel.

The Pallas kernel returns no Newton-Schulz counts or warm decision;
``_pallas_ns`` replays its prologue (padded arrays, the same jnp
operations at HIGHEST precision) with counters, and is itself held to the
kernel's returned Kinv.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.ops import kkt_band as jkb
from racinglmpc_tpu.ops import pallas_qp
from racinglmpc_tpu.ops import qp as jqp
from racinglmpc_tpu.utils.config import SolverConfig as JS
from racinglmpc_tpu_torch.ops import cuda_qp_fused, kkt_band
from racinglmpc_tpu_torch.ops import qp as tqp
from racinglmpc_tpu_torch.utils.config import SolverConfig
from tests.test_kkt_band import _ftocp_qp
from tests.test_pallas_qp import _random_qp

torch.set_num_threads(1)
NAMES = ("P", "A", "kinv0", "warm_ok", "q", "l", "u", "rho", "D", "E", "c",
         "x0", "z0", "y0")
BASE = SolverConfig(max_iter=200, polish=False, adaptive_rho=False,
                    eps_abs=3e-4, eps_rel=3e-4, use_pallas=True,
                    pallas_interpret=True, pallas_fused_ns=True)


def _stack(qps):
    return tqp.QPData(*(torch.from_numpy(np.stack(
        [np.asarray(getattr(q, f)) for q in qps]).astype(np.float32))
        for f in tqp.QPData._fields))


def _inputs(tq, cfg, warm=None, fac=None):
    kw = tqp.fused_inputs(tq, cfg, warm, fac)
    return [kw.pop(k) for k in NAMES], kw


def _pallas(arrays, kw):
    ja = [jnp.asarray(a.numpy()) for a in arrays]
    return jax.vmap(lambda *a: pallas_qp.admm_iterate_fused(
        *a, interpret=True, **kw))(*ja)


def _pallas_ns(P, A, X0, warm_ok, rho, *, sigma, ns_tol, ns_max_iters):
    """The Pallas kernel's K build, warm test and two NS passes on its
    padded arrays, for one problem. Returns (Kinv, warm, iterations)."""
    n, m = P.shape[0], A.shape[0]
    np_, mp_ = -(-n // 128) * 128, -(-m // 128) * 128
    f32, hi = jnp.float32, jax.lax.Precision.HIGHEST
    Pp = jnp.zeros((np_, np_), f32).at[:n, :n].set(P)
    Ap = jnp.zeros((mp_, np_), f32).at[:m, :n].set(A)
    rho_p = jnp.ones((mp_,), f32).at[:m].set(rho)
    pad = jnp.concatenate([jnp.zeros(n, f32), jnp.ones(np_ - n, f32)])
    Xp0 = jnp.zeros((np_, np_), f32).at[:n, :n].set(X0) + jnp.diag(pad)
    eye = jnp.eye(np_, dtype=f32)
    diag_add = jnp.diag(jnp.where(jnp.arange(np_) < n, f32(sigma), f32(1)))
    K = jnp.dot(Ap.T, Ap * rho_p[:, None], precision=hi) + Pp + diag_add
    d = 1.0 / jnp.clip(jnp.diagonal(K), 1e-12, None)
    cj = jnp.sqrt(jnp.sum((eye - K * d[None, :]) ** 2))
    Xj = (eye * d[None, :]) / jnp.maximum(cj, 1.0)
    R0 = eye - jnp.dot(K, Xp0, precision=hi)
    r0 = float(jnp.sqrt(jnp.sum(R0 * R0)))
    warm = bool(warm_ok) and np.isfinite(r0) and r0 < 0.9
    X, total = (Xp0 if warm else Xj), 0
    for p in range(2):
        r, it = np.inf, 0
        while r > ns_tol and it < ns_max_iters:
            R = eye - jnp.dot(K, X, precision=hi)
            X = X + jnp.dot(X, R, precision=hi)
            r, it = float(jnp.max(jnp.abs(R))), it + 1
        total += it
        if p == 0 and (not np.isfinite(r) or r > 50 * ns_tol):
            X = Xj
    return np.asarray(X[:n, :n]), warm, total


def _ns_reference(arrays, kw):
    a = {k: v.numpy() for k, v in zip(NAMES, arrays)}
    out = [_pallas_ns(a["P"][i], a["A"][i], a["kinv0"][i], a["warm_ok"][i],
                      a["rho"][i], sigma=kw["sigma"], ns_tol=kw["ns_tol"],
                      ns_max_iters=kw["ns_max_iters"])
           for i in range(a["P"].shape[0])]
    return [np.stack(v) for v in zip(*out)]


def test_b4_plain_matches_pallas_random_qps_cold_and_warm():
    rng = np.random.default_rng(11)
    tq = _stack([_random_qp(rng=rng) for _ in range(4)])
    arrays, kw = _inputs(tq, BASE)
    cold = cuda_qp_fused.admm_iterate_fused(*arrays, **kw)
    sol = tqp.solve(tq, BASE)
    assert bool(sol.fac.valid.all())
    warm_arrays, _ = _inputs(tq, BASE, fac=sol.fac)
    for arrs, expect_warm in ((arrays, False), (warm_arrays, True)):
        out = cuda_qp_fused.admm_iterate_fused(*arrs, **kw)
        ref = _pallas(arrs, kw)
        kinv_r, warm_r, ns_r = _ns_reference(arrs, kw)
        scale = np.abs(np.asarray(ref[6])).max()
        assert np.abs(kinv_r - np.asarray(ref[6])).max() / scale < 1e-4
        np.testing.assert_array_equal(out.warm.numpy(), warm_r)
        assert bool(out.warm.all()) == expect_warm
        np.testing.assert_array_equal(out.ns_iters.numpy(), ns_r)
        np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref[4]))
        np.testing.assert_array_equal(out.solved.numpy(), np.asarray(ref[5]))
        np.testing.assert_allclose(out.x.numpy(), np.asarray(ref[0]),
                                   atol=5e-4)
        assert np.abs(out.kinv.numpy() - np.asarray(ref[6])).max() \
            / scale < 1e-4
        assert float(out.ns_resid.max()) < kw["ns_tol"]
        assert int(out.iters.min()) > 0
    assert cuda_qp_fused.launches.n == 0
    assert cold.kinv_pad.shape == (4,)


@pytest.mark.parametrize("warm", [False, True])
def test_b4_plain_matches_pallas_real_ftocp(warm):
    tq = _stack([_ftocp_qp(K_ss=48, dtype=jnp.float32, seed=s)[1]
                 for s in (0, 1)])
    tol_cfg = dataclasses.replace(SolverConfig.throughput(),
                                  pallas_fused_ns=True, pallas_interpret=True)
    fixed = dataclasses.replace(tol_cfg, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    fac = None
    if warm:
        fac = tqp.solve(tq, tol_cfg).fac
        assert bool(fac.valid.all())
    for cfg in (fixed, tol_cfg):
        arrays, kw = _inputs(tq, cfg, fac=fac)
        out = cuda_qp_fused.admm_iterate_fused(*arrays, **kw)
        ref = _pallas(arrays, kw)
        _, warm_r, _ = _ns_reference(arrays, kw)
        np.testing.assert_array_equal(out.warm.numpy(), warm_r)
        assert bool(out.warm.all()) == warm
        assert float(out.ns_resid.max()) < kw["ns_tol"]
        assert float(np.asarray(ref[7]).max()) < kw["ns_tol"]
        if cfg is fixed:
            dx = np.abs(out.x.numpy() - np.asarray(ref[0])).max()
            assert dx < 3e-2, dx
        else:
            np.testing.assert_array_equal(out.solved.numpy(),
                                          np.asarray(ref[5]))
            assert bool(out.solved.all())


def test_solve_fused_matches_reference():
    rng = np.random.default_rng(11)
    qps = [_random_qp(rng=rng) for _ in range(4)]
    jq = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qps)
    jcfg = JS(**dataclasses.asdict(BASE))
    jsol = jax.vmap(lambda p: jqp.solve(p, jcfg))(jq)
    tsol = tqp.solve(_stack(qps), BASE)
    np.testing.assert_array_equal(tsol.iters.numpy(), np.asarray(jsol.iters))
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x), atol=2e-3)
    np.testing.assert_array_equal(tsol.fac.valid.numpy(),
                                  np.asarray(jsol.fac.valid))
    jsol2 = jax.vmap(lambda p, x, y, f: jqp.solve(p, jcfg, warm=(x, y),
                                                   fac=f))(
        jq, jsol.x, jsol.y, jsol.fac)
    tsol2 = tqp.solve(_stack(qps), BASE, warm=(tsol.x, tsol.y), fac=tsol.fac)
    np.testing.assert_array_equal(tsol2.iters.numpy(),
                                  np.asarray(jsol2.iters))
    np.testing.assert_allclose(tsol2.x.numpy(), np.asarray(jsol2.x),
                               atol=2e-3)


def test_structured_build_takes_precedence_over_fused(monkeypatch):
    """With a band structure and ``kkt_structured`` the fused kernel is not
    reached (as in the reference); without the structure it is."""
    dims, qp = _ftocp_qp(K_ss=48, dtype=jnp.float32, seed=0)
    tq = _stack([qp])
    cfg = dataclasses.replace(SolverConfig.throughput_max(),
                              pallas_fused_ns=True, pallas_interpret=True)
    st = kkt_band.band_structure(dims.N, dims.K)
    calls = []
    real = cuda_qp_fused.admm_iterate_fused

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(cuda_qp_fused, "admm_iterate_fused", spy)
    s_st = tqp.solve(tq, cfg, structure=st)
    assert not calls
    jsol = jqp.solve(qp, JS(**dataclasses.asdict(cfg)),
                     structure=jkb.band_structure(dims.N, dims.K))
    np.testing.assert_allclose(s_st.x.numpy()[0], np.asarray(jsol.x),
                               atol=3e-2)
    tqp.solve(tq, cfg)
    assert calls == [1]
    tqp.solve(tq, dataclasses.replace(cfg, kkt_structured=False),
              structure=st)
    assert calls == [1, 1]


def test_random_qps_follow_the_reference_construction():
    """``utils.qp_cases.random_qps`` (B4's small-n inputs on the card) draws
    the QPs of ``tests/test_pallas_qp.py:_random_qp`` from the same seed."""
    from racinglmpc_tpu_torch.utils.qp_cases import random_qps

    rng = np.random.default_rng(11)
    ref = [_random_qp(rng=rng) for _ in range(3)]
    got = random_qps(3, device="cpu")
    for i, r in enumerate(ref):
        for a, b in zip(r, got):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy())
