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
- The two-pass Newton-Schulz that B4's plain prologue shares with B1's
  plain rescue (``cuda_qp.jacobi_start``, ``cuda_qp.ns_two_pass``)
  against the loop each of them wrote out before they shared it, bit for
  bit, through both callers.

The Pallas kernel returns no Newton-Schulz counts or warm decision;
``_pallas_ns`` replays its prologue (padded arrays, the same jnp
operations at HIGHEST precision) with counters, and is itself held to the
kernel's returned Kinv.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.ops import kkt_band as jkb
from racinglmpc_tpu.ops import pallas_qp
from racinglmpc_tpu.ops import qp as jqp
from racinglmpc_tpu.utils.config import SolverConfig as JS
from racinglmpc_tpu_torch.ops import cuda_qp, cuda_qp_fused, kkt_band
from racinglmpc_tpu_torch.ops import qp as tqp
from racinglmpc_tpu_torch.runtime import tracing
from racinglmpc_tpu_torch.utils.batched import lane_where as _w
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


def _jacobi_start_as_written(K):
    """The Jacobi start as the rescue and B4's plain prologue each wrote it
    before ``cuda_qp.jacobi_start``."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    dg = 1.0 / torch.clamp(torch.diagonal(K, dim1=1, dim2=2), min=1e-12)
    Rj = eye - K * dg[:, None, :]
    cj = torch.sqrt((Rj * Rj).sum((1, 2)))
    cjm = torch.clamp(cj, min=1.0)
    Xj = (eye * dg[:, None, :]) / cjm[:, None, None]
    return Xj, 1.0 / cjm


def _two_pass_as_written(K, Xi, xp_i, Xj, xj_pad, ns_tol, ns_max_iters,
                         seen):
    """The two Newton-Schulz passes as the rescue and B4's plain prologue
    each wrote them before ``cuda_qp.ns_two_pass``: per-lane exit, the pad
    scalar, the 50 ns_tol restart from Jacobi. Appends to ``seen`` which
    lanes started warm and which restarted."""
    Bsz, n, _ = K.shape
    dt, dev = K.dtype, K.device
    n_pad = cuda_qp._n_pad(n)
    eye = torch.eye(n, dtype=dt, device=dev)
    its = []

    def run(X, xp):
        X, xp = X.clone(), xp.clone()
        r = torch.full((Bsz,), math.inf, dtype=dt, device=dev)
        it = torch.zeros((Bsz,), dtype=torch.int32, device=dev)
        while True:
            act = (r > ns_tol) & (it < ns_max_iters)
            if not bool(act.any()):
                its.append(it)
                return X, r, xp
            R = eye - K @ X
            rmax = R.abs().amax((1, 2))
            if n_pad:
                rmax = torch.maximum(rmax, (1.0 - xp).abs())
            Xn = X + X @ R
            X = _w(act, Xn, X)
            r = torch.where(act, rmax, r)
            xp = torch.where(act, xp + xp * (1.0 - xp), xp)
            it = it + act.to(torch.int32)

    X1, r1, xp1 = run(Xi, xp_i)
    bad = ~torch.isfinite(r1) | (r1 > 50 * ns_tol)
    X2, r2, xp2 = run(_w(bad, Xj, X1), torch.where(bad, xj_pad, xp1))
    seen.append(dict(warm=(Xi != Xj).flatten(1).any(1), restart=bad))
    return X2, r2, xp2, its[0] + its[1]


def _ns_lanes(dt, s=1.0):
    """Five lanes at n = 12 (a pad block of 116) with K = A'(s rho A) + P +
    sigma I: lanes 0 and 1 carry a warm inverse within 1% and 0.1%, lane 2
    a zero one (its warm test fails), lanes 3 and 4 none. Lane 3's K is near
    diagonal (|I - K diag(d)|_F < 1: the Jacobi start's clamp); lane 4's
    has eigenvalues from 1e-5 to 10 in a dense basis, so that its first
    pass ends far above ns_tol and it restarts from Jacobi, its pad scalar
    still short of 1 when the second pass ends."""
    B, n, m, sigma = 5, 12, 10, 1e-6
    g = torch.Generator().manual_seed(0)
    f64 = torch.float64
    eye = torch.eye(n, dtype=f64)
    M = torch.randn(B, n, n, generator=g, dtype=f64)
    P = M @ M.transpose(1, 2) / n + 0.1 * eye
    N = 0.01 * torch.randn(n, n, generator=g, dtype=f64)
    P[3] = torch.diag(torch.linspace(1.0, 2.0, n, dtype=f64)) + N + N.T
    Q = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=f64))[0]
    P[4] = Q @ torch.diag(torch.logspace(-5, 1, n, dtype=f64)) @ Q.T
    A = 0.3 * torch.randn(B, m, n, generator=g, dtype=f64)
    A[3:] *= 1e-3
    rho = 0.1 + torch.rand(B, m, generator=g, dtype=f64)
    K = (A.transpose(1, 2) @ (A * rho[:, :, None])) * s + P + sigma * eye
    Kinv = torch.linalg.inv(K)
    noise = torch.tensor([0.01, 0.001, 0.0, 0.0, 0.0], dtype=f64)
    Kinv = Kinv * (1.0 + noise[:, None, None]
                   * torch.rand(B, n, n, generator=g, dtype=f64))
    Kinv[2:] = 0.0
    return tuple(t.to(dt) for t in (P, A, rho, Kinv)) + (sigma,)


@pytest.mark.parametrize("caller", ["rescue", "b4"])
def test_shared_two_pass_newton_schulz_keeps_each_callers_bits(caller,
                                                              monkeypatch):
    """B1's plain rescue (``cuda_qp._rescue_kinv``, float32 and float64)
    and B4's plain prologue (``cuda_qp_fused.prologue_plain``, float32)
    give the bits they gave when each wrote the Jacobi start and the two
    Newton-Schulz passes out for itself: the inverse, and for B4 the
    residual, pad scalar, warm decisions and iteration counts; for the
    rescue its armed counters. The lanes: warm and cold, one restarted, n
    not a multiple of 128."""
    ns_tol, ns_max_iters, s = 1e-4, 7, 5.0
    dtypes = ((torch.float32, torch.float64) if caller == "rescue"
              else (torch.float32,))
    for dt in dtypes:
        if caller == "rescue":
            P, A, rho, Kinv, sigma = _ns_lanes(dt, s)
            # the rescue tries Kinv / s where the pad scalar is near s:
            # lane 1's pad residual |1 - 0.92| outlasts its K's, so the
            # pad scalar sets its exit; at 1 the pad block fails the warm
            # test
            kpad = torch.tensor([s, 0.92 * s, s, 1.0, 1.0], dtype=dt)

            def run():
                with tracing.session() as rec:
                    X = cuda_qp._rescue_kinv(P, A, s * Kinv, kpad, rho,
                                             sigma, s, ns_tol, ns_max_iters)
                return X, {k: v for k, v in rec.counts.items()
                           if k.startswith("admm.rescue.")}
        else:
            P, A, rho, Kinv, sigma = _ns_lanes(dt)
            warm_ok = torch.tensor([True, True, True, False, False])

            def run():
                return cuda_qp_fused.prologue_plain(
                    P, A, Kinv, warm_ok, rho, sigma=sigma, ns_tol=ns_tol,
                    ns_max_iters=ns_max_iters)

        new = run()
        seen = []
        with monkeypatch.context() as mp:
            mp.setattr(cuda_qp, "jacobi_start", _jacobi_start_as_written)
            mp.setattr(cuda_qp, "ns_two_pass",
                       lambda *a: _two_pass_as_written(*a, seen=seen))
            old = run()
        assert len(seen) == 1
        assert seen[0]["warm"].tolist() == [True, True, False, False, False]
        # lane 4 restarts (the rescue's K2 restarts lane 2 as well), the
        # warm and near-diagonal lanes do not
        restart = seen[0]["restart"].tolist()
        assert restart[4] and not (restart[0] or restart[1] or restart[3])
        if caller == "rescue":
            assert new[1] == old[1]
            assert new[1]["admm.rescue.lanes"] == 5
            assert new[1]["admm.rescue.warm_tests"] == 3
            new, old = new[:1], old[:1]
        for a, b in zip(new, old):
            assert a.dtype == b.dtype
            assert torch.equal(a, b), (caller, dt)
