"""The ADMM kernels' iteration precisions (``pallas_iter_precision``):
"bf16x3" and "default" in the plain versions of B1 and B4 and in
``qp.solve``, against the reference and against float64 transcriptions.

Why the tolerances are what they are: at "bf16x3" each operand of an
iteration product is rounded to about 16 significant bits (hi + lo), so a
last-bit difference of a float32 sum (another summation order) can move a
product by ~2^-17 relative instead of ~2^-24, and the iteration amplifies
that as cond(K) allows. On the LMPC FTOCPs after 16 iterations that puts the
port and the reference ~1e-2 apart, the same as the port against itself with
float64 accumulation. So:

- the sharp checks are the products against a float64 transcription of the
  split (exact products, exact sums), B1 on well-conditioned random QPs
  (the reference's ``_random_qp``), where the two packages agree to 7.8e-4
  after 16 iterations while "bf16x3" moves x by 4.1e-3 from "highest", and
  B4's loop against B1's on B4's own refreshed inverse (equal bits);
- the LMPC-shaped checks hold the reference kernels' own 3e-2
  (``examples/tpu_smoke.py``) after 16 fixed iterations on the N = 6
  FTOCPs of ``tests/test_torch_ocp_qp.py`` (B1 9.2e-3, B4 1.3e-2 there). On
  the N = 14 FTOCPs of ``tests/test_kkt_band.py`` B4 is 0.105 from the
  reference after 16 iterations, where the reference's own "bf16x3" is
  0.086 from its "highest": its prologue's Kinv differs from the port's by
  5.2e-4 relative (float32 Newton-Schulz in another order), and the
  "bf16x3" loop amplifies that; no tolerance there could tell the variants
  apart, so that case is not a test;
- ``qp.solve`` is an integration check at eps 1e-2 (both packages solve
  every QP in one chunk; x within 1.5e-2: on the B1 route the Newton-Schulz
  prologues of the two packages differ as above, and x is 5.9e-3 apart);
- "default" diverges on these FTOCPs (|x| ~ 400 after one iteration on the
  main path's), and the reference's interpret mode computes it in full
  float32 (XLA on the CPU ignores ``Precision.DEFAULT``), so it is held to
  a float64 transcription of one iteration on bf16-rounded operands (1e-4
  of max|x| per lane; measured <= 6.3e-6) and shown to differ from
  "highest" (>= 5e-3 per lane measured; checked at 1e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from racinglmpc_tpu.ops import qp as jqp
from racinglmpc_tpu.utils.config import SolverConfig as JS
from racinglmpc_tpu_torch.ops import cuda_qp, cuda_qp_fused
from racinglmpc_tpu_torch.ops import qp as tqp
from racinglmpc_tpu_torch.utils.config import SolverConfig
from tests.test_pallas_qp import _hard_rho_qp, _random_qp
from tests.test_torch_fused_qp import BASE, _inputs, _pallas, _stack
from tests.test_torch_ocp_qp import _both_qps, _pallas_batch

torch.set_num_threads(1)
NAMES = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0", "z0",
         "y0")


def _bf16_np(x):
    """float32 -> bfloat16, round to nearest even, as float64 (a
    transcription of the rounding on the bits)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _split_np(x):
    hi = _bf16_np(x)
    return hi, _bf16_np(np.asarray(x, np.float64) - hi)


def _random_set():
    rng = np.random.default_rng(11)
    return _stack([_random_qp(rng=rng) for _ in range(4)])


def _b1_args(tq, cfg):
    pro, kinv, _ = tqp.admm_inputs(tq, cfg)
    kw = tqp.kernel_args(pro, kinv, cfg)
    arrays = [kw.pop(k) for k in NAMES]
    kw.pop("ns_tol")
    kw.pop("ns_max_iters")
    return arrays, kw


def _fixed(cfg, iters, prec):
    return dataclasses.replace(cfg, eps_abs=0.0, eps_rel=0.0,
                               max_iter=iters, check_every=iters,
                               rescue_max_iter=0, pallas_iter_precision=prec)


def test_bf16_rounds_to_nearest_even():
    rng = np.random.default_rng(0)
    ties = (np.arange(1, 4096, dtype=np.uint32) << 15
            | np.uint32(0x3F800000)).view(np.float32)
    x = np.concatenate([rng.normal(size=20000).astype(np.float32) * 1e3,
                        ties, -ties])
    got = cuda_qp.bf16(torch.from_numpy(x)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, _bf16_np(x))
    hi, lo = cuda_qp.split_bf16(torch.from_numpy(x))
    ref_hi, ref_lo = _split_np(x)
    np.testing.assert_array_equal(hi.numpy(), ref_hi)
    np.testing.assert_array_equal(lo.numpy(), ref_lo)


@pytest.mark.parametrize("prec", ["bf16x3", "default"])
def test_products_match_float64_transcription(prec):
    """v.M and M v at ``prec`` against the same split operands multiplied
    and summed in float64 (products of bf16 values are exact in float32,
    so only the float32 sums differ: 1e-6 of the sum of |terms|)."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(3, 40)).astype(np.float32)
    M = rng.normal(size=(3, 40, 30)).astype(np.float32)
    w = rng.normal(size=(3, 30)).astype(np.float32)
    Mf = cuda_qp.iter_operand(torch.from_numpy(M), prec)
    vm = cuda_qp.vm_at(torch.from_numpy(v), Mf, prec).numpy()
    mv = cuda_qp.mv_at(Mf, torch.from_numpy(w), prec).numpy()
    if prec == "bf16x3":
        (vh, vl), (Mh, Ml), (wh, wl) = map(_split_np, (v, M, w))
        ref_vm = (np.einsum("bi,bij->bj", vh, Mh)
                  + (np.einsum("bi,bij->bj", vh, Ml)
                     + np.einsum("bi,bij->bj", vl, Mh)))
        ref_mv = (np.einsum("bij,bj->bi", Mh, wh)
                  + (np.einsum("bij,bj->bi", Ml, wh)
                     + np.einsum("bij,bj->bi", Mh, wl)))
    else:
        ref_vm = np.einsum("bi,bij->bj", _bf16_np(v), _bf16_np(M))
        ref_mv = np.einsum("bij,bj->bi", _bf16_np(M), _bf16_np(w))
    scale_vm = np.einsum("bi,bij->bj", np.abs(v), np.abs(M))
    scale_mv = np.einsum("bij,bj->bi", np.abs(M), np.abs(w))
    assert (np.abs(vm - ref_vm) / scale_vm).max() < 1e-6
    assert (np.abs(mv - ref_mv) / scale_mv).max() < 1e-6
    # the rounding is applied: "highest" gives other values
    exact = np.einsum("bi,bij->bj", v.astype(np.float64), M)
    assert (np.abs(vm - exact) / scale_vm).max() > 1e-7


@pytest.mark.parametrize("case,tol", [("lmpc_n6", 3e-2),
                                      ("random_n30", 2e-3)])
def test_b1_plain_matches_pallas_bf16x3_fixed_iterations(case, tol):
    tq = (_both_qps(4, 7, np.float32)[3] if case == "lmpc_n6"
          else _random_set())
    base = SolverConfig.throughput() if case == "lmpc_n6" else BASE
    arrays, kw = _b1_args(tq, _fixed(base, 16, "bf16x3"))
    assert kw["iter_precision"] == "bf16x3"
    out = cuda_qp.admm_iterate(*arrays, **kw)
    ref = _pallas_batch([jnp.asarray(a.numpy()) for a in arrays], **kw)
    dx = np.abs(out[0].numpy() - np.asarray(ref[0])).max()
    assert dx < tol, dx
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    assert cuda_qp.launches.n == 0


def test_b4_plain_matches_pallas_bf16x3_fixed_iterations():
    tq = _both_qps(4, 7, np.float32)[3]
    cfg = dataclasses.replace(_fixed(SolverConfig.throughput(), 16, "bf16x3"),
                              pallas_fused_ns=True, pallas_interpret=True)
    arrays, kw = _inputs(tq, cfg)
    assert kw["iter_precision"] == "bf16x3"
    out = cuda_qp_fused.admm_iterate_fused(*arrays, **kw)
    ref = _pallas(arrays, kw)
    dx = np.abs(out.x.numpy() - np.asarray(ref[0])).max()
    assert dx < 3e-2, dx
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref[4]))
    assert cuda_qp_fused.launches.n == 0


@pytest.mark.parametrize("prec", ["bf16x3", "default"])
def test_b4_loop_is_b1_loop_on_its_refreshed_inverse(prec):
    """B4's ADMM phase at ``prec`` is B1's plain loop at ``prec`` on B4's
    refreshed inverse and pad scalar, bit for bit; its prologue does not
    depend on the precision."""
    tq = _random_set()
    cfg = dataclasses.replace(_fixed(BASE, 4, prec), pallas_fused_ns=True)
    arrays, kw = _inputs(tq, cfg)
    out = cuda_qp_fused.admm_iterate_fused(*arrays, **kw)
    hi = cuda_qp_fused.admm_iterate_fused(
        *arrays, **dict(kw, iter_precision="highest"))
    for a, b in ((out.kinv, hi.kinv), (out.ns_resid, hi.ns_resid),
                 (out.kinv_pad, hi.kinv_pad), (out.ns_iters, hi.ns_iters)):
        assert torch.equal(a, b)
    a = dict(zip(("P", "A", "kinv0", "warm_ok", "q", "l", "u", "rho", "D",
                  "E", "c", "x0", "z0", "y0"), arrays))
    b1 = cuda_qp.admm_iterate_plain(
        a["P"], out.kinv, a["A"], a["q"], a["l"], a["u"], a["rho"], a["D"],
        a["E"], a["c"], a["x0"], a["z0"], a["y0"], kinv_pad=out.kinv_pad,
        **kw)
    assert torch.equal(out.x, b1[0]) and torch.equal(out.y, b1[1])
    assert not torch.equal(out.x, hi.x)


@pytest.mark.parametrize("fused", [False, True])
def test_solve_bf16x3_matches_reference(fused):
    rng = np.random.default_rng(11)
    qps = [_random_qp(rng=rng) for _ in range(4)]
    jq = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qps)
    cfg = dataclasses.replace(BASE, eps_abs=1e-2, eps_rel=1e-2,
                              pallas_fused_ns=fused,
                              pallas_iter_precision="bf16x3")
    jsol = jax.vmap(lambda p: jqp.solve(p, JS(**dataclasses.asdict(cfg))))(
        jq)
    tsol = tqp.solve(_stack(qps), cfg)
    np.testing.assert_array_equal(tsol.solved.numpy(),
                                  np.asarray(jsol.solved))
    assert bool(tsol.solved.all())
    assert np.abs(tsol.iters.numpy() - np.asarray(jsol.iters)).max() \
        <= cfg.check_every
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x), atol=1.5e-2)


def _one_iter_float64(arrays, sigma, alpha, refine):
    """One iteration of the ADMM loop in float64 on bf16-rounded operands
    (the "default" products)."""
    P, K, A, q, l, u, rho, D, E, c, x, z, y = (
        np.asarray(t.numpy(), np.float64) for t in arrays)
    l, u = np.clip(l, -1e30, 1e30), np.clip(u, -1e30, 1e30)

    def vm(v, M):
        return np.einsum("bi,bij->bj", _bf16_np(v), _bf16_np(M))

    def mv(M, v):
        return np.einsum("bij,bj->bi", _bf16_np(M), _bf16_np(v))

    rhs = sigma * x - q + vm(rho * z - y, A)
    xt = vm(rhs, K)
    for _ in range(refine):
        r = rhs - (vm(xt, P) + sigma * xt + vm(rho * mv(A, xt), A))
        xt = xt + vm(r, K)
    zt = mv(A, xt)
    z_rel = alpha * zt + (1 - alpha) * z
    z_new = np.clip(z_rel + y / rho, l, u)
    return alpha * xt + (1 - alpha) * x, y + rho * (z_rel - z_new)


@pytest.mark.parametrize("case", ["lmpc_n6", "random_n30"])
def test_default_one_iteration_matches_float64_transcription(case):
    tq = (_both_qps(4, 7, np.float32)[3] if case == "lmpc_n6"
          else _random_set())
    arrays, kw = _b1_args(tq, _fixed(BASE, 1, "default"))
    out = cuda_qp.admm_iterate(*arrays, **kw)
    x64, y64 = _one_iter_float64(arrays, kw["sigma"], kw["alpha"],
                                 kw["refine_steps"])
    sx = np.abs(x64).max(1)
    assert (np.abs(out[0].numpy() - x64).max(1) / sx).max() < 1e-4
    sy = np.abs(y64).max(1)
    assert (np.abs(out[1].numpy() - y64).max(1) / sy).max() < 1e-4
    hi = cuda_qp.admm_iterate(*arrays, **dict(kw, iter_precision="highest"))
    assert (np.abs(out[0].numpy() - hi[0].numpy()).max(1) / sx).min() > 1e-3


def test_bf16x3_forced_rescue_matches_reference():
    """The rescue iterates at full float32 whatever the main loop's
    precision: its flags and iteration counts equal the reference's."""
    qp, base = _hard_rho_qp(np.random.default_rng(3))
    qp2, _ = _hard_rho_qp(np.random.default_rng(4))
    cfg = dataclasses.replace(base, use_pallas=True, pallas_interpret=True,
                              rescue_max_iter=400, rescue_rho_scale=100.0,
                              pallas_iter_precision="bf16x3")
    tq = tqp.QPData(*(torch.from_numpy(np.stack([np.asarray(a), np.asarray(b)])
                                       .astype(np.float32))
                      for a, b in zip(qp, qp2)))
    tcfg = SolverConfig(**dataclasses.asdict(cfg))
    pro, Kinv1, _ = tqp.admm_inputs(tq, tcfg)
    kw = tqp.kernel_args(pro, Kinv1, tcfg)
    arrays = [kw.pop(k) for k in NAMES]
    out = cuda_qp.admm_iterate(*arrays, **kw)
    ref = _pallas_batch([jnp.asarray(a.numpy()) for a in arrays], **kw)
    x, _, pri, _, iters, solved, rescued = out
    assert bool(rescued.all())
    np.testing.assert_array_equal(rescued.numpy(), np.asarray(ref[6]))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(solved.numpy(), np.asarray(ref[5]))
    assert float(pri.max()) < cfg.rescue_exit
    np.testing.assert_allclose(x.numpy(), np.asarray(ref[0]), atol=2e-3)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_unknown_iter_precision_raises(package):
    """Any string but the three raises ValueError on the kernel path, in
    both packages (e.g. "high", which examples/sweep_solver.py passes)."""
    rng = np.random.default_rng(11)
    qps = [_random_qp(rng=rng) for _ in range(2)]
    cfg = dataclasses.replace(BASE, pallas_iter_precision="high")
    if package == "reference":
        jq = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qps)
        with pytest.raises(ValueError, match="iter_precision"):
            jax.vmap(lambda p: jqp.solve(p, JS(**dataclasses.asdict(cfg))))(
                jq)
        return
    tq = _stack(qps)
    for fused in (False, True):
        with pytest.raises(ValueError, match="iter_precision"):
            tqp.solve(tq, dataclasses.replace(cfg, pallas_fused_ns=fused))
    arrays, kw = _b1_args(
        tq, dataclasses.replace(cfg, pallas_iter_precision="highest"))
    with pytest.raises(ValueError, match="iter_precision"):
        cuda_qp.admm_iterate(*arrays, **dict(kw, iter_precision="high"))
    with pytest.raises(ValueError, match="iter_precision"):
        cuda_qp.admm_iterate_plain(*arrays,
                                   **dict(kw, iter_precision="high"))
    farrays, fkw = _inputs(tq, dataclasses.replace(
        cfg, pallas_iter_precision="highest", pallas_fused_ns=True))
    with pytest.raises(ValueError, match="iter_precision"):
        cuda_qp_fused.admm_iterate_fused(*farrays,
                                         **dict(fkw, iter_precision="high"))
    # off the kernel path the field is not read, as in the reference
    plain = dataclasses.replace(cfg, use_pallas=False, adaptive_rho=True)
    assert bool(torch.isfinite(tqp.solve(tq, plain).x).all())


class _permuted_products:
    """Inside the block the plain loop's products (``cuda_qp._vm``,
    ``_mv``) sum in another order, a fixed permutation of the summed index
    per length from ``seed``: a stand-in for a kernel's summation order."""

    def __init__(self, seed):
        self.seed = seed

    def __enter__(self):
        vm, mv = self.saved = (cuda_qp._vm, cuda_qp._mv)
        gen, perms = torch.Generator().manual_seed(self.seed), {}

        def perm(k):
            if k not in perms:
                perms[k] = torch.randperm(k, generator=gen)
            return perms[k]

        cuda_qp._vm = lambda v, M: vm(v[..., perm(v.shape[-1])],
                                      M[..., perm(v.shape[-1]), :])
        cuda_qp._mv = lambda M, v: mv(M[..., perm(v.shape[-1])],
                                      v[..., perm(v.shape[-1])])

    def __exit__(self, *exc):
        cuda_qp._vm, cuda_qp._mv = self.saved


@pytest.mark.parametrize("kernel", ["admm", "fused_admm"])
def test_sharp_check_limits_lie_between_order_and_precision(kernel):
    """``chip_smoke.py``'s one-iteration check on random QPs (its
    ``SHARP`` limits) accepts the plain version in three other summation
    orders and refuses every other precision, "highest" included, for B1
    and for B4's ADMM phase."""
    run_k, run_p = chip_smoke.sharp_runs(tqp, cuda_qp, cuda_qp_fused, kernel,
                                         device="cpu")
    plain = {prec: chip_smoke.sharp_plain(cuda_qp, run_p, prec)
             for prec in chip_smoke.VARIANTS}
    for seed in range(3):
        with _permuted_products(seed):
            xs = {prec: run_k(prec) for prec in cuda_qp.ITER_PRECISIONS}
        for prec in chip_smoke.VARIANTS:
            assert not torch.equal(xs[prec], plain[prec][0])
            ok, detail, _ = chip_smoke.sharp_agrees(prec, xs, *plain[prec])
            assert ok, (seed, prec, detail)


def test_bf16_other_is_the_neighbour_across_the_value():
    """``chip_smoke.bf16_other``: a bfloat16 value, one bf16 step from the
    rounding, with the float32 value between the two."""
    rng = np.random.default_rng(3)
    t = torch.tensor(rng.normal(size=20000) * 2.0 ** rng.integers(
        -20, 20, size=20000), dtype=torch.float32)
    h = cuda_qp.bf16(t)
    keep = (t != h) & (h != 0)
    t, h = t[keep], h[keep]
    o = chip_smoke.bf16_other(t, h)
    assert torch.equal(cuda_qp.bf16(o), o)
    assert bool(((t - h) * (o - t) > 0).all())
    assert bool(((o - h).abs() <= h.abs() * 2.0 ** -7).all())


@pytest.mark.parametrize("kernel", ["admm", "fused_admm"])
@pytest.mark.parametrize("whole_lane", [False, True])
def test_sharp_check_refuses_a_lane_no_flip_explains(kernel, whole_lane):
    """At "default" a lane of the kernel's x moved from the plain version's
    by 1.5e-2 (beyond the max limit) in one coordinate, or in every one, is
    refused although one-flip variants are offered: none lies within the
    mean limit of it."""
    run_k, run_p = chip_smoke.sharp_runs(tqp, cuda_qp, cuda_qp_fused, kernel,
                                         device="cpu")
    px, flipped = chip_smoke.sharp_plain(cuda_qp, run_p, "default")
    assert flipped
    xs = {prec: run_k(prec) for prec in ("highest", "bf16x3")}
    assert chip_smoke.sharp_agrees("default", dict(xs, default=px), px,
                                   flipped)[0]
    B, n = px.shape
    for lane in range(B):
        for j in ([slice(None)] if whole_lane else range(n)):
            kx = px.clone()
            kx[lane, j] += 1.5e-2
            ok, detail, _ = chip_smoke.sharp_agrees(
                "default", dict(xs, default=kx), px, flipped)
            assert not ok, (lane, j, detail)


def test_sharp_check_refuses_a_dropped_cross_term(monkeypatch):
    """A bf16x3 product without v_lo . M_hi (or without v_hi . M_lo) fails
    ``chip_smoke.py``'s one-iteration check."""
    run_k, run_p = chip_smoke.sharp_runs(tqp, cuda_qp, cuda_qp_fused, "admm",
                                         device="cpu")
    px = run_p("bf16x3")
    at = cuda_qp._at
    for keep in (lambda hl, lh: hl, lambda hl, lh: lh):
        def dropped(prod, v, Mf, prec, keep=keep):
            if prec != "bf16x3":
                return at(prod, v, Mf, prec)
            vh, vl = cuda_qp.split_bf16(v)
            return prod(vh, Mf[0]) + keep(prod(vh, Mf[1]), prod(vl, Mf[0]))

        with monkeypatch.context() as mp:
            mp.setattr(cuda_qp, "_at", dropped)
            xs = {prec: run_k(prec) for prec in cuda_qp.ITER_PRECISIONS}
        assert not chip_smoke.sharp_agrees("bf16x3", xs, px)[0]


def test_tolerance_gate_refuses_another_precision():
    """``chip_smoke.tolerance_agrees`` passes a kernel that solves as its
    plain version does and refuses one whose iterations are those of
    another precision (here "highest" against "bf16x3" on random QPs)."""
    tq = _random_set()
    cfg = dataclasses.replace(BASE, pallas_iter_precision="bf16x3",
                              rescue_max_iter=0)
    arrays, kw = _b1_args(tq, cfg)
    p = cuda_qp.admm_iterate(*arrays, **kw)
    assert chip_smoke.tolerance_agrees(p[5], p[4], p[5], p[4])[0]
    with _permuted_products(0):
        q = cuda_qp.admm_iterate(*arrays, **kw)
    assert chip_smoke.tolerance_agrees(q[5], q[4], p[5], p[4])[0]
    h = cuda_qp.admm_iterate(*arrays, **dict(kw, iter_precision="highest"))
    assert not chip_smoke.tolerance_agrees(h[5], h[4], p[5], p[4])[0]
