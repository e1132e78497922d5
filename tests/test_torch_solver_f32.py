"""The port's float32 QP solver held stage by stage against the JAX
reference on the main path's own FTOCPs (``ROADMAP.md`` C6).

Setup: the reference's float32 main path on the CPU (batch 8,
``SolverConfig.throughput()``, ``LMPCConfig(max_laps=12, max_pts=1024,
model_pts=512)``, seeded from its 450-step PID lap, plant noise on). At
steps 20, 40, ..., 140 its controller state is carried over to the port
(``convert.from_jax``) and the port's controller builds the step's QP
(``ctrl.build_qp``): 56 solves. On those QPs each stage of the port is held
against the reference's function on the same inputs:

- Ruiz scaling with the warm schedule (``_ruiz_equilibrate``): D, E, c and
  the scaled P and A, and the cached inverse carried to the new scaling
  (the warm start), within 1e-6 of the reference, relative to each array's
  largest entry;
- K (``_build_K``) within 1e-6, relative;
- the Newton-Schulz inverse (``_ns_inverse``) from the same K, warm start
  and gate: on every lane the true residual max|I - K X|, recomputed in
  float64, is at most the reference's. The port computes the final
  squaring's two products in float64 and rounds X once; the reference's
  float32 squaring leaves X at ~4.8e-4 on these FTOCPs, the port at ~1.1e-4
  (before that repair 5.5e-4, above the reference on 93% of the lanes).
  The returned residual keeps the reference's meaning: a bound on the true
  residual, and the factor cache's validity gate (< 50 ns_tol) is the
  reference's on every lane;
- the ADMM loop with a fixed inverse: B1's plain version
  (``cuda_qp.admm_iterate`` on CPU tensors) against the Pallas kernel in
  interpret mode: after one iteration both within 2e-3 (x) and 5e-3 (y)
  of a float64 transcription of the iteration and of each other (float32
  rounding alone moves x by < 8e-4 there; alpha 1.59 for 1.6, or a missing
  refinement step, moves the plain version's x or y past the bounds),
  after 16 within |dx| < 3e-2 (the bound ``examples/tpu_smoke.py`` sets
  for the kernel). At tolerance, B1's plain version takes at most the
  mean and the p99 iterations with the port's inverse that it takes with
  the reference's (before the repair 36.21 / 138 against 33.29 / 106).
  The Pallas kernel is not held at tolerance: in interpret mode on the
  CPU it runs these solves to max_iter where B1's plain version converges
  from the same inputs. Its exit test and iteration are the same, its x
  lies as near float64 as the plain version's, but its float32 products
  leave the duals of the equality rows (rho 100) farther from float64,
  and the dual residual follows them
  (``test_pallas_interpret_stall_is_rounding``);
- the whole solve on the plain path (``qp.solve`` against the reference's
  ``solve``, same warm start and factor cache): the port's mean iterations
  are at most 1.10x the reference's (C6 as found: 95.61 against 63.75).

The same run goes on to step 210, ~1 m before the finish line, where the
reference's own float32 controller and the port's solve of its QP run to
max_iter: float32's dual residual cannot certify the tolerance there, yet
the first input lies within 1e-2 of the QP's float64 solution (C6's open
part). On the QPs of steps 205, 210 and 215 no single class of B1's
products (the exit test's, Kinv.rhs with its refinement, the iteration's
A products), rounded once from float64, certifies the lanes that all of
them together do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from racinglmpc_tpu.controllers import lmpc as jlmpc
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.models.dynamics import PlantState, plant_step
from racinglmpc_tpu.ops import kkt_band as jkb
from racinglmpc_tpu.ops import pallas_qp
from racinglmpc_tpu.ops import qp as jqp
from racinglmpc_tpu.runtime import experiment as jexp
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch import convert
from racinglmpc_tpu_torch.controllers import lmpc as tlmpc
from racinglmpc_tpu_torch.models.track import make_track
from racinglmpc_tpu_torch.ops import cuda_qp
from racinglmpc_tpu_torch.ops import kkt_band as tkb
from racinglmpc_tpu_torch.ops import qp as tqp
from racinglmpc_tpu_torch.runtime import main_path, rescue_replay
from racinglmpc_tpu_torch.utils import config as tc

torch.set_num_threads(1)
B = 8
LKW = dict(max_laps=12, max_pts=1024, model_pts=512)
STEPS = range(20, 141, 20)
LATE = 210            # the finish line's regime (ROADMAP C6)
LATES = (205, LATE, 215)  # the steps whose QPs the product classes read
STAGE_REL = 1e-6      # Ruiz and K against the reference, relative
FIXED_DX = 3e-2       # B1 plain vs the Pallas kernel after 16 iterations
ONE_DX, ONE_DY = 2e-3, 5e-3   # after one iteration, to float64 and each other
U0_TOL = 1e-2         # a stalled solve's first input against the exact one
SOLVE_RATIO = 1.10    # plain-path mean iterations, port over reference
ARGS = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0", "z0",
        "y0")
JCFG = jc.SolverConfig.throughput()
TCFG = tc.SolverConfig.throughput()


def _reference():
    """The reference's main path at batch ``B``: (jitted batched step,
    jitted batched plant step, state seeded from its PID lap, plant)."""
    cfg = jexp.ExperimentConfig(stage_steps=450, solver=JCFG,
                                sim=jc.SimConfig(), lmpc=jc.LMPCConfig(**LKW))
    trk, vp = jtrack.make_track(), jc.VehicleParams()
    L = trk.total_len
    pid = jexp.run_experiment(jax.random.PRNGKey(0), cfg, batch=1,
                              stages="pid")
    lap = (pid.pid.x[0], pid.pid.u[0], pid.pid.x_glob[0], pid.pid.steps[0])

    def seed_one(_):
        st = jlmpc.init_lmpc_state(cfg.lmpc)
        for _ in range(cfg.lmpc.num_ss_it):
            st = jlmpc.lmpc_add_trajectory(st, cfg.lmpc, *lap, L)
        return st

    state = jax.jit(jax.vmap(seed_one))(jnp.arange(B))
    step = jax.jit(jax.vmap(jlmpc.make_lmpc(cfg.lmpc, trk, cfg.solver,
                                            cfg.sim.dt),
                            in_axes=(0, 0, None)))
    pstep = jax.jit(jax.vmap(lambda pl, u, k: plant_step(pl, u, vp, trk,
                                                         cfg.sim, k)))
    x0 = jnp.tile(jnp.asarray([0.5, 0, 0, 0, 0, 0], jnp.float32), (B, 1))
    return step, pstep, state, PlantState(x=x0, x_glob=x0)


@jax.jit
def _ref_ruiz(q, fac):
    """The reference solve's warm Ruiz schedule (``qp.py:_solve_impl``)."""
    def one(q, fac):
        n, m = q.P.shape[0], q.A.shape[0]
        dt = q.P.dtype
        refresh = ~fac.valid | (fac.age % JCFG.scaling_refresh_every == 0)
        use_warm = fac.valid & ~refresh
        init = (jnp.where(use_warm, fac.D, jnp.ones(n, dt)),
                jnp.where(use_warm, fac.E, jnp.ones(m, dt)),
                jnp.where(use_warm, fac.c, jnp.asarray(1.0, dt)))
        sweeps = jnp.where(refresh, JCFG.scaling_iters,
                           min(JCFG.scaling_warm_iters, JCFG.scaling_iters))
        return jqp._ruiz_equilibrate(q, sweeps, init=init)
    return jax.vmap(one)(q, fac)


_ref_build_k = jax.jit(jax.vmap(lambda q, rho: jqp._build_K(q, rho,
                                                             JCFG.sigma)))
_ref_ns = jax.jit(jax.vmap(lambda K, X0, ok: jqp._ns_inverse(
    K, X0, ok, 1e-3, JCFG.ns_max_iters)))
_ref_solve = jax.jit(jax.vmap(lambda q, wx, wy, fac: jqp.solve(
    q, JCFG, warm=(wx, wy), fac=fac,
    structure=jkb.band_structure(14, 48))))


def _j(t):
    return jnp.asarray(t.numpy())


def _true_residual(K, X):
    """max|I - K X| per lane, in float64."""
    K, X = K.double(), X.double()
    eye = torch.eye(K.shape[-1], dtype=torch.float64)
    return (eye - K @ X).abs().amax((1, 2)).numpy()


def _rel(a, b):
    """max |a - b| over the largest |b|, per lane."""
    a = np.asarray(a, np.float64).reshape(B, -1)
    b = np.asarray(b, np.float64).reshape(B, -1)
    return np.abs(a - b).max(1) / np.maximum(np.abs(b).max(1), 1e-30)


def _sample(st, plant, ctrl):
    """One sampled step: the port's QP from the reference's state, and
    each stage of both packages on it."""
    ts = convert.from_jax(tlmpc.LMPCState,
                          jax.tree_util.tree_map(np.asarray, st._asdict()),
                          device="cpu")
    q, *_ = ctrl.build_qp(ts, torch.from_numpy(np.array(plant.x)))
    jq = jqp.QPData(*(_j(a) for a in q))
    warm = (ts.warm_x, ts.warm_y)
    pro = tqp._prologue(q, TCFG, warm, ts.fac)
    r_qs, r_D, r_E, r_c = _ref_ruiz(jq, st.fac)
    K = tqp._build_K(pro.qp_s, pro.rho0, TCFG.sigma)
    r_K = _ref_build_k(jqp.QPData(*(_j(a) for a in pro.qp_s)), _j(pro.rho0))
    X, res = tqp._ns_inverse(K, pro.kinv0, pro.warm_ok, pro.ns_tol,
                             TCFG.ns_max_iters)
    r_X, r_res = _ref_ns(_j(K), _j(pro.kinv0), _j(pro.warm_ok))
    r_X = torch.from_numpy(np.array(r_X))
    kw = tqp.kernel_args(pro, X, TCFG)
    args = [kw.pop(k) for k in ARGS]
    r_args = list(args)
    r_args[1] = r_X
    # the warm start's transform to the new scaling (reference ``qp.py``,
    # ``kinv0 = fac.kinv * ratio ratio'``, ratio = fac.D / D)
    ratio = st.fac.D / jnp.where(r_D > 0, r_D, 1.0)
    r_kinv0 = st.fac.kinv * ratio[:, :, None] * ratio[:, None, :]
    return dict(
        ruiz=np.max([_rel(pro.D, r_D), _rel(pro.E, r_E), _rel(pro.c, r_c),
                     _rel(pro.qp_s.P, r_qs.P), _rel(pro.qp_s.A, r_qs.A),
                     _rel(pro.kinv0, r_kinv0)], 0),
        K=_rel(K, r_K), dtype=X.dtype,
        true=_true_residual(K, X), r_true=_true_residual(K, r_X),
        res=res.numpy(), r_res=np.asarray(r_res),
        b1=cuda_qp.admm_iterate(*args, **kw)[4].numpy(),
        r_b1=cuda_qp.admm_iterate(*r_args, **kw)[4].numpy(),
        args=args, kw=kw,
        solve=tqp.solve(q, TCFG, warm=warm, fac=ts.fac,
                        structure=tkb.band_structure(14, 48)).iters.numpy(),
        r_solve=np.asarray(_ref_solve(jq, st.warm_x, st.warm_y,
                                      st.fac).iters))


def _run(steps, lates=()):
    """The reference's main path: a :func:`_sample` at each of ``steps``;
    for each step ``late`` of ``lates``, also the reference's own solve of
    step ``late - 1`` (iterations, feasible flags) and its state and plant
    state at step ``late``, from which the port builds that step's QP."""
    step, pstep, st, plant = _reference()
    cfg = main_path.config()
    ctrl = tlmpc.make_lmpc(cfg.lmpc, make_track(device="cpu"), cfg.solver,
                           cfg.sim.dt)
    key = jax.random.PRNGKey(0)
    out, late = [], {}
    for t in range(max((*steps, *lates)) + 1):
        if t in lates:
            late[t] = dict(
                iters=np.asarray(st.iters), feasible=np.asarray(st.feasible),
                state=jax.tree_util.tree_map(np.asarray, st._asdict()),
                x0=torch.from_numpy(np.array(plant.x)))
        if t in steps:
            out.append(_sample(st, plant, ctrl))
        st, u = step(st, plant.x, None)
        plant = pstep(plant, u, jax.random.split(jax.random.fold_in(key, t),
                                                 B))
    return out, late


@pytest.fixture(scope="module")
def run():
    return _run(STEPS, LATES)


@pytest.fixture(scope="module")
def samples(run):
    return run[0]


def _cat(samples, name):
    return np.concatenate([s[name] for s in samples])


def test_ruiz_scaling_and_K_match_reference(samples):
    ruiz, K = _cat(samples, "ruiz"), _cat(samples, "K")
    assert ruiz.max() <= STAGE_REL, ruiz.max()
    assert K.max() <= STAGE_REL, K.max()


def test_ns_inverse_true_residual_at_most_reference(samples):
    assert all(s["dtype"] == torch.float32 for s in samples)
    true, r_true = _cat(samples, "true"), _cat(samples, "r_true")
    assert true.size == len(STEPS) * B
    assert (true <= r_true).all(), (true.mean(), r_true.mean(),
                                    np.flatnonzero(true > r_true))


def test_ns_inverse_returned_residual_keeps_reference_gates(samples):
    res, r_res = _cat(samples, "res"), _cat(samples, "r_res")
    tol = 50 * 1e-3
    assert np.isfinite(res).all()
    # the returned residual bounds the true one, as the reference's does
    assert (res >= _cat(samples, "true")).all()
    assert (r_res >= _cat(samples, "r_true")).all()
    # and the factor cache's validity gate decides as the reference's
    np.testing.assert_array_equal(res < tol, r_res < tol)


def _fixed(kw, iters):
    """``kw`` (:func:`tqp.kernel_args` less the matrices) at ``iters``
    fixed iterations, no exit test, no rescue."""
    return dict(kw, eps_abs=0.0, eps_rel=0.0, max_iter=iters,
                check_every=iters, rescue_max_iter=0)


def _pallas(args, kw):
    kw = dict(kw)
    kw.pop("ns_tol"), kw.pop("ns_max_iters")
    return jax.vmap(lambda *a: pallas_qp.admm_iterate(*a, interpret=True,
                                                      **kw))(
        *(_j(a) for a in args))


def _iterate64(args, kw, iters):
    """The kernels' ADMM iteration transcribed in float64 on the same
    inputs (float32 ``rho_inv``, as both kernels take it): (x, y)."""
    P, Kinv, A, q, l, u, rho = (a.double() for a in args[:7])
    x, z, y = (a.double() for a in args[10:13])
    rho_inv = (1.0 / args[6]).double()
    sigma, alpha = kw["sigma"], kw["alpha"]

    def vm(v, M):
        return (v[:, None] @ M)[:, 0]

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    for _ in range(iters):
        rhs = sigma * x - q + vm(rho * z - y, A)
        xt = vm(rhs, Kinv)
        for _ in range(kw["refine_steps"]):
            r = rhs - (vm(xt, P) + sigma * xt + vm(rho * mv(A, xt), A))
            xt = xt + vm(r, Kinv)
        zt = mv(A, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        z_rel = alpha * zt + (1.0 - alpha) * z
        z = torch.maximum(torch.minimum(z_rel + y * rho_inv, u), l)
        y = y + rho * (z_rel - z)
        x = x_new
    return x, y


def _dist(a, b):
    return float(np.abs(np.array(a, np.float64)
                        - np.array(b, np.float64)).max())


def _one_iteration(samples):
    """Max over the samples, after one fixed iteration, of |x| and |y|
    distances: B1's plain version and the Pallas kernel to the float64
    transcription, and to each other."""
    d = dict(x_b1=0.0, x_pallas=0.0, x_apart=0.0, y_b1=0.0, y_pallas=0.0,
             y_apart=0.0)
    for s in samples:
        one = _fixed(s["kw"], 1)
        out = cuda_qp.admm_iterate(*s["args"], **one)
        ref = _pallas(s["args"], one)
        x64, y64 = _iterate64(s["args"], one, 1)
        for k, (a, b) in dict(
                x_b1=(out[0], x64), x_pallas=(ref[0], x64),
                x_apart=(out[0], ref[0]), y_b1=(out[1], y64),
                y_pallas=(ref[1], y64), y_apart=(out[1], ref[1])).items():
            d[k] = max(d[k], _dist(a, b))
    return d


def test_b1_plain_matches_pallas_fixed_iterations_on_main_path(samples):
    # one iteration, before the iteration amplifies rounding: both kernels
    # within ONE_DX / ONE_DY of the float64 transcription and of each other
    # (alpha 1.59 for 1.6 fails this)
    d = _one_iteration(samples)
    assert max(d["x_b1"], d["x_pallas"], d["x_apart"]) < ONE_DX, d
    assert max(d["y_b1"], d["y_pallas"], d["y_apart"]) < ONE_DY, d
    # 16 iterations: the bound examples/tpu_smoke.py sets for the kernel
    for s in samples[::3]:
        fixed = _fixed(s["kw"], 16)
        out = cuda_qp.admm_iterate(*s["args"], **fixed)
        ref = _pallas(s["args"], fixed)
        dx = np.abs(out[0].numpy() - np.asarray(ref[0])).max()
        assert dx < FIXED_DX, dx
        np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))


def _interpret_stall(s):
    """On one sample after 64 fixed iterations: the Pallas kernel's own
    residuals and those recomputed from its (x, y) in float64; x's
    distance to the float64 transcription (B1's plain version, the
    kernel); the equality rows' y distance (the same two); the median
    dual residual (the same two)."""
    f = _fixed(s["kw"], 64)
    out = cuda_qp.admm_iterate(*s["args"], **f)
    ref = _pallas(s["args"], f)
    x64, y64 = _iterate64(s["args"], f, 64)
    eq = (s["args"][4] == s["args"][5]).numpy()
    return dict(
        own=(np.asarray(ref[2]), np.asarray(ref[3])),
        recomputed=_residuals64(s["args"], ref[0], ref[1]),
        dx=(_dist(out[0], x64), _dist(ref[0], x64)),
        dy_eq=tuple(float(np.abs(np.asarray(y, np.float64)
                                 - y64.numpy())[eq].max())
                    for y in (out[1], ref[1])),
        dua=(float(np.median(out[3].numpy())),
             float(np.median(np.asarray(ref[3])))))


def test_pallas_interpret_stall_is_rounding(samples):
    """In interpret mode on the CPU the Pallas kernel stalls at tolerance
    on these FTOCPs where B1's plain version converges. Same exit test and
    same iteration: after 64 iterations its residuals recomputed from its
    (x, y) by the plain version's formula are its own, and its x lies no
    farther from the float64 transcription than twice the plain version's;
    its y on the equality rows (rho 100) lies farther, and its dual
    residual, ~100 y's error through D/c, with it."""
    d = _interpret_stall(samples[2])
    np.testing.assert_allclose(d["own"][0], d["recomputed"][0], rtol=1e-3)
    np.testing.assert_allclose(d["own"][1], d["recomputed"][1], rtol=1e-3)
    assert d["dx"][1] <= 2 * d["dx"][0], d["dx"]
    assert d["dy_eq"][1] > d["dy_eq"][0], d["dy_eq"]
    assert d["dua"][1] > d["dua"][0], d["dua"]


def _residuals64(args, x, y):
    """The exit test's (pri, dua) per lane, recomputed in float64."""
    P, _, A, q, l, u, rho, D, E, c = (a.double() for a in args[:10])
    x = torch.from_numpy(np.array(x, np.float64))
    y = torch.from_numpy(np.array(y, np.float64))
    Ax = (A @ x[..., None])[..., 0]
    zc = torch.maximum(torch.minimum(Ax, u), l)
    r = (P @ x[..., None])[..., 0] + q + (y[:, None] @ A)[:, 0]
    return (((Ax - zc) / E).abs().amax(-1).numpy(),
            ((r * D).abs().amax(-1) / c.reshape(-1)).numpy())


def test_b1_iterations_with_port_inverse_at_most_reference_inverse(samples):
    it, r_it = _cat(samples, "b1"), _cat(samples, "r_b1")
    assert it.mean() <= r_it.mean(), (it.mean(), r_it.mean())
    assert np.percentile(it, 99) <= np.percentile(r_it, 99), (
        np.percentile(it, 99), np.percentile(r_it, 99))


def test_plain_path_solve_iterations_within_reference(samples):
    it, r_it = _cat(samples, "solve"), _cat(samples, "r_solve")
    assert it.mean() <= SOLVE_RATIO * r_it.mean(), (it.mean(), r_it.mean())


def _finish_line(late):
    """At step ``LATE``: the reference's own iterations and feasible flags;
    on the port's QP from its state, the solve's iterations, the lanes
    B1's plain version brings to tolerance with float32 products and with
    each product rounded once from float64, the largest |u_0 - u_0*|
    against the QP's float64 solution at a tight tolerance (1e-7), and
    that solution's largest primal residual."""
    ctrl = tlmpc.make_lmpc(main_path.config().lmpc, make_track(device="cpu"),
                           TCFG, 0.1)
    ts = convert.from_jax(tlmpc.LMPCState, late["state"], device="cpu")
    qp = ctrl.build_qp(ts, late["x0"])[0]
    warm, band = (ts.warm_x, ts.warm_y), tkb.band_structure(14, 48)
    got = tqp.solve(qp, TCFG, warm=warm, fac=ts.fac, structure=band)
    args, kw = rescue_replay.admm_args(qp, TCFG, warm, ts.fac)
    plain = cuda_qp.admm_iterate_plain(*args, **kw)
    with chip_smoke.float64_products(cuda_qp):
        once = cuda_qp.admm_iterate_plain(*args, **kw)
    tight = dataclasses.replace(TCFG, use_pallas=False, eps_abs=1e-7,
                                eps_rel=1e-7, max_iter=5000, check_every=25)
    exact = tqp.solve(tqp.QPData(*(a.double() for a in qp)), tight,
                      structure=band)
    o, d = ctrl.dims.off_u, ctrl.dims.d
    return dict(
        ref_iters=late["iters"], ref_feasible=late["feasible"],
        iters=got.iters.numpy(), solved32=int(plain[5].sum()),
        solved_once=int(once[5].sum()),
        u0_off=float((got.x[:, o:o + d].double()
                      - exact.x[:, o:o + d]).abs().max()),
        exact_pri=float(exact.pri_res.max()))


def test_finish_line_stall_is_float32s_certificate(run):
    """ROADMAP C6's open part: ~1 m before the finish line (step 210) the
    reference's own float32 controller runs its solves to max_iter and
    leaves them off tolerance, and the port's solve of its QP from the
    same state does the same. The float32 dual residual cannot certify
    the tolerance there (with products rounded once from float64 more
    lanes do), but the solutions are good: every lane's first input lies
    within U0_TOL of the QP's float64 solution at a tight tolerance."""
    d = _finish_line(run[1][LATE])
    assert (d["ref_iters"] >= TCFG.max_iter).sum() >= B - 1, d
    assert (~d["ref_feasible"]).sum() >= B - 1, d
    assert (d["iters"] >= TCFG.max_iter).sum() >= B - 1, d
    assert d["solved_once"] > d["solved32"], d
    assert d["exact_pri"] < 1e-6 and d["u0_off"] < U0_TOL, d


def _class_counts(late):
    """Lanes B1's plain version brings to tolerance on the port's QPs of
    the steps ``LATES``, summed over them, by
    :func:`chip_smoke.product_classes`: float32 products, each class of
    ``cuda_qp.PRODUCTS`` alone rounded once from float64, the exit test
    wholly in float64, and every class rounded once."""
    ctrl = tlmpc.make_lmpc(main_path.config().lmpc, make_track(device="cpu"),
                           TCFG, 0.1)
    counts = {}
    for t in LATES:
        ts = convert.from_jax(tlmpc.LMPCState, late[t]["state"],
                              device="cpu")
        qp = ctrl.build_qp(ts, late[t]["x0"])[0]
        args, kw = rescue_replay.admm_args(qp, TCFG, (ts.warm_x, ts.warm_y),
                                           ts.fac)
        for k, o in chip_smoke.product_classes(cuda_qp, args, kw).items():
            counts[k] = counts.get(k, 0) + int(o[5].sum())
    return counts


def test_finish_line_floor_is_no_single_product_class(run):
    """ROADMAP C6, step 1: which products' rounding sets the finish line's
    floor. On the QPs of steps 205, 210 and 215 (24 lanes) float32 brings
    no lane to tolerance and every class rounded once from float64
    brings 9 (CPU, one thread). The exit test's products change no
    iterate: rounded once, or the whole test in float64 (float64
    accumulators for its three products and four maxima), they certify
    no lane that float32 does not; Kinv.rhs with its refinement ("solve")
    certifies 2, the iteration's A x and A'(rho z - y) ("iterate") none.
    No class carries the count, so no single class is repaired (the
    floor is the float32 iterates' own). Held: the exit test's classes
    within one lane of float32, every single class below half of what all
    classes together add to float32, which adds at least 4."""
    c = _class_counts(run[1])
    gain = {k: v - c["float32"] for k, v in c.items()}
    assert gain["all"] >= 4, c
    assert abs(gain["check"]) <= 1 and abs(gain["check64"]) <= 1, c
    assert all(gain[k] < gain["all"] / 2
               for k in (*cuda_qp.PRODUCT_CLASSES, "check64")), c


def _print_stages(samples, late):
    def dist(name):
        v = _cat(samples, name)
        return (f"mean {v.mean():.4g} p90 {np.percentile(v, 90):.4g} p99 "
                f"{np.percentile(v, 99):.4g}")

    true, r_true = _cat(samples, "true"), _cat(samples, "r_true")
    print(f"{true.size} solves; Ruiz max rel {_cat(samples, 'ruiz').max():.2e}"
          f", K max rel {_cat(samples, 'K').max():.2e}")
    print(f"float64 true residual: port {dist('true')}; reference "
          f"{dist('r_true')}; port above the reference on "
          f"{100 * (true > r_true).mean():.0f}% of lanes")
    print(f"B1 plain iterations: port inverse {dist('b1')}; reference "
          f"inverse {dist('r_b1')}")
    print(f"plain path, whole solve: port {dist('solve')}; reference "
          f"{dist('r_solve')}")
    print(f"one iteration: {_one_iteration(samples)}")
    print(f"interpret mode, 64 iterations, step {STEPS[2]}: "
          f"{_interpret_stall(samples[2])}")
    print(f"step {LATE}: {_finish_line(late[LATE])}")
    print(f"product classes, steps {LATES}: {_class_counts(late)}")


if __name__ == "__main__":
    # The numbers the tests hold, by hand from the repository root (in a
    # parent checkout, the numbers before a change):
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_solver_f32.py
    _print_stages(*_run(STEPS, LATES))
