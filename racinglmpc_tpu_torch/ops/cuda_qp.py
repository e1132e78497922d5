"""Kernel B1: the ADMM iteration loop with the rho-escalation rescue.

Replaces ``racinglmpc_tpu/ops/pallas_qp.py::_kernel`` + ``_admm_core``
(through ``admm_iterate``). Per scenario, on the Ruiz-scaled QP with fixed
rho: an entry residual check (iters = 0 when already at tolerance), then
chunks of ``check_every`` iterations of

    x-update  xt = rhs·Kinv + ``refine_steps`` refinement rounds against the
              exact operator P + sigma I + A' rho A (three terms, never a
              formed K), alpha-relaxation, z clipped to [l, u], y update

with unscaled primal/dual checks after each chunk, exactly ``max_iter``
iterations counted. Where the primal residual ends above
``rescue_trigger``, the rescue scales rho, rebuilds
K2 = P + sigma I + A' (s rho) A, inverts it by Newton-Schulz (warm from
Kinv / s when the Frobenius residual of the 128-padded system is < 0.9,
else Jacobi; restart pass when bad) and runs up to ``rescue_max_iter``
more iterations with a primal-only exit.

The CUDA version (``csrc/cuda_qp.cu``) is two launches: the main loop, one
CTA per scenario (per-scenario early exit), then the rescue, one CTA per
scenario that returns at once unless its scenario needs the rescue: a
prologue launch builds K2 and its Newton-Schulz inverse on B4's product
core (the whole n x n output in registers, 8 x 8 outputs a thread), with
the matrices in a global-memory workspace, then an iteration launch runs
the rescue's chunks.

Both launches run the ADMM core in one of two layouts (:func:`smem_plan`,
:func:`choose_layout`). **Resident**: each CTA copies its Kinv into shared
memory and compresses the nonzeros of A (CSR and CSC) and P (CSC) beside
it, reading each matrix once; the loop then reads only shared memory, and
every product sums in the streaming core's order, so both layouts give
the same bits.
**Stream**: the core reads dense P, Kinv and A from global memory in every
product; it runs where Kinv does not fit beside the vectors, where forced
(``layout="stream"``, for checks), and, inside a resident launch, for a
scenario whose nonzeros exceed the plan's cap (:func:`streams` predicts
which). Every streamed scenario is flagged by the kernel and counted in
:data:`streamed`; :data:`layout_launches` counts the launches per layout.

Padding: the Pallas kernel pads n to a multiple of 128 with an identity
pad block in K2 and a zero pad block in the warm start. That block never
changes the ADMM iterates, but it is part of the rescue's Newton-Schulz
gates: the warm test sees its sqrt(n_pad) Frobenius share (so with
n_pad > 0 the warm start is never taken) and the loop's max|R| sees the
pad block's own scalar Newton-Schulz sequence. Both versions here carry
that scalar instead of the padded block.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from racinglmpc_tpu_torch.ops import cuda_build
from racinglmpc_tpu_torch.utils.batched import lane_where as _w
from racinglmpc_tpu_torch.utils.batched import mv as _mv
from racinglmpc_tpu_torch.utils.batched import vm as _vm

_BIG = 1e30
_LANE = 128
launches = cuda_build.LaunchCounter("admm")
layout_launches = {"resident": cuda_build.LaunchCounter("admm_resident"),
                   "stream": cuda_build.LaunchCounter("admm_stream")}
streamed = cuda_build.ScenarioCounter("admm_streamed")
LAYOUTS = ("resident", "stream")

# shared memory of one H100 SM and the most one CTA may take (bytes), the
# runtime's reservation per CTA, and the kernels' constants (qp_common.cuh)
SMEM_PER_SM = cuda_build.SMEM_PER_SM
SMEM_PER_CTA = cuda_build.SMEM_PER_CTA
SMEM_RESERVED = cuda_build.SMEM_RESERVED
_NT, _PK = 512, 16
# the least nonzero share of A and P a plan's cap must hold: the main
# path's FTOCPs hold 1.1%, the MPC stages' 2.0% (LTI)
MIN_DENSITY = 0.02


def _r4(k: int) -> int:
    return -(-k // 4) * 4


def _r16(b: int) -> int:
    return -(-b // 16) * 16


def ctx_floats(n: int, m: int) -> int:
    """Floats of a CTA's vector context (qp_common.cuh:ctx_floats)."""
    return 7 * _r4(n) + 8 * _r4(m) + _NT + 4 * (_NT // 32)


class Geo(NamedTuple):
    """The Newton-Schulz product core at n (qp_common.cuh:geo; B4 and the
    rescue): 8 x 8 output cells, one per thread."""
    cells: int    # column cells, ceil(n / 8)
    cr: int       # row cells of a pass
    passes: int   # passes over the rows (one up to n = 168)
    sa: int       # row stride of a staged slab of the left operand


def geo(n: int) -> Geo:
    cells = -(-n // 8)
    per = (_NT - 32) // cells     # at least one producer warp
    passes = -(-cells // per)
    cr = -(-cells // passes)
    return Geo(cells, cr, passes, 8 * cr + (36 - (8 * cr) % 32) % 32)


def prologue_floats(n: int) -> int:
    """Floats of the Newton-Schulz prologue's shared memory
    (qp_common.cuh:prologue_floats): the product core's two slab buffers
    (left operand, then right) and the Jacobi diagonal."""
    g = geo(n)
    return 2 * _PK * (g.sa + 8 * g.cells) + _r4(n)


def slot_floats(n: int) -> int:
    """Floats of the resident layout's Kinv slot (qp_common.cuh:slot_floats):
    n^2 + 4."""
    return _r4(n * n + 4)


def smem_plan(n: int, m: int, nnz_cap: int) -> Tuple[int, int]:
    """(bytes, CTAs per SM) of the resident layout for an n-variable,
    m-constraint QP whose A and P together hold at most ``nnz_cap``
    nonzeros (qp_common.cuh:resident_layout): an 80-byte header (the
    mbarrier and the list of A's long rows), the context, the Kinv slot
    (:func:`slot_floats`), then 14 bytes per
    nonzero (pool and CSC values, pool rows and columns, CSC rows) and the
    int16 row / column pointers. CTAs per SM counts shared memory alone
    (0: it does not fit one CTA); the kernel's registers (over 64 per
    thread) hold the card to one CTA of 512 threads per SM
    (:func:`ctas_per_sm_on_card`)."""
    slot = slot_floats(n)
    sparse = 14 * nnz_cap + 2 * (m + 1 + 2 * (n + 1))
    nbytes = 80 + 4 * ctx_floats(n, m) + 4 * slot + _r16(sparse)
    if nbytes > SMEM_PER_CTA:
        return nbytes, 0
    return nbytes, min(SMEM_PER_SM // (nbytes + SMEM_RESERVED), 2048 // _NT)


class Layout(NamedTuple):
    name: str          # "resident" or "stream"
    nbytes: int        # dynamic shared memory of the main launch
    ctas_per_sm: int   # by shared memory
    nnz_cap: int       # nonzeros of A and P a resident CTA holds (0: stream)


def _stream_layout(n: int, m: int) -> Layout:
    return Layout("stream", 4 * ctx_floats(n, m), 0, 0)


def choose_layout(n: int, m: int) -> Layout:
    """The resident layout at the most CTAs per SM (2, else 1) whose cap,
    the most nonzeros that fit beside Kinv and the vectors (and no more
    than A and P have entries), holds at least ``MIN_DENSITY`` of A's and
    P's entries; else the streaming layout."""
    dense = m * n + n * n
    floor = math.ceil(MIN_DENSITY * dense)
    for ctas in (2, 1):
        budget = min(SMEM_PER_CTA, SMEM_PER_SM // ctas - SMEM_RESERVED)
        base = smem_plan(n, m, 0)[0]
        cap = min(max((budget - base) // 14, 0), dense, 32_767)
        while cap > 0 and smem_plan(n, m, cap)[0] > budget:
            cap -= 1
        if cap >= floor and smem_plan(n, m, cap)[1] >= ctas:
            nbytes, per_sm = smem_plan(n, m, cap)
            return Layout("resident", nbytes, per_sm, cap)
    return _stream_layout(n, m)


def streams(P, A, nnz_cap: int) -> torch.Tensor:
    """(B,) bool: the scenarios a resident launch with ``nnz_cap`` runs in
    the streaming layout (their A and P hold more nonzeros)."""
    return ((A != 0).sum((1, 2)) + (P != 0).sum((1, 2))) > nnz_cap


def _n_pad(n: int) -> int:
    return -(-n // _LANE) * _LANE - n


class _Vec(NamedTuple):
    """The per-scenario vectors of one solve (float32)."""

    q: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    rho: torch.Tensor
    rho_inv: torch.Tensor
    D: torch.Tensor
    E_inv: torch.Tensor
    c_inv: torch.Tensor


def _vec(q, l, u, rho, D, E, c) -> _Vec:
    f = torch.float32
    rho = rho.to(f)
    return _Vec(q.to(f), torch.clamp(l.to(f), -_BIG, _BIG),
                torch.clamp(u.to(f), -_BIG, _BIG), rho, 1.0 / rho, D.to(f),
                1.0 / E.to(f), 1.0 / c.to(f))


def admm_iterate_plain(P, Kinv, A, q, l, u, rho, D, E, c, x0, z0, y0, *,
                       sigma: float, alpha: float, eps_abs: float,
                       eps_rel: float, max_iter: int, check_every: int,
                       refine_steps: int, rescue_max_iter: int = 0,
                       rescue_rho_scale: float = 5.0,
                       rescue_trigger: float = 7.5e-3,
                       rescue_exit: float = 1e-3, ns_tol: float = 1e-3,
                       ns_max_iters: int = 40, kinv_pad=None):
    """Plain PyTorch version of the kernel on the same batched inputs.
    ``kinv_pad`` (B,): the scalar of Kinv's 128-pad block (B4's refreshed
    inverse); None for B1, whose padded Kinv has a zero pad block.

    Returns (x (B, n), y (B, m), pri, dua, iters (int32), solved, rescued)
    in scaled coordinates."""
    f = torch.float32
    P, Kinv, A = P.to(f), Kinv.to(f), A.to(f)
    v = _vec(q, l, u, rho, D, E, c)
    x, z, y = x0.to(f), z0.to(f), y0.to(f)
    one_m_alpha = 1.0 - alpha

    def one_iter(v, P, A, Kinv, x, z, y):
        rhs = sigma * x - v.q + _vm(v.rho * z - y, A)
        xt = _vm(rhs, Kinv)
        for _ in range(refine_steps):
            r = rhs - (_vm(xt, P) + sigma * xt + _vm(v.rho * _mv(A, xt), A))
            xt = xt + _vm(r, Kinv)
        zt = _mv(A, xt)
        x_new = alpha * xt + one_m_alpha * x
        z_rel = alpha * zt + one_m_alpha * z
        z_new = torch.clamp(z_rel + y * v.rho_inv, v.l, v.u)
        y_new = y + v.rho * (z_rel - z_new)
        return x_new, z_new, y_new

    def residuals(v, P, A, x, y):
        Ax = _mv(A, x)
        zc = torch.clamp(Ax, v.l, v.u)
        pri = ((Ax - zc) * v.E_inv).abs().amax(-1)
        Px = _vm(x, P)
        Aty = _vm(y, A)
        dua = ((Px + v.q + Aty) * v.D).abs().amax(-1) * v.c_inv
        pri_sc = torch.maximum((Ax * v.E_inv).abs().amax(-1),
                               (zc * v.E_inv).abs().amax(-1))
        dua_sc = torch.maximum(
            torch.maximum((Px * v.D).abs().amax(-1),
                          (Aty * v.D).abs().amax(-1)),
            (v.q * v.D).abs().amax(-1)) * v.c_inv
        ok = ((pri < eps_abs + eps_rel * pri_sc)
              & (dua < eps_abs + eps_rel * dua_sc))
        return pri, dua, ok

    def chunks(v, P, A, Kinv, x, z, y, pri, dua, done, iters, it_base,
               budget, exit_pri):
        """Check-every chunks while any lane is active; exactly ``budget``
        iterations counted; newly converged lanes get it_base + used."""
        for k in range(max(-(-budget // check_every), 1)):
            active = ~done
            if not bool(active.any()):
                break
            for _ in range(min(check_every, budget - k * check_every)):
                xn, zn, yn = one_iter(v, P, A, Kinv, x, z, y)
                x, z, y = _w(active, xn, x), _w(active, zn, z), _w(active, yn, y)
            p, d, ok = residuals(v, P, A, x, y)
            if exit_pri is not None:
                ok = ok | (p < exit_pri)
            pri = torch.where(active, p, pri)
            dua = torch.where(active, d, dua)
            newly = ok & active
            used = min((k + 1) * check_every, budget)
            iters = torch.where(newly, it_base + used, iters)
            done = done | newly
        return x, z, y, pri, dua, done, iters

    pri, dua, ok0 = residuals(v, P, A, x, y)
    iters = torch.where(ok0, 0, max_iter).to(torch.int32)
    x, z, y, pri, dua, done, iters = chunks(
        v, P, A, Kinv, x, z, y, pri, dua, ok0, iters, 0, max_iter, None)
    need = pri > rescue_trigger if rescue_max_iter > 0 else torch.zeros_like(done)
    idx = need.nonzero()[:, 0]
    if idx.numel() == 0:
        return x, y, pri, dua, iters, done, need

    s = rescue_rho_scale
    vs = _Vec(*(t[idx] for t in v))
    Ps, As = P[idx], A[idx]
    kp = (torch.zeros_like(vs.c_inv) if kinv_pad is None
          else kinv_pad[idx].to(f))
    K2inv = _rescue_kinv(Ps, As, Kinv[idx], kp, vs.rho, sigma, s, ns_tol,
                         ns_max_iters)
    vs = vs._replace(rho=vs.rho * s, rho_inv=vs.rho_inv / s)
    it_main = torch.clamp(iters[idx], max=max_iter)
    xs, _, ys, ps, ds, _, its = chunks(
        vs, Ps, As, K2inv, x[idx], z[idx], y[idx], pri[idx], dua[idx],
        torch.zeros_like(idx, dtype=torch.bool), it_main + rescue_max_iter,
        it_main, rescue_max_iter, rescue_exit)
    x, y, pri, dua, iters = (t.clone() for t in (x, y, pri, dua, iters))
    x[idx], y[idx], pri[idx], dua[idx], iters[idx] = xs, ys, ps, ds, its
    done = done | (need & (pri < rescue_exit))
    return x, y, pri, dua, iters, done, need


def _rescue_kinv(P, A, Kinv, kinv_pad, rho, sigma: float, s: float,
                 ns_tol: float, ns_max_iters: int):
    """The rescue's K2 = P + sigma I + A'(s rho)A and its two-pass
    Newton-Schulz inverse, with the 128-pad block carried as a scalar
    (``kinv_pad``: the pad scalar of the incoming Kinv)."""
    Bsz, n, _ = P.shape
    dt, dev = P.dtype, P.device
    n_pad = _n_pad(n)
    eye = torch.eye(n, dtype=dt, device=dev)
    Arho = A * rho[:, :, None]
    K2 = (A.transpose(1, 2) @ Arho) * s + P + sigma * eye
    dg = 1.0 / torch.clamp(torch.diagonal(K2, dim1=1, dim2=2), min=1e-12)
    Rj = eye - K2 * dg[:, None, :]
    cj = torch.sqrt((Rj * Rj).sum((1, 2)))
    cjm = torch.clamp(cj, min=1.0)
    Xj = (eye * dg[:, None, :]) / cjm[:, None, None]
    xj_pad = 1.0 / cjm
    # warm test on Kinv / s: the pad block adds n_pad (1 - kp/s)^2 to the
    # squared Frobenius residual (>= 1 for B1's zero pad block, so the
    # padded test never passes there)
    pad_sq = (n_pad * (1.0 - kinv_pad / s) ** 2 if n_pad
              else torch.zeros_like(kinv_pad))
    try_warm = pad_sq < 0.81
    use_warm = torch.zeros_like(try_warm)
    if bool(try_warm.any()):
        X0r = Kinv / s
        R0 = eye - K2 @ X0r
        r0f = torch.sqrt((R0 * R0).sum((1, 2)) + pad_sq)
        use_warm = try_warm & torch.isfinite(r0f) & (r0f < 0.9)
        Xi = _w(use_warm, X0r, Xj)
    else:
        Xi = Xj
    xp_i = torch.where(use_warm, kinv_pad / s, xj_pad)

    def ns_run(X, xp):
        X, xp = X.clone(), xp.clone()
        r = torch.full((Bsz,), math.inf, dtype=dt, device=dev)
        it = torch.zeros((Bsz,), dtype=torch.int32, device=dev)
        while True:
            act = (r > ns_tol) & (it < ns_max_iters)
            if not bool(act.any()):
                return X, r, xp
            R = eye - K2 @ X
            rmax = R.abs().amax((1, 2))
            if n_pad:
                rmax = torch.maximum(rmax, (1.0 - xp).abs())
            Xn = X + X @ R
            X = _w(act, Xn, X)
            r = torch.where(act, rmax, r)
            xp = torch.where(act, xp + xp * (1.0 - xp), xp)
            it = it + act.to(torch.int32)

    X1, r1, xp1 = ns_run(Xi, xp_i)
    bad = ~torch.isfinite(r1) | (r1 > 50 * ns_tol)
    X2, _, _ = ns_run(_w(bad, Xj, X1), torch.where(bad, xj_pad, xp1))
    return X2


class _Params(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int), ("m", ctypes.c_int), ("max_iter", ctypes.c_int),
        ("check_every", ctypes.c_int), ("refine_steps", ctypes.c_int),
        ("rescue_max_iter", ctypes.c_int), ("ns_max_iters", ctypes.c_int),
        ("n_pad", ctypes.c_int), ("nnz_cap", ctypes.c_int),
        ("sigma", ctypes.c_float), ("alpha", ctypes.c_float),
        ("one_m_alpha", ctypes.c_float), ("eps_abs", ctypes.c_float),
        ("eps_rel", ctypes.c_float), ("rescue_rho_scale", ctypes.c_float),
        ("rescue_trigger", ctypes.c_float), ("rescue_exit", ctypes.c_float),
        ("ns_tol", ctypes.c_float),
    ]


def params(n: int, m: int, *, sigma: float, alpha: float, eps_abs: float,
           eps_rel: float, max_iter: int, check_every: int,
           refine_steps: int, rescue_max_iter: int, rescue_rho_scale: float,
           rescue_trigger: float, rescue_exit: float, ns_tol: float,
           ns_max_iters: int, nnz_cap: int = 0) -> _Params:
    """The kernels' scalar parameters (shared with B4); ``nnz_cap``: the
    resident layout's cap (0 in the streaming layout)."""
    if check_every < 1 or max_iter < 1:
        raise ValueError("check_every and max_iter must be >= 1")
    return _Params(n=n, m=m, max_iter=max_iter, check_every=check_every,
                   refine_steps=refine_steps,
                   rescue_max_iter=rescue_max_iter,
                   ns_max_iters=ns_max_iters, n_pad=_n_pad(n),
                   nnz_cap=nnz_cap, sigma=sigma,
                   alpha=alpha, one_m_alpha=1.0 - alpha, eps_abs=eps_abs,
                   eps_rel=eps_rel, rescue_rho_scale=rescue_rho_scale,
                   rescue_trigger=rescue_trigger, rescue_exit=rescue_exit,
                   ns_tol=ns_tol)


def pack_vectors(q, l, u, rho, D, E, c):
    """(nvecs (B, 2, n), vecs (B, 5, m), c_inv (B,)) as the kernels read
    them."""
    vec = _vec(q, l, u, rho, D, E, c)
    vecs = torch.stack([vec.l, vec.u, vec.rho, vec.rho_inv, vec.E_inv], 1)
    nvecs = torch.stack([q, D], 1).contiguous()
    return nvecs, vecs, vec.c_inv.contiguous()


@functools.lru_cache(maxsize=None)
def _launchers(lib: ctypes.CDLL):
    """The library's B1 entry points with their prototypes (bound once)."""
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return dict(
        main=cuda_build.bind(lib, "rl_admm",
                             [_Params] + [ctypes.c_void_p] * 15 + tail),
        rescue=cuda_build.bind(lib, "rl_admm_rescue",
                               [_Params] + [ctypes.c_void_p] * 13 + tail),
        ctas=cuda_build.bind(lib, "rl_admm_ctas_per_sm", [ctypes.c_int] * 4),
        smem=cuda_build.bind(lib, "rl_admm_smem_bytes", [ctypes.c_int] * 4,
                             ctypes.c_longlong))


def launch_rescue(p: _Params, P, Kinv, A, nvecs, vecs, c_inv, kpad, x, z, y,
                  stats, flags, ws, layout: str) -> None:
    """The rescue launch over the lanes that ``flags[:, 2]`` marks, in the
    main launch's ``layout``; ``kpad``: B4's pad scalars of Kinv, or None
    (B1)."""
    Pt = cuda_build.ptr
    err = _launchers(cuda_build.library())["rescue"](
        p, Pt(P), Pt(Kinv), Pt(A), Pt(nvecs), Pt(vecs), Pt(c_inv),
        ctypes.c_void_p(None if kpad is None else kpad.data_ptr()), Pt(x),
        Pt(z), Pt(y), Pt(stats), Pt(flags), Pt(ws),
        int(layout == "resident"), P.shape[0], cuda_build.stream_ptr())
    cuda_build.check(err)


def pick_layout(n: int, m: int, layout) -> Layout:
    """The layout of a launch: the plan's (``layout=None``), or the one
    forced; forcing "resident" where it does not fit raises."""
    plan = choose_layout(n, m)
    if layout is None or layout == plan.name:
        return plan
    if layout == "resident":
        raise ValueError(f"the resident layout does not fit n={n}, m={m}")
    return _stream_layout(n, m)


def ctas_per_sm_on_card(n: int, m: int, layout: Layout) -> int:
    """CTAs per SM of B1's main kernel in ``layout`` by the card's own
    occupancy calculator (shared memory, registers, threads)."""
    return _launchers(cuda_build.library())["ctas"](
        n, m, layout.nnz_cap, int(layout.name == "resident"))


def smem_bytes_on_card(n: int, m: int, layout: Layout) -> int:
    """The main launch's dynamic shared memory as the kernel source counts
    it (to hold :func:`smem_plan` against)."""
    return _launchers(cuda_build.library())["smem"](
        n, m, layout.nnz_cap, int(layout.name == "resident"))


def admm_iterate(P, Kinv, A, q, l, u, rho, D, E, c, x0, z0, y0, *,
                 sigma: float, alpha: float, eps_abs: float, eps_rel: float,
                 max_iter: int, check_every: int, refine_steps: int,
                 rescue_max_iter: int = 0, rescue_rho_scale: float = 5.0,
                 rescue_trigger: float = 7.5e-3, rescue_exit: float = 1e-3,
                 ns_tol: float = 1e-3, ns_max_iters: int = 40,
                 layout=None) -> Tuple[torch.Tensor, ...]:
    """ADMM loop for a batch of scaled QPs: P, Kinv (B, n, n), A (B, m, n),
    q, D, x0 (B, n), l, u, rho, E, z0, y0 (B, m), c (B,).

    Returns (x, y, pri, dua, iters, solved, rescued). CPU tensors run the
    plain version; CUDA float32 contiguous tensors launch the kernel, in
    the plan's layout (``layout=None``) or the one forced (``"resident"``,
    ``"stream"``: for checks only)."""
    if layout not in (None,) + LAYOUTS:
        raise ValueError(f"layout must be None, 'resident' or 'stream', got "
                         f"{layout!r}")
    kw = dict(sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
              max_iter=max_iter, check_every=check_every,
              refine_steps=refine_steps, rescue_max_iter=rescue_max_iter,
              rescue_rho_scale=rescue_rho_scale,
              rescue_trigger=rescue_trigger, rescue_exit=rescue_exit,
              ns_tol=ns_tol, ns_max_iters=ns_max_iters)
    if not P.is_cuda:
        return admm_iterate_plain(P, Kinv, A, q, l, u, rho, D, E, c, x0, z0,
                                  y0, **kw)
    Bsz, n, _ = P.shape
    m = A.shape[1]
    for t, name, shape in (
            (P, "P", (Bsz, n, n)), (Kinv, "Kinv", (Bsz, n, n)),
            (A, "A", (Bsz, m, n)), (q, "q", (Bsz, n)), (l, "l", (Bsz, m)),
            (u, "u", (Bsz, m)), (rho, "rho", (Bsz, m)), (D, "D", (Bsz, n)),
            (E, "E", (Bsz, m)), (c, "c", (Bsz,)), (x0, "x0", (Bsz, n)),
            (z0, "z0", (Bsz, m)), (y0, "y0", (Bsz, m))):
        cuda_build.expect(t, name, shape)
    plan = pick_layout(n, m, layout)
    p = params(n, m, nnz_cap=plan.nnz_cap, **kw)
    nvecs, vecs, c_inv = pack_vectors(q, l, u, rho, D, E, c)
    x = torch.empty_like(x0)
    z = torch.empty_like(z0)
    y = torch.empty_like(y0)
    stats = torch.empty((Bsz, 2), dtype=torch.float32, device=P.device)
    flags = torch.empty((Bsz, 4), dtype=torch.int32, device=P.device)
    ws = torch.empty((Bsz if rescue_max_iter > 0 else 0, 4, n, n),
                     dtype=torch.float32, device=P.device)
    Pt = cuda_build.ptr
    err = _launchers(cuda_build.library())["main"](
        p, Pt(P), Pt(Kinv), Pt(A), Pt(nvecs), Pt(vecs), Pt(c_inv), Pt(x0),
        Pt(z0), Pt(y0), Pt(x), Pt(z), Pt(y), Pt(stats), Pt(flags),
        Pt(streamed.tensor(P.device)), int(plan.name == "resident"), Bsz,
        cuda_build.stream_ptr())
    launches.n += 1
    layout_launches[plan.name].n += 1
    cuda_build.check(err)
    if rescue_max_iter > 0:
        launch_rescue(p, P, Kinv, A, nvecs, vecs, c_inv, None, x, z, y,
                      stats, flags, ws, plan.name)
    return (x, y, stats[:, 0], stats[:, 1], flags[:, 0], flags[:, 1] != 0,
            flags[:, 2] != 0)
