"""Kernel B4: the fused-prologue ADMM (K build + Newton-Schulz refresh +
the ADMM loop of B1, per scenario).

Replaces ``racinglmpc_tpu/ops/pallas_qp.py::_kernel_fused`` (through
``admm_iterate_fused``). Per scenario, on the Ruiz-scaled QP with fixed rho:

- K = A'(rho A) + P + sigma I;
- the Jacobi init Xj = diag(d) / max(|I - K diag(d)|_F, 1), d = 1/diag K;
- the warm test ``warm_ok`` and finite and |I - K X0|_F < 0.9 on
  X0 = ``kinv0``;
- two Newton-Schulz passes X <- X + X (I - K X) while max|I - K X| >
  ``ns_tol`` and it < ``ns_max_iters``, each from r = inf (so every pass
  runs at least one iteration); the second restarts from Xj when the first
  ended non-finite or above 50 ``ns_tol``;
- then B1's ADMM loop and rho-escalation rescue on the refreshed inverse,
  the loop's products at ``iter_precision`` (``cuda_qp``: "highest",
  "bf16x3" or "default"; "bf16x3" splits the refreshed inverse), the
  prologue and the rescue at full float32.

This Newton-Schulz is NOT ``ops/qp._ns_inverse``: it has the Frobenius
warm gate (no power-iteration gate), no divergence exit at r >= 1e6 and no
final unconditional squaring, and ``ns_resid`` is the residual before the
last update. Its plain version (``cuda_qp.jacobi_start``,
``cuda_qp.ns_two_pass``) is shared with B1's rescue alone.

Padding: the Pallas kernel pads n to a multiple of 128 with an identity
pad block in K and a unit pad diagonal in the warm start, so its warm test
sees no pad residual, while on the Jacobi path the pad scalar starts at
1/max(cj, 1) and its own Newton-Schulz sequence enters max|R| as |1 - xp|.
Both versions carry that scalar (returned as ``kinv_pad``) and hand it to
the rescue, whose warm test on Kinv/s sees the pad block as B1's does.

The CUDA version (``csrc/cuda_qp_fused.cu``) is one call of three
launches, each one CTA of 512 threads per scenario (each scenario exits
its own Newton-Schulz loop and its own ADMM loop): the prologue, then B1's
main kernel on the refreshed inverse, in the layout
``cuda_qp.choose_layout`` picks, its streamed scenarios counted in
:data:`streamed` (B1's launch counters do not count it); then B1's rescue
launch (``cuda_qp.launch_rescue``) for the lanes that need it. The
prologue builds K with B1's rescue's product core into a per-scenario
global workspace; its Newton-Schulz products take one of two cores, by n
alone (:func:`core`):

- ``"resident"`` (n <= 152, :data:`RESIDENT_MAX_N`): X and R stay in
  shared memory for the whole prologue and K streams from the workspace in
  16-column slabs by bulk copies; the warps holding cells multiply, 6 x 8
  outputs a thread (:func:`rgeo`);
- ``"product"`` (larger n): ``qp_common.cuh:product``, shared with B1's
  rescue: K, X, Y and R in the workspace, 8 x 8 outputs a thread
  (``cuda_qp.geo``), the operands streamed through double-buffered
  shared-memory slabs.

Each output of either keeps the first port's fmaf chain (so the bits are
those of the 64 x 64-tiled GEMM it replaced, on both cores). :func:`plan`
is the prologue's core, shared memory, CTAs per SM and waves.

Counters. :data:`launches` counts calls, :data:`core_launches` the
calls whose prologue took each core. While a tracing session is armed
each call adds its per-lane outputs to :data:`work` on the device (sums of
``FusedResult`` fields, a few small launches and no host sync; disarmed
nothing is added): ``fused.lanes``, ``fused.warm_lanes`` (the warm start
taken), ``fused.ns_lane_iters`` (Newton-Schulz iterations of both passes)
and ``fused.rescued_lanes``. The plain version counts the same way.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from racinglmpc_tpu_torch.ops import cuda_build, cuda_qp
from racinglmpc_tpu_torch.runtime import tracing
from racinglmpc_tpu_torch.utils.batched import lane_where as _w

launches = tracing.LaunchCounter("fused_admm")
# launches at each iteration precision of the ADMM loop
precision_launches = {p: tracing.LaunchCounter(f"fused_admm_{p}")
                      for p in cuda_qp.ITER_PRECISIONS}
CORES = ("resident", "product")
# launches whose Newton-Schulz products took each core
core_launches = {c: tracing.LaunchCounter(f"fused_core_{c}") for c in CORES}
streamed = tracing.ScenarioCounter("fused_admm_streamed")
work = tracing.ScenarioCounter(
    "fused", ("lanes", "warm_lanes", "ns_lane_iters", "rescued_lanes"),
    armed_only=True)
MAX_REGS = 128    # registers a thread may take at 512 threads, one CTA an SM
# the resident core (csrc/cuda_qp_fused.cu): rows of an output cell (its
# columns 8), columns of K a slab, a slab row's pitch, slab buffers
_RM, _SK, _SKP, _NSTAGE = 6, 16, 20, 2


class RGeo(NamedTuple):
    """The resident core at n (cuda_qp_fused.cu:rgeo): thread t < cr cc
    holds rows 6 ci .. 6 ci + 5 and columns 4 cj .. 4 cj + 3 and 4 cc +
    4 cj .. 4 cc + 4 cj + 3, (ci, cj) = (t // cc, t % cc)."""
    cc: int       # column cells, ceil(n / 8)
    cr: int       # row cells, ceil(n / 6)
    rows: int     # rows of X, R and a slab buffer
    ld: int       # row pitch of X and R (a multiple of 4, ld / 4 odd)
    nslab: int    # 16-column slabs of K


def rgeo(n: int) -> RGeo:
    r4 = cuda_qp._r4(n)
    cr = -(-n // _RM)
    return RGeo(-(-n // 8), cr, max(_RM * cr, r4),
                r4 + (4 if (r4 // 4) % 2 == 0 else 0), -(-n // _SK))


def core(n: int) -> str:
    """The core of the prologue's Newton-Schulz products at n
    (cuda_qp_fused.cu:fused_resident): ``"resident"`` where its cells fit
    512 threads, else ``"product"``."""
    g = rgeo(n)
    return "resident" if g.cr * g.cc <= cuda_qp._NT else "product"


RESIDENT_MAX_N = max(n for n in range(1, 257) if core(n) == "resident")


def ws_floats(n: int) -> int:
    """Floats of a scenario's global workspace (cuda_qp_fused.cu:
    fused_ws_floats): 4 n^2 (the product core's K, X, Y, R; B1's rescue
    takes the same after), or the resident core's K and slabs where more."""
    return max(4 * n * n,
               cuda_qp._r4(n * n) + rgeo(n).nslab * n * _SKP)


def smem_floats(n: int, m: int) -> int:
    """Floats of the prologue's dynamic shared memory. Resident: the slab
    buffers' mbarriers (8), the reductions' scratch (32), the Jacobi
    diagonal, then X and R (each rows x ld + 8) and the slab buffers, over
    which the K build lays its context and slabs first; product: the
    context, the product core's slabs and the diagonal."""
    if core(n) == "product":
        return cuda_qp.ctx_floats(n, m) + cuda_qp.prologue_floats(n)
    g = rgeo(n)
    kbuild = cuda_qp.ctx_floats(n, m) + cuda_qp.prologue_floats(n) \
        - cuda_qp._r4(n)
    return 8 + 32 + cuda_qp._r4(n) + max(
        kbuild, 2 * (g.rows * g.ld + 8) + _NSTAGE * g.rows * _SKP)


class Plan(NamedTuple):
    core: str          # the Newton-Schulz products' core (:func:`core`)
    layout: str        # the ADMM launch's layout (cuda_qp.choose_layout)
    nbytes: int        # dynamic shared memory of a prologue CTA
    threads: int       # threads holding an output cell in a product pass
    passes: int        # passes of a product over the rows
    ctas_per_sm: int   # of the prologue: shared memory, threads, registers
    waves: int         # of the batch over the card's SMs


def plan(n: int, m: int, B: int = 256) -> Plan:
    """The prologue launch at (n, m) for a batch of B (the kernel source
    counts the same bytes, ``rl_fused_smem_bytes``). CTAs per SM count
    shared memory (with the runtime's reservation), threads and registers:
    over 64 a thread hold the card to one CTA of 512 threads per SM (the
    resident core's shared memory alone does too). The ADMM loop then runs
    as B1's main launch in ``layout``."""
    nbytes = 4 * smem_floats(n, m)
    by_smem = (0 if nbytes > cuda_build.SMEM_PER_CTA else
               cuda_build.SMEM_PER_SM // (nbytes + cuda_build.SMEM_RESERVED))
    ctas = min(by_smem, 2048 // cuda_qp._NT,
               cuda_build.REGS_PER_SM // (cuda_qp._NT * MAX_REGS))
    c = core(n)
    if c == "resident":
        g = rgeo(n)
        threads, passes = g.cr * g.cc, 1
    else:
        g = cuda_qp.geo(n)
        threads, passes = g.cr * g.cells, g.passes
    return Plan(c, cuda_qp.choose_layout(n, m).name, nbytes, threads,
                passes, ctas,
                -(-B // (ctas * cuda_build.N_SM)) if ctas else 0)


class FusedResult(NamedTuple):
    x: torch.Tensor         # (B, n) scaled coordinates
    y: torch.Tensor         # (B, m)
    pri: torch.Tensor       # (B,) unscaled primal residual at exit
    dua: torch.Tensor       # (B,)
    iters: torch.Tensor     # (B,) int32 ADMM iterations
    solved: torch.Tensor    # (B,) bool
    kinv: torch.Tensor      # (B, n, n) the refreshed KKT inverse
    ns_resid: torch.Tensor  # (B,) residual before the last NS update
    rescued: torch.Tensor   # (B,) bool
    kinv_pad: torch.Tensor  # (B,) scalar of the refreshed inverse's pad block
    warm: torch.Tensor      # (B,) bool: the warm start was taken
    ns_iters: torch.Tensor  # (B,) int32 NS iterations of both passes


def build_k(P, A, rho, sigma: float) -> torch.Tensor:
    """K = A'(rho A) + P + sigma I (float32, (B, n, n))."""
    f = torch.float32
    P, A, rho = P.to(f), A.to(f), rho.to(f)
    eye = torch.eye(P.shape[-1], dtype=f, device=P.device)
    return A.transpose(1, 2) @ (A * rho[:, :, None]) + P + sigma * eye


def prologue_plain(P, A, kinv0, warm_ok, rho, *, sigma: float, ns_tol: float,
                   ns_max_iters: int):
    """K build, Jacobi init, warm test and the two Newton-Schulz passes.
    Returns (kinv, ns_resid, kinv_pad, warm, ns_iters)."""
    X0 = kinv0.to(torch.float32)
    K = build_k(P, A, rho, sigma)
    Xj, xj_pad = cuda_qp.jacobi_start(K)
    warm = torch.zeros(K.shape[:1], dtype=torch.bool, device=K.device)
    if bool(warm_ok.any()):
        R0 = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device) - K @ X0
        r0f = torch.sqrt((R0 * R0).sum((1, 2)))
        warm = warm_ok & torch.isfinite(r0f) & (r0f < 0.9)
    X = _w(warm, X0, Xj)
    xp = torch.where(warm, torch.ones_like(xj_pad), xj_pad)
    X, resid, xp, its = cuda_qp.ns_two_pass(K, X, xp, Xj, xj_pad, ns_tol,
                                            ns_max_iters)
    return X, resid, xp, warm, its


def admm_iterate_fused_plain(P, A, kinv0, warm_ok, q, l, u, rho, D, E, c, x0,
                             z0, y0, *, sigma: float, alpha: float,
                             eps_abs: float, eps_rel: float, max_iter: int,
                             check_every: int, refine_steps: int,
                             ns_tol: float, ns_max_iters: int,
                             rescue_max_iter: int = 0,
                             rescue_rho_scale: float = 5.0,
                             rescue_trigger: float = 7.5e-3,
                             rescue_exit: float = 1e-3,
                             iter_precision: str = "highest") -> FusedResult:
    """Plain PyTorch version of the kernel on the same batched inputs."""
    cuda_qp.iter_precision_code(iter_precision)
    kinv, resid, xp, warm, ns_it = prologue_plain(
        P, A, kinv0, warm_ok, rho, sigma=sigma, ns_tol=ns_tol,
        ns_max_iters=ns_max_iters)
    x, y, pri, dua, iters, solved, rescued = cuda_qp.admm_iterate_plain(
        P, kinv, A, q, l, u, rho, D, E, c, x0, z0, y0, sigma=sigma,
        alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel, max_iter=max_iter,
        check_every=check_every, refine_steps=refine_steps,
        rescue_max_iter=rescue_max_iter, rescue_rho_scale=rescue_rho_scale,
        rescue_trigger=rescue_trigger, rescue_exit=rescue_exit,
        ns_tol=ns_tol, ns_max_iters=ns_max_iters, kinv_pad=xp,
        iter_precision=iter_precision)
    return FusedResult(x, y, pri, dua, iters, solved, kinv, resid, rescued,
                       xp, warm, ns_it)


@functools.lru_cache(maxsize=None)
def _launchers(lib: ctypes.CDLL):
    """The library's B4 entry points with their prototypes (bound once)."""
    return dict(
        main=cuda_build.bind(lib, "rl_admm_fused",
                             [cuda_qp._Params] + [ctypes.c_void_p] * 21
                             + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
        ctas=cuda_build.bind(lib, "rl_fused_ctas_per_sm", [ctypes.c_int] * 2),
        smem=cuda_build.bind(lib, "rl_fused_smem_bytes", [ctypes.c_int] * 2,
                             ctypes.c_longlong),
        resident=cuda_build.bind(lib, "rl_fused_resident", [ctypes.c_int]),
        ws=cuda_build.bind(lib, "rl_fused_ws_floats", [ctypes.c_int],
                           ctypes.c_longlong))


def smem_bytes_on_card(n: int, m: int) -> int:
    """The prologue launch's dynamic shared memory as the kernel source
    counts it (to hold :func:`plan` against)."""
    return _launchers(cuda_build.library())["smem"](n, m)


def source_plan(n: int) -> tuple:
    """(core, workspace floats a scenario) at n as the kernel source
    decides them (to hold :func:`core` and :func:`ws_floats` against)."""
    f = _launchers(cuda_build.library())
    return ("resident" if f["resident"](n) else "product"), f["ws"](n)


def ctas_per_sm_on_card(n: int, m: int) -> int:
    """CTAs per SM of the prologue kernel by the card's own occupancy
    calculator (shared memory, registers, threads)."""
    return _launchers(cuda_build.library())["ctas"](n, m)


@tracing.traced("qp.admm")
def admm_iterate_fused(P, A, kinv0, warm_ok, q, l, u, rho, D, E, c, x0, z0,
                       y0, *, sigma: float, alpha: float, eps_abs: float,
                       eps_rel: float, max_iter: int, check_every: int,
                       refine_steps: int, ns_tol: float, ns_max_iters: int,
                       rescue_max_iter: int = 0,
                       rescue_rho_scale: float = 5.0,
                       rescue_trigger: float = 7.5e-3,
                       rescue_exit: float = 1e-3,
                       iter_precision: str = "highest") -> FusedResult:
    """Fused prologue + ADMM for a batch of scaled QPs: P, kinv0 (B, n, n),
    A (B, m, n), warm_ok (B,) bool, q, D, x0 (B, n), l, u, rho, E, z0, y0
    (B, m), c (B,). CPU tensors run the plain version; CUDA float32
    contiguous tensors launch the kernel, its ADMM loop at
    ``iter_precision``."""
    prec = cuda_qp.iter_precision_code(iter_precision)
    kw = dict(sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
              max_iter=max_iter, check_every=check_every,
              refine_steps=refine_steps, ns_tol=ns_tol,
              ns_max_iters=ns_max_iters, rescue_max_iter=rescue_max_iter,
              rescue_rho_scale=rescue_rho_scale,
              rescue_trigger=rescue_trigger, rescue_exit=rescue_exit)
    if not P.is_cuda:
        return _counted(admm_iterate_fused_plain(
            P, A, kinv0, warm_ok, q, l, u, rho, D, E, c, x0, z0, y0,
            iter_precision=iter_precision, **kw))
    Bsz, n, _ = P.shape
    m = A.shape[1]
    for t, name, shape in (
            (P, "P", (Bsz, n, n)), (A, "A", (Bsz, m, n)),
            (kinv0, "kinv0", (Bsz, n, n)), (q, "q", (Bsz, n)),
            (l, "l", (Bsz, m)), (u, "u", (Bsz, m)), (rho, "rho", (Bsz, m)),
            (D, "D", (Bsz, n)), (E, "E", (Bsz, m)), (c, "c", (Bsz,)),
            (x0, "x0", (Bsz, n)), (z0, "z0", (Bsz, m)),
            (y0, "y0", (Bsz, m))):
        cuda_build.expect(t, name, shape)
    cuda_build.expect(warm_ok, "warm_ok", (Bsz,), dtype=torch.bool)
    plan = cuda_qp.choose_layout(n, m)
    p = cuda_qp.params(n, m, nnz_cap=plan.nnz_cap, **kw)
    nvecs, vecs, c_inv = cuda_qp.pack_vectors(q, l, u, rho, D, E, c)
    dev = P.device
    warm_i = warm_ok.to(torch.int32)
    x = torch.empty_like(x0)
    z = torch.empty_like(z0)
    y = torch.empty_like(y0)
    stats = torch.empty((Bsz, 2), dtype=torch.float32, device=dev)
    flags = torch.empty((Bsz, 4), dtype=torch.int32, device=dev)
    kinv = torch.empty((Bsz, n, n), dtype=torch.float32, device=dev)
    ns_resid = torch.empty((Bsz,), dtype=torch.float32, device=dev)
    kpad = torch.empty((Bsz,), dtype=torch.float32, device=dev)
    ns_info = torch.empty((Bsz, 2), dtype=torch.int32, device=dev)
    ws = torch.empty((Bsz, ws_floats(n)), dtype=torch.float32, device=dev)
    Pt = cuda_build.ptr
    err = _launchers(cuda_build.library())["main"](
        p, Pt(P), Pt(A), Pt(kinv0), Pt(warm_i), Pt(nvecs), Pt(vecs),
        Pt(c_inv), Pt(x0), Pt(z0), Pt(y0), Pt(x), Pt(z), Pt(y), Pt(stats),
        Pt(flags), Pt(kinv), Pt(ns_resid), Pt(kpad), Pt(ns_info), Pt(ws),
        Pt(streamed.tensor(dev)), prec, int(plan.name == "resident"), Bsz,
        cuda_build.stream_ptr())
    launches.n += 1
    precision_launches[iter_precision].n += 1
    core_launches[core(n)].n += 1
    cuda_build.check(err)
    if rescue_max_iter > 0:
        cuda_qp.launch_rescue(p, P, kinv, A, nvecs, vecs, c_inv, kpad, x, z,
                              y, stats, flags, ws, plan.name)
    return _counted(FusedResult(
        x, y, stats[:, 0], stats[:, 1], flags[:, 0], flags[:, 1] != 0, kinv,
        ns_resid, flags[:, 2] != 0, kpad, ns_info[:, 0] != 0, ns_info[:, 1]))


def _counted(r: FusedResult) -> FusedResult:
    """Add the call's per-lane outputs to :data:`work` while armed."""
    if tracing.armed():
        cnt = work.tensor(r.x.device)
        cnt += torch.stack([torch.full((), r.x.shape[0], dtype=torch.int32,
                                       device=cnt.device),
                            r.warm.sum(dtype=torch.int32),
                            r.ns_iters.sum(dtype=torch.int32),
                            r.rescued.sum(dtype=torch.int32)])
    return r
