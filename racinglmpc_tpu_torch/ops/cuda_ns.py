"""The Newton-Schulz inverse of the QP prologue as one CUDA kernel.

Replaces no Pallas kernel: the reference leaves this loop to XLA's
``while_loop`` (``racinglmpc_tpu/ops/qp.py:_ns_inverse``), and
:func:`ns_inverse_plain` runs it as a host loop of batched GEMMs with one
``nonzero()`` sync a pass. The kernel (``csrc/cuda_ns.cu``) runs each
lane's whole inverse in one CTA, the warm gate, the runs, the restart and
the float64 final squaring, and each lane exits on the device: one launch
an inverse, no host sync. The source's note gives its bound and design.

:func:`ns_inverse` decides from its input: a CUDA float32 K with
n <= :data:`NMAX` launches the kernel (or raises); CPU tensors, float64 and
larger n take the plain version. Both return (X, resid).

Counters. :data:`launches` counts launches. While a tracing session is
armed the kernel adds to :data:`work` (device atomics; a null pointer
disarmed), under the names the plain version's host counters use:
``ns.lanes``, ``ns.warm_gate_lanes`` (lanes whose warm gate ran: the
kernel runs it only where ``warm_ok``, the plain version over the whole
batch when any lane is), ``ns.{first,restart,final}.lane_iters``, and
``ns.kernel_lanes``, the lanes the kernel inverted. The plain version's
``ns.*.passes`` count its host syncs; the kernel has none.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from racinglmpc_tpu_torch.ops import cuda_build
from racinglmpc_tpu_torch.runtime import tracing
from racinglmpc_tpu_torch.utils.batched import lane_where as _w
from racinglmpc_tpu_torch.utils.batched import mv as _mv

# the largest n the kernel takes (csrc/cuda_ns.cu: 10 x 25 tiles of 20 x 8
# outputs, one a thread of a 256-thread CTA)
NMAX = 200
launches = tracing.LaunchCounter("ns")
work = tracing.ScenarioCounter(
    "ns", ("lanes", "warm_gate_lanes", "first.lane_iters",
           "restart.lane_iters", "final.lane_iters", "kernel_lanes"),
    armed_only=True)
# the plain version's counters, per run: passes (one host sync each) and
# lane-iterations (lanes a pass updates)
NS_COUNTS = {run: (f"ns.{run}.passes", f"ns.{run}.lane_iters")
             for run in ("first", "restart", "final")}
# per-lane statistics (``stats``): warm start taken, iterations of the
# first run and of the restart run, restarted from Jacobi
STATS = ("warm", "first", "restart", "restarted")


def engages(K: torch.Tensor) -> bool:
    """The kernel's engagement rule: a CUDA float32 K within its limit."""
    return K.is_cuda and K.dtype == torch.float32 and 1 <= K.shape[-1] <= NMAX


def levels(tol: float, staged: bool):
    """Each run's exit levels, in turn."""
    return (max(0.3, tol), max(3e-2, tol), tol) if staged else (tol,)


def ns_inverse_plain(K, X0, warm_ok, tol: float, max_iters: int,
                     staged: bool = False, stats: dict = None):
    """Newton-Schulz inverse X <- X(2I - KX) per lane (reference
    ``_ns_inverse``, same gates): warm start X0 only where a 12-step power
    iteration from the all-ones vector puts the spectral radius of
    I - K X0 below 0.9, else the norm-scaled Jacobi init; a restart pass
    from Jacobi when the first pass failed; an unconditional final
    squaring, its products in float64 for float32 K. Returns (X, resid).

    While a tracing session is armed it counts (:data:`NS_COUNTS`) the
    passes and lane-iterations of the first run, the restart run and the
    final squaring (one pass over every lane), ``ns.lanes``, the lanes
    inverted, and ``ns.warm_gate_lanes``, the lanes of a batch whose warm
    gate ran: numbers the host already holds. ``stats``: a dict that
    receives the per-lane tensors of :data:`STATS`."""
    Bsz, n, _ = K.shape
    dt, dev = K.dtype, K.device
    I = torch.eye(n, dtype=dt, device=dev)
    d = 1.0 / torch.clamp(torch.diagonal(K, dim1=1, dim2=2), min=1e-12)
    KXj = K * d[:, None, :]
    cj = torch.sqrt(((I - KXj) ** 2).sum((1, 2)))
    Xj = (I * d[:, None, :]) / torch.clamp(cj, min=1.0)[:, None, None]

    big = torch.full((Bsz,), 1e5, dtype=dt, device=dev)
    if bool(warm_ok.any()):
        tracing.count("ns.warm_gate_lanes", Bsz)
        R0 = I - K @ X0
        r0_m = R0.abs().amax((1, 2))
        v = torch.full((Bsz, n), 1.0 / math.sqrt(n), dtype=dt, device=dev)
        nrm = torch.zeros((Bsz,), dtype=dt, device=dev)
        for _ in range(12):
            w = _mv(R0, v)
            nrm = torch.sqrt((w * w).sum(-1))
            v = w / torch.clamp(nrm, min=1e-30)[:, None]
        use_warm = (warm_ok & torch.isfinite(nrm) & (nrm < 0.9)
                    & torch.isfinite(r0_m))
        X_init = _w(use_warm, X0, Xj)
        r_init = torch.where(use_warm, r0_m, big)
    else:
        use_warm = torch.zeros_like(warm_ok)
        X_init, r_init = Xj, big
    iters = []

    def run_phase(X, r, level, counts):
        X, r = X.clone(), r.clone()
        it = torch.zeros((Bsz,), dtype=torch.int32, device=dev)
        while True:
            act = (r > level) & (r < 1e6) & (it < max_iters)
            idx = act.nonzero()[:, 0]
            if idx.numel() == 0:
                iters.append(it)
                return X, r
            tracing.count(counts[0])
            tracing.count(counts[1], idx.numel())
            if idx.numel() == Bsz:      # every lane active: no gathers
                R = I - K @ X
                X = X + X @ R
                r = R.abs().amax((1, 2))
                it += 1
                continue
            Xa = X[idx]
            R = I - K[idx] @ Xa
            X[idx] = Xa + Xa @ R
            r[idx] = R.abs().amax((1, 2))
            it[idx] += 1

    def run(X, r, counts):
        for level in levels(tol, staged):
            X, r = run_phase(X, r, level, counts)
        return X, r

    tracing.count("ns.lanes", Bsz)
    X, resid = run(X_init, r_init, NS_COUNTS["first"])
    n_first = len(iters)
    bad = ~torch.isfinite(resid) | (resid > 50 * tol)
    X2, resid2 = run(_w(bad, Xj, X), torch.where(bad, big, resid),
                     NS_COUNTS["restart"])
    if stats is not None:
        stats.update(warm=use_warm, first=sum(iters[:n_first]),
                     restart=sum(iters[n_first:]), restarted=bad)
    # The final unconditional squaring. On float32 K its two products run
    # in float64 and X3 is rounded back once (a mixed-precision refinement
    # step): a float32 R2 = I - K X2 carries the rounding of its n-term
    # sums, which holds the inverse at max|I - K X3| ~5e-4 on the main
    # path's FTOCPs, where B1's iteration tail grows with that residual;
    # in float64 it lands at ~1e-4, the float32 inverse's own rounding.
    # Float64 K takes its own dtype, unchanged.
    wide = torch.float64 if dt == torch.float32 else dt
    tracing.count(NS_COUNTS["final"][0])
    tracing.count(NS_COUNTS["final"][1], Bsz)
    K2, X2w = K.to(wide), X2.to(wide)
    R2 = torch.eye(n, dtype=wide, device=dev) - K2 @ X2w
    r2_m = R2.abs().amax((1, 2)).to(dt)
    ok2 = torch.isfinite(r2_m) & (r2_m < 1.0)
    X3 = _w(ok2, (X2w + X2w @ R2).to(dt), X2)
    return X3, torch.where(ok2, torch.minimum(resid2, r2_m), resid2)


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("max_iters", ctypes.c_int),
                ("n_levels", ctypes.c_int), ("levels", ctypes.c_float * 3),
                ("bad", ctypes.c_float), ("v0", ctypes.c_float)]


@functools.lru_cache(maxsize=64)
def params(n: int, tol: float, max_iters: int, staged: bool) -> _Params:
    """The kernel's scalars; each float as float32 compares it (the plain
    version's Python floats meet float32 tensors)."""
    lv = levels(tol, staged)
    p = _Params(n=n, max_iters=max_iters, n_levels=len(lv), bad=50 * tol,
                v0=1.0 / math.sqrt(n))
    for i, v in enumerate(lv):
        p.levels[i] = v
    return p


@functools.lru_cache(maxsize=None)
def _launchers(lib: ctypes.CDLL):
    return dict(
        run=cuda_build.bind(lib, "rl_ns_inverse", [_Params]
                            + [ctypes.c_void_p] * 8
                            + [ctypes.c_int, ctypes.c_void_p]),
        ws=cuda_build.bind(lib, "rl_ns_ws_floats", [ctypes.c_int],
                           ctypes.c_longlong),
        max_n=cuda_build.bind(lib, "rl_ns_max_n", []))


def ns_inverse(K, X0, warm_ok, tol: float, max_iters: int,
               staged: bool = False, stats: dict = None):
    """(X, resid) of :func:`ns_inverse_plain`, by the kernel where
    :func:`engages`; ``stats`` as there (int32 per-lane tensors)."""
    if not engages(K):
        return ns_inverse_plain(K, X0, warm_ok, tol, max_iters, staged,
                                stats)
    B, n = K.shape[0], K.shape[-1]
    cuda_build.expect(K, "K", (B, n, n))
    cuda_build.expect(X0, "X0", (B, n, n))
    cuda_build.expect(warm_ok, "warm_ok", (B,), torch.bool)
    fns = _launchers(cuda_build.library())
    X = torch.empty_like(K)
    resid = torch.empty((B,), dtype=K.dtype, device=K.device)
    ws = torch.empty((B * fns["ws"](n),), dtype=K.dtype, device=K.device)
    st = (torch.empty((B, len(STATS)), dtype=torch.int32, device=K.device)
          if stats is not None else None)
    P = cuda_build.ptr
    err = fns["run"](params(n, float(tol), int(max_iters), bool(staged)),
                     P(K), P(X0), P(warm_ok), P(X), P(resid),
                     ctypes.c_void_p(None if st is None else st.data_ptr()),
                     P(ws), work.ptr(K.device), B, cuda_build.stream_ptr())
    launches.n += 1
    cuda_build.check(err)
    if st is not None:
        stats.update({k: st[:, i] for i, k in enumerate(STATS)})
        for k in ("warm", "restarted"):
            stats[k] = stats[k].bool()
    return X, resid
