"""Kernel B2: fused local system identification over the horizon.

Replaces ``racinglmpc_tpu/ops/pallas_sysid.py::_kernel`` /
``_kernel_body`` (through ``local_linearization_horizon``). The kernel
(``csrc/cuda_sysid.cu``) runs one CTA per scenario and one warp per horizon
query. Each stored lap is staged once per CTA in shared memory by bulk
asynchronous copies (two buffers: the next lap lands while one is
searched); each lane keeps the sorted top-knn of its candidates
(scaled-L1 distance, then index) in registers, and ``knn_max`` warp-wide
min-reductions over the lanes' heads pick the neighbours, the smaller
index winning ties. The lanes split the 45 sums of the two 5x5 weighted
normal equations (summed in the picks' order), then the entries of
Gauss-Jordan with diagonal pivots in the reference's order; lane 0 writes
the analytic kinematic rows. A ``knn_max`` above :data:`MAX_KNN` takes a
second instance of the kernel, which rescans the lane's candidates each
round for the smallest (distance, index) after the last pick: the same
picks in the same order. Its plain version is
``models/sysid.local_linearization_horizon``.

:func:`plan` is the launch's shared-memory plan, which the kernel source
counts alike (``rl_sysid_smem_bytes``): at the main path's shapes two CTAs
share an SM, so a batch of 256 runs in one wave.

On CPU tensors :func:`local_linearization_horizon` runs the plain version;
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.track import Track, TrackTable, track_table
from racinglmpc_tpu_torch.ops import cuda_build
from racinglmpc_tpu_torch.utils.config import LMPCConfig

MAX_SEG = 16
MAX_N = 32        # one warp per query, at most 1024 threads
MAX_KNN = 7       # picks a lane's list holds; more take the rescan instance
CHUNK = 32        # rounds the rescan instance records at once
MAX_REGS = 64     # registers a thread, the kernel's launch bound
HEADER = 160      # mbarriers, segment table (bytes)
launches = cuda_build.LaunchCounter("sysid")


class _Params(ctypes.Structure):
    _fields_ = [
        ("K", ctypes.c_int), ("T", ctypes.c_int), ("N", ctypes.c_int),
        ("knn", ctypes.c_int), ("empty", ctypes.c_int), ("nseg", ctypes.c_int),
        ("nbuf", ctypes.c_int),
        ("h", ctypes.c_float), ("reg", ctypes.c_float), ("dt", ctypes.c_float),
        ("L", ctypes.c_float), ("scal", ctypes.c_float * 5),
        ("s0", ctypes.c_float * MAX_SEG), ("curv", ctypes.c_float * MAX_SEG),
    ]


class Plan(NamedTuple):
    nbytes: int        # dynamic shared memory of a CTA
    nbuf: int          # lap buffers (2: the next lap is copied meanwhile)
    ctas_per_sm: int   # by shared memory, threads and registers
    waves: int         # of the batch over the card's SMs


def warp_bytes(knn: int) -> int:
    """A warp's scratch (cuda_sysid.cu:warp_floats): records of 10 floats,
    ``MAX_KNN`` of them, or a rescan's chunk of up to ``CHUNK``."""
    return 40 * (MAX_KNN if knn <= MAX_KNN else min(knn, CHUNK))


def smem_bytes(T: int, N: int, nbuf: int, knn: int = MAX_KNN) -> int:
    """Dynamic shared memory of a launch (cuda_sysid.cu:sysid_smem): the
    header, ``nbuf`` lap buffers of T x 8 floats, and a warp's scratch (its
    picks of a lap, then its two augmented 5x5 systems)."""
    return HEADER + nbuf * 32 * T + N * warp_bytes(knn)


@functools.lru_cache(maxsize=64)
def plan(K: int, T: int, N: int, B: int = 256, knn: int = MAX_KNN) -> Plan:
    """The launch for a (B, K, T) store, N queries and ``knn`` picks a lap
    (its scratch): two lap buffers
    unless one buffer fits more CTAs per SM (or K = 1). CTAs per SM count
    shared memory (with the runtime's reservation), threads (2,048 an SM)
    and registers (at most ``MAX_REGS`` a thread); waves assume one CTA
    per scenario over ``cuda_build.N_SM`` SMs."""
    threads = 32 * N
    by_regs = cuda_build.REGS_PER_SM // (threads * MAX_REGS)
    best = None
    for nbuf in ((2, 1) if K > 1 else (1,)):
        nbytes = smem_bytes(T, N, nbuf, knn)
        if nbytes > cuda_build.SMEM_PER_CTA:
            continue
        ctas = min(cuda_build.SMEM_PER_SM // (nbytes
                                              + cuda_build.SMEM_RESERVED),
                   2048 // threads, by_regs)
        if best is None or ctas > best.ctas_per_sm:
            best = Plan(nbytes, nbuf, ctas,
                        -(-B // (ctas * cuda_build.N_SM)))
    if best is None:
        raise ValueError(f"a lap of T={T} rows does not fit the shared "
                         f"memory of one CTA")
    return best


@functools.lru_cache(maxsize=64)
def launch_params(K: int, T: int, N: int, nbuf: int, cfg: LMPCConfig,
                  dt_ctrl: float, table: TrackTable) -> _Params:
    """The kernel's launch arguments (cached: the kernel takes them by
    value, so one struct serves every launch of the same shapes)."""
    if len(table.s0) > MAX_SEG:
        raise ValueError(f"track has {len(table.s0)} segments; the kernel "
                         f"takes at most {MAX_SEG}")
    p = _Params(K=K, T=T, N=N, knn=cfg.knn_max, empty=sysid._EMPTY,
                nseg=len(table.s0), nbuf=nbuf, h=cfg.kernel_h,
                reg=cfg.reg_lambda + cfg.reg_jitter, dt=dt_ctrl,
                L=table.total_len)
    for i, v in enumerate(cfg.feat_scaling):
        p.scal[i] = v
    for i, (s, k) in enumerate(zip(table.s0, table.curv)):
        p.s0[i] = s
        p.curv[i] = k
    return p


@functools.lru_cache(maxsize=None)
def _launcher(lib: ctypes.CDLL):
    return cuda_build.bind(lib, "rl_sysid", [_Params] + [
        ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p])


def smem_bytes_on_card(T: int, N: int, nbuf: int, knn: int = MAX_KNN) -> int:
    """The launch's dynamic shared memory as the kernel source counts it
    (to hold :func:`plan` against)."""
    fn = cuda_build.bind(cuda_build.library(), "rl_sysid_smem_bytes",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    return fn(T, N, nbuf, knn)


def ctas_per_sm_on_card(T: int, N: int, nbuf: int, knn: int = MAX_KNN) -> int:
    """CTAs per SM by the card's own occupancy calculator, for the instance
    ``knn`` takes."""
    fn = cuda_build.bind(cuda_build.library(), "rl_sysid_ctas_per_sm",
                         [ctypes.c_int] * 4)
    return fn(T, N, nbuf, knn)


# the plain version: the same function in PyTorch (same argument layout)
local_linearization_horizon_plain = sysid.local_linearization_horizon


def local_linearization_horizon(store: sysid.LapStore, trk: Track,
                                x_lin: torch.Tensor, u_lin: torch.Tensor,
                                cfg: LMPCConfig, dt_ctrl: float = 0.1,
                                table: Optional[TrackTable] = None):
    """(B, N, 6), (B, N, 2) -> A (B, N, 6, 6), B (B, N, 6, 2), C (B, N, 6)
    from the lap store (B, K, T, ·)."""
    if not x_lin.is_cuda:
        return local_linearization_horizon_plain(store, trk, x_lin, u_lin,
                                                 cfg, dt_ctrl)
    Bsz, K, T, _ = store.x.shape
    N = x_lin.shape[1]
    if N > MAX_N:
        raise ValueError(f"horizon {N} > {MAX_N}: one warp per query")
    cuda_build.expect(store.x, "store.x", (Bsz, K, T, 6))
    cuda_build.expect(store.u, "store.u", (Bsz, K, T, 2))
    cuda_build.expect(store.steps, "store.steps", (Bsz, K), torch.int32)
    cuda_build.expect(x_lin, "x_lin", (Bsz, N, 6))
    cuda_build.expect(u_lin, "u_lin", (Bsz, N, 2))
    if T % 2 or store.x.data_ptr() % 16 or store.u.data_ptr() % 16:
        raise ValueError("the kernel bulk-copies each lap: T must be even "
                         "and store.x, store.u 16-byte aligned")
    pl = plan(K, T, N, Bsz, cfg.knn_max)
    p = launch_params(K, T, N, pl.nbuf, cfg, float(dt_ctrl),
                      table if table is not None else track_table(trk))
    # one allocation, three contiguous outputs
    out = torch.empty((Bsz * N * 54,), dtype=torch.float32,
                      device=x_lin.device)
    A = out[:Bsz * N * 36].view(Bsz, N, 6, 6)
    Bm = out[Bsz * N * 36:Bsz * N * 48].view(Bsz, N, 6, 2)
    C = out[Bsz * N * 48:].view(Bsz, N, 6)
    P = cuda_build.ptr
    err = _launcher(cuda_build.library())(
        p, P(store.x), P(store.u), P(store.steps), P(x_lin), P(u_lin), P(A),
        P(Bm), P(C), Bsz, cuda_build.stream_ptr())
    launches.n += 1
    cuda_build.check(err)
    return A, Bm, C
