"""Kernel B2: fused local system identification over the horizon.

Replaces ``racinglmpc_tpu/ops/pallas_sysid.py::_kernel`` /
``_kernel_body`` (through ``local_linearization_horizon``). The kernel
(``csrc/cuda_sysid.cu``) runs one CTA per scenario and one warp per horizon
query: scaled-L1 distances of one stored lap at a time into shared memory,
``knn_max`` rounds of a warp-wide (distance, index) arg-min in which the
smaller index wins ties, the two 5x5 weighted normal equations accumulated
in registers, Gauss-Jordan with diagonal pivots in the reference's order,
and the analytic kinematic rows. Its plain version is
``models/sysid.local_linearization_horizon``.

On CPU tensors :func:`local_linearization_horizon` runs the plain version;
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.track import Track, TrackTable, track_table
from racinglmpc_tpu_torch.ops import cuda_build
from racinglmpc_tpu_torch.utils.config import LMPCConfig

MAX_SEG = 16
MAX_N = 32
launches = cuda_build.LaunchCounter("sysid")


class _Params(ctypes.Structure):
    _fields_ = [
        ("K", ctypes.c_int), ("T", ctypes.c_int), ("N", ctypes.c_int),
        ("knn", ctypes.c_int), ("empty", ctypes.c_int), ("nseg", ctypes.c_int),
        ("h", ctypes.c_float), ("reg", ctypes.c_float), ("dt", ctypes.c_float),
        ("L", ctypes.c_float), ("scal", ctypes.c_float * 5),
        ("s0", ctypes.c_float * MAX_SEG), ("curv", ctypes.c_float * MAX_SEG),
    ]


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
    tab = table if table is not None else track_table(trk)
    if len(tab.s0) > MAX_SEG:
        raise ValueError(f"track has {len(tab.s0)} segments; the kernel "
                         f"takes at most {MAX_SEG}")
    p = _Params(K=K, T=T, N=N, knn=cfg.knn_max, empty=sysid._EMPTY,
                nseg=len(tab.s0), h=cfg.kernel_h,
                reg=cfg.reg_lambda + cfg.reg_jitter, dt=dt_ctrl,
                L=tab.total_len)
    for i, v in enumerate(cfg.feat_scaling):
        p.scal[i] = v
    for i, (s, k) in enumerate(zip(tab.s0, tab.curv)):
        p.s0[i] = s
        p.curv[i] = k
    A = torch.empty((Bsz, N, 6, 6), dtype=torch.float32, device=x_lin.device)
    Bm = torch.empty((Bsz, N, 6, 2), dtype=torch.float32, device=x_lin.device)
    C = torch.empty((Bsz, N, 6), dtype=torch.float32, device=x_lin.device)
    lib = cuda_build.library()
    lib.rl_sysid.argtypes = [_Params] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.rl_sysid.restype = ctypes.c_int
    P = cuda_build.ptr
    err = lib.rl_sysid(p, P(store.x), P(store.u), P(store.steps), P(x_lin),
                       P(u_lin), P(A), P(Bm), P(C), Bsz,
                       cuda_build.stream_ptr())
    launches.n += 1
    cuda_build.check(err)
    return A, Bm, C
