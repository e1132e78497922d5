"""Kernel B3: the batched plant rollout (100 Euler substeps), CUDA + plain.

Replaces ``racinglmpc_tpu/ops/pallas_rollout.py::_kernel`` (through
``plant_step_batch``). The kernel (``csrc/cuda_rollout.cu``) runs each
scenario on four lanes in lockstep: lanes 0 and 1 take the front and rear
tire (``atan2f``, ``atanf``, ``sinf``), lanes 2 and 3 the sine and cosine
of epsi and psi, each lane one of the four divisions, and every lane then
holds the whole state; the segment index is carried across substeps. It
computes every value by the expression ``models/dynamics.py`` uses
(``atan2f``/``atanf``: the Pallas kernel's polynomial atan only existed
because Mosaic has no atan), and the curvature lookup is the same
``searchsorted`` rule as the plain path.

On CPU tensors :func:`plant_step_batch` runs the plain version; on CUDA
tensors it launches the kernel or raises. The launch arguments (vehicle
scalars, segment table, substeps) are built once per (vehicle, table,
config) and the C prototype once per library.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from racinglmpc_tpu_torch.models import dynamics
from racinglmpc_tpu_torch.models.track import Track, TrackTable, track_table
from racinglmpc_tpu_torch.ops import cuda_build
from racinglmpc_tpu_torch.utils.config import SimConfig, VehicleParams

MAX_SEG = 16
launches = cuda_build.LaunchCounter("rollout")


class _Params(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float) for f in VehicleParams._fields] + [
        ("dT", ctypes.c_float), ("L", ctypes.c_float),
        ("substeps", ctypes.c_int), ("nseg", ctypes.c_int),
        ("s0", ctypes.c_float * MAX_SEG), ("curv", ctypes.c_float * MAX_SEG),
    ]


@functools.lru_cache(maxsize=64)
def launch_params(vp: VehicleParams, table: TrackTable,
                  cfg: SimConfig) -> _Params:
    """The kernel's launch arguments for this vehicle, track and config
    (cached: the kernel takes them by value, so one struct serves every
    launch)."""
    if len(table.s0) > MAX_SEG:
        raise ValueError(f"track has {len(table.s0)} segments; the kernel "
                         f"takes at most {MAX_SEG}")
    if any(b < a for a, b in zip(table.s0, table.s0[1:])):
        raise ValueError("segment starts must not decrease: the kernel "
                         "carries the segment index across substeps")
    p = _Params(*(float(v) for v in vp))
    p.dT = cfg.delta_t
    p.L = table.total_len
    p.substeps = cfg.substeps
    p.nseg = len(table.s0)
    for i, (s, k) in enumerate(zip(table.s0, table.curv)):
        p.s0[i] = s
        p.curv[i] = k
    return p


@functools.lru_cache(maxsize=None)
def _launcher(lib: ctypes.CDLL):
    return cuda_build.bind(lib, "rl_rollout", [_Params] + [
        ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])


def plant_step_batch_plain(x, x_glob, u, vp: VehicleParams, trk: Track,
                           cfg: SimConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the noise-free substeps of models/dynamics."""
    out = dynamics.rollout(dynamics.PlantState(x=x, x_glob=x_glob), u, vp,
                           trk, cfg)
    return out.x, out.x_glob


def plant_step_batch(x: torch.Tensor, x_glob: torch.Tensor, u: torch.Tensor,
                     vp: VehicleParams, trk: Track, cfg: SimConfig,
                     table: Optional[TrackTable] = None):
    """One noise-free control period for the whole batch:
    x, x_glob (B, 6), u (B, 2) -> (x_next, x_glob_next). ``table``: the
    host segment table (computed from ``trk`` when omitted)."""
    if not x.is_cuda:
        return plant_step_batch_plain(x, x_glob, u, vp, trk, cfg)
    B = x.shape[0]
    for t, name, w in ((x, "x", 6), (x_glob, "x_glob", 6), (u, "u", 2)):
        cuda_build.expect(t, name, (B, w))
    params = launch_params(vp, table if table is not None
                           else track_table(trk), cfg)
    ox, oxg = torch.empty((2, B, 6), dtype=x.dtype, device=x.device)
    P = cuda_build.ptr
    err = _launcher(cuda_build.library())(
        params, P(x), P(x_glob), P(u), P(ox), P(oxg), B,
        cuda_build.stream_ptr())
    launches.n += 1
    cuda_build.check(err)
    return ox, oxg
