"""ctypes bindings to the native (C++) float64 runtime library, for the
port (the counterpart of the JAX package's ``runtime/native.py``).

Builds ``native/librlmpc_native.so`` on first use (``make`` and g++ in
``native/``) and exposes:

- :func:`solve_qp_admm`: a dense float64 ADMM QP solver, the host-side
  oracle in place of the reference's OSQP;
- :func:`rollout`: the batched Pacejka plant rollout in float64;
- :func:`track_segs`, :func:`vehicle_vals`: their arguments from the
  port's ``Track`` and ``VehicleParams``.

Inputs may be torch tensors (on any device) or numpy arrays; results are
float64 numpy arrays. :func:`available` says whether the library could be
built and loaded; callers skip when it is False.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "librlmpc_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-s"], cwd=_NATIVE_DIR, check=True,
                       capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rlmpc_solve_qp_admm.restype = ctypes.c_int
    lib.rlmpc_solve_qp_admm.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, dp, dp, dp,
    ]
    lib.rlmpc_rollout.restype = None
    lib.rlmpc_rollout.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++/make missing?)")
    return lib


def _f64(a, copy: bool = False) -> np.ndarray:
    """A C-contiguous float64 numpy array of a tensor or array."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a.copy() if copy else a


def _as_c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def solve_qp_admm(P, q, A, l, u, *, max_iter: int = 1000, rho: float = 0.1,
                  rho_eq_scale: float = 1e3, sigma: float = 1e-6,
                  alpha: float = 1.6, eps_abs: float = 1e-6,
                  eps_rel: float = 1e-6, scaling_iters: int = 10,
                  refine_steps: int = 1) -> Tuple[np.ndarray, np.ndarray,
                                                  dict]:
    """Solve one dense QP in OSQP form, min 1/2 x'Px + q'x s.t.
    l <= Ax <= u (infinite bounds allowed). Returns (x, y, info)."""
    lib = _require()
    P, q, A = _f64(P), _f64(q), _f64(A)
    n, m = P.shape[0], A.shape[0]
    if P.shape != (n, n) or q.shape != (n,) or A.shape != (m, n):
        raise ValueError(f"shapes P {P.shape}, q {q.shape}, A {A.shape} do "
                         "not form one QP")
    l = np.where(np.isfinite(_f64(l)), _f64(l), -1e30)
    u = np.where(np.isfinite(_f64(u)), _f64(u), 1e30)
    if l.shape != (m,) or u.shape != (m,):
        raise ValueError(f"bounds of shapes {l.shape}, {u.shape} for {m} "
                         "rows")
    x, y, info = np.zeros(n), np.zeros(m), np.zeros(3)
    status = lib.rlmpc_solve_qp_admm(
        n, m, _as_c(P), _as_c(q), _as_c(A), _as_c(l), _as_c(u),
        max_iter, rho, rho_eq_scale, sigma, alpha, eps_abs, eps_rel,
        scaling_iters, refine_steps, _as_c(x), _as_c(y), _as_c(info))
    return x, y, {"status": status, "pri_res": info[0], "dua_res": info[1],
                  "iters": int(info[2]), "solved": status == 0}


def rollout(x, x_glob, u, vp_vals, segs, track_len: float, *,
            substeps: int = 100,
            dt_sub: float = 1e-3) -> Tuple[np.ndarray, np.ndarray]:
    """Batched plant rollout: x, x_glob (B, 6), u (B, 2); returns the next
    (x, x_glob). ``segs`` (nseg, 3) rows [s0, s_end, curvature] and
    ``track_len`` from :func:`track_segs`; ``vp_vals`` from
    :func:`vehicle_vals`."""
    lib = _require()
    x, xg = _f64(x, copy=True), _f64(x_glob, copy=True)
    u, vp_vals, segs = _f64(u), _f64(vp_vals), _f64(segs)
    B = x.shape[0]
    if (x.shape != (B, 6) or xg.shape != (B, 6) or u.shape != (B, 2)
            or vp_vals.shape != (10,) or segs.ndim != 2
            or segs.shape[1] != 3):
        raise ValueError("rollout takes x, x_glob (B, 6), u (B, 2), 10 "
                         "vehicle values and (nseg, 3) segments")
    lib.rlmpc_rollout(B, substeps, dt_sub, _as_c(x), _as_c(xg), _as_c(u),
                      _as_c(vp_vals), _as_c(segs), segs.shape[0],
                      float(track_len))
    return x, xg


def track_segs(trk) -> Tuple[np.ndarray, float]:
    """Segment table and length for :func:`rollout` from the port's
    ``models.track.Track``."""
    s0 = _f64(trk.s0)
    return (np.stack([s0, s0 + _f64(trk.seg_len), _f64(trk.curv)], axis=1),
            float(trk.total_len))


def vehicle_vals(vp) -> np.ndarray:
    """The 10 values [m, lf, lr, Iz, Df, Cf, Bf, Dr, Cr, Br] of a scalar
    ``VehicleParams``."""
    return np.asarray([float(getattr(vp, k)) for k in
                       ("m", "lf", "lr", "Iz", "Df", "Cf", "Bf", "Dr", "Cr",
                        "Br")], dtype=np.float64)
