"""Giant-horizon FTOCP assembly, the bridge from ``controllers/ocp.py`` to
the sharded solver ``ops/qp_sharded.py`` (port of
``racinglmpc_tpu/controllers/giant_ftocp.py``).

The product FTOCP (N = 14, z in R^200) is served by the dense batched
solver. This module assembles the same problem family -- the FTOCP with the
LMPC terminal safe-set block -- at horizons two orders of magnitude longer
(N in the hundreds, z in the thousands), where the dense KKT inverse cannot
exist and the QP is split over a mesh.

The stage dynamics are real: the local system identification
(``models/sysid.local_linearization_horizon``, its plain version: this path
does not engage the sys-ID kernel, as the reference does not) along one
stored closed-loop lap, tiled cyclically around the track when the horizon
is longer than the lap. The terminal block selects the stored states
nearest the horizon end in arc length, with their time-to-go as the
cost-to-go. Everything goes through ``ocp.make_templates`` /
``ocp.assemble_qp`` at a batch of 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from racinglmpc_tpu_torch.controllers import ocp
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models import track as track_mod
from racinglmpc_tpu_torch.ops.qp import QPData
from racinglmpc_tpu_torch.utils.config import LMPCConfig


class GiantFTOCP(NamedTuple):
    dims: ocp.FTOCPDims
    qp: QPData               # batch of 1
    x_lin: torch.Tensor      # (N+1, 6) linearization trajectory
    ss_points: torch.Tensor  # (6, K) selected terminal safe-set states
    qfun_sel: torch.Tensor   # (K,) their cost-to-go


def assemble_giant_ftocp(trk: track_mod.Track, x_lap: torch.Tensor,
                         u_lap: torch.Tensor, steps, *, N: int, K: int = 48,
                         cfg: LMPCConfig = LMPCConfig(), dt: float = 0.1,
                         dtype=torch.float32, device=None) -> GiantFTOCP:
    """Assemble one giant-horizon LMPC FTOCP from one stored lap
    (``x_lap`` (T, 6) curvilinear, ``u_lap`` (T, 2), ``steps`` valid rows)
    on ``device`` (the lap's by default). The linearization trajectory
    tiles the lap (row ``k % steps``); the QP is in OSQP form."""
    dev = x_lap.device if device is None else torch.device(device)
    x_lap = x_lap.to(dev, dtype)
    u_lap = u_lap.to(dev, dtype)
    T = x_lap.shape[0]
    steps = int(steps)

    # sys-ID store: the lap, model_laps times (the reference's trToUse laps)
    store = sysid.make_lap_store(1, cfg.model_laps, max(T, cfg.model_pts),
                                 dtype=dtype, device=dev)
    st = torch.tensor([steps], device=dev)
    for _ in range(cfg.model_laps):
        store = sysid.add_lap(store, x_lap[None], u_lap[None], st)

    # linearization trajectory: the lap tiled cyclically over N+1 stages
    wrap = max(steps, 1)
    x_lin = x_lap[torch.arange(N + 1, device=dev) % wrap]
    u_lin = u_lap[torch.arange(N, device=dev) % wrap]
    A, B, C = sysid.local_linearization_horizon(
        store, trk, x_lin[None, :N], u_lin[None], cfg, dt)

    # terminal safe set: K stored states nearest (in s) to the horizon end,
    # cost-to-go = steps left in the lap. The window is clamped inside the
    # lap: a modular one would mix s ~ 0 and s ~ L points with
    # lap-discontinuous cost-to-go in one block.
    valid = torch.arange(T, device=dev) < steps
    ds = (torch.where(valid, x_lap[:, 4], torch.full_like(x_lap[:, 4], 1e9))
          - x_lin[N, 4]).abs()
    j0 = int(torch.argmin(ds))
    j0c = min(max(j0, K // 2), max(steps - (K - K // 2), K // 2))
    sel = torch.clamp(j0c + torch.arange(K, device=dev) - K // 2,
                      0, max(steps - 1, 0))
    ss_points = x_lap[sel].T                              # (6, K)
    qfun_sel = (steps - sel).to(dtype)                    # time-to-go

    dims, tmpl = ocp.make_templates(
        N=N, Q=cfg.Q, R=cfg.R, dR=cfg.dR, Qf=(0.0,) * 6, q_slack=cfg.q_slack,
        x_ref=(0.0,) * 6, ey_max=cfg.ey_max, delta_max=cfg.delta_max,
        a_max=cfg.a_max, K=K, q_terminal_slack=cfg.q_terminal_slack,
        dtype=dtype, device=dev)
    qp = ocp.assemble_qp(dims, tmpl, ocp.StageDynamics(A, B, C),
                         x_lap[:1], u_lap[:1], cfg.dR,
                         ss_points=ss_points[None], qfun_sel=qfun_sel[None])
    return GiantFTOCP(dims=dims, qp=qp, x_lin=x_lin, ss_points=ss_points,
                      qfun_sel=qfun_sel)
