"""Single-track bicycle + Pacejka plant, dual-frame Euler integration.

Port of ``racinglmpc_tpu/models/dynamics.py``. One control step is
``cfg.substeps`` explicit-Euler substeps that propagate both the curvilinear
state ``x = [vx, vy, wz, epsi, s, ey]`` and the global state
``x_glob = [vx, vy, wz, psi, X, Y]``, then clipped Gaussian noise on
(vx, vy, wz). Batched over any leading shape. Noise comes in as a tensor of
standard-normal draws (shape (..., 3)), so tests can feed the reference's
draws; it is scaled, clipped and added to ``x`` only, never ``x_glob``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from racinglmpc_tpu_torch.models import track as track_mod
from racinglmpc_tpu_torch.utils.config import SimConfig, VehicleParams


class PlantState(NamedTuple):
    x: torch.Tensor        # (..., 6) curvilinear [vx, vy, wz, epsi, s, ey]
    x_glob: torch.Tensor   # (..., 6) global      [vx, vy, wz, psi, X, Y]


def tire_forces(vp: VehicleParams, vx, vy, wz, delta):
    """Pacejka lateral tire forces (front, rear)."""
    alpha_f = delta - torch.atan2(vy + vp.lf * wz, vx)
    alpha_r = -torch.atan2(vy - vp.lr * wz, vx)
    fyf = vp.Df * torch.sin(vp.Cf * torch.atan(vp.Bf * alpha_f))
    fyr = vp.Dr * torch.sin(vp.Cr * torch.atan(vp.Br * alpha_r))
    return fyf, fyr


def _substep(state: PlantState, u, vp: VehicleParams, trk: track_mod.Track,
             dT: float) -> PlantState:
    """One explicit-Euler substep of both frames."""
    vx, vy, wz, epsi, s, ey = state.x.unbind(-1)
    psi, X, Y = state.x_glob[..., 3], state.x_glob[..., 4], state.x_glob[..., 5]
    delta, a = u[..., 0], u[..., 1]

    fyf, fyr = tire_forces(vp, vx, vy, wz, delta)
    dvx = a - fyf * torch.sin(delta) / vp.m + wz * vy
    dvy = (fyf * torch.cos(delta) + fyr) / vp.m - wz * vx
    dwz = (vp.lf * fyf * torch.cos(delta) - vp.lr * fyr) / vp.Iz

    cur = track_mod.curvature(trk, s)
    den = 1.0 - cur * ey
    # off-track guard (den -> 0 past the curvature center), as the reference
    den = torch.where(den >= 0, den.clamp(min=0.05), den.clamp(max=-0.05))
    s_dot = (vx * torch.cos(epsi) - vy * torch.sin(epsi)) / den
    depsi = wz - s_dot * cur
    dey = vx * torch.sin(epsi) + vy * torch.cos(epsi)

    vxn, vyn, wzn = vx + dT * dvx, vy + dT * dvy, wz + dT * dwz
    x_new = torch.stack([vxn, vyn, wzn, epsi + dT * depsi, s + dT * s_dot,
                         ey + dT * dey], dim=-1)
    x_glob_new = torch.stack([
        vxn, vyn, wzn, psi + dT * wz,
        X + dT * (vx * torch.cos(psi) - vy * torch.sin(psi)),
        Y + dT * (vx * torch.sin(psi) + vy * torch.cos(psi))], dim=-1)
    return PlantState(x=x_new, x_glob=x_glob_new)


def rollout(state: PlantState, u, vp: VehicleParams, trk: track_mod.Track,
            cfg: SimConfig) -> PlantState:
    """``cfg.substeps`` noise-free substeps (one control period)."""
    for _ in range(cfg.substeps):
        state = _substep(state, u, vp, trk, cfg.delta_t)
    return state


def apply_noise(x: torch.Tensor, noise: Optional[torch.Tensor],
                cfg: SimConfig) -> torch.Tensor:
    """Add ``noise_gain * clip(noise * sigma)`` to (vx, vy, wz) when the
    config has noise on and draws are given."""
    if not cfg.noise or noise is None:
        return x
    sig = torch.as_tensor(cfg.noise_sigma, dtype=x.dtype, device=x.device)
    add = cfg.noise_gain * torch.clamp(noise.to(x.dtype) * sig,
                                       -cfg.noise_clip, cfg.noise_clip)
    return torch.cat([x[..., :3] + add, x[..., 3:]], dim=-1)


def plant_step(state: PlantState, u: torch.Tensor, vp: VehicleParams,
               trk: track_mod.Track, cfg: SimConfig,
               noise: Optional[torch.Tensor] = None) -> PlantState:
    """Advance the plant one control period, then add the noise.

    ``noise``: (..., 3) standard-normal draws, or None for no noise.
    """
    out = rollout(state, u, vp, trk, cfg)
    return PlantState(x=apply_noise(out.x, noise, cfg), x_glob=out.x_glob)
