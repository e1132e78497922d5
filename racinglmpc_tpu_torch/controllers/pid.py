"""Exploration-noise PID path-following baseline (port of
``racinglmpc_tpu/controllers/pid.py``):

  steering = -0.6*ey - 0.9*epsi + clip(0.25*n0, +-0.9)
  accel    = 1.5*(vt - vx)      + clip(0.10*n1, +-0.2)

with (n0, n1) standard-normal draws passed in as a (B, 2) tensor.
"""
from __future__ import annotations

from typing import Optional

import torch


def pid_step(ctrl_state, x: torch.Tensor, noise: Optional[torch.Tensor], *,
             vt: float, use_noise: bool = True):
    """One batched PID step on x (B, 6); returns (ctrl_state, u (B, 2))."""
    steer = -0.6 * x[:, 5] - 0.9 * x[:, 3]
    accel = 1.5 * (vt - x[:, 0])
    if use_noise and noise is not None:
        noise = noise.to(x.dtype)
        steer = steer + torch.clamp(noise[:, 0] * 0.25, -0.9, 0.9)
        accel = accel + torch.clamp(noise[:, 1] * 0.10, -0.2, 0.2)
    return ctrl_state, torch.stack([steer, accel], -1).to(x.dtype)


def make_pid_controller(vt: float, noise: bool = True):
    """Bind PID hyper-parameters; returns ``(step_fn, init_state)``."""

    def step(ctrl_state, x, draws):
        return pid_step(ctrl_state, x, draws, vt=vt, use_noise=noise)

    return step, ()
