"""Track geometry as a table of per-segment tensors + vectorized queries.

Port of ``racinglmpc_tpu/models/track.py``: the L-shaped track is built on
the host (numpy, float64) into a :class:`Track` of per-segment tensors, and
every query is an elementwise tensor function over any leading shape.
Segment lookup is ``torch.searchsorted`` over the cumulative arc length, as
the reference does with ``jnp.searchsorted``.

:class:`TrackTable` is the same segment table as plain Python floats; the
CUDA kernels take it as launch arguments.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Track(NamedTuple):
    s0: torch.Tensor        # (S,) cumulative arc length at segment start
    seg_len: torch.Tensor   # (S,) segment length
    curv: torch.Tensor      # (S,) signed curvature (0 for straights)
    x0: torch.Tensor        # (S,) start point
    y0: torch.Tensor        # (S,)
    psi0: torch.Tensor      # (S,) tangent angle at start
    cx: torch.Tensor        # (S,) arc center (0 for straights)
    cy: torch.Tensor        # (S,)
    theta0: torch.Tensor    # (S,) angle of start point about center (arcs)
    total_len: torch.Tensor  # () track length
    half_width: torch.Tensor  # ()
    slack: torch.Tensor     # () out-of-lane tolerance used by local_position


@dataclasses.dataclass(frozen=True)
class TrackTable:
    """Host copy of the segment table (kernel launch arguments)."""

    s0: Tuple[float, ...]
    curv: Tuple[float, ...]
    total_len: float


def track_table(trk: Track) -> TrackTable:
    """One device->host copy; build once per controller / runner."""
    return TrackTable(
        s0=tuple(float(v) for v in trk.s0.tolist()),
        curv=tuple(float(v) for v in trk.curv.tolist()),
        total_len=float(trk.total_len),
    )


_L_CURVE = 4.5
L_TRACK_SPEC = np.array(
    [
        [1.0, 0.0],
        [_L_CURVE, _L_CURVE / np.pi],
        [_L_CURVE / 2.0, -_L_CURVE / np.pi],
        [_L_CURVE, _L_CURVE / np.pi],
        [_L_CURVE / np.pi * 2.0, 0.0],
        [_L_CURVE / 2.0, _L_CURVE / np.pi],
    ]
)


def _wrap(a: float) -> float:
    return (a + np.pi) % (2.0 * np.pi) - np.pi


def make_track(
    spec: Optional[np.ndarray] = None,
    half_width: float = 0.4,
    slack: float = 0.45,
    dtype=torch.float32,
    device="cuda",
) -> Track:
    """Build a :class:`Track` from ``spec`` rows ``[length, signed radius]``
    (host float64 construction; a closing straight returns to the origin)."""
    if spec is None:
        spec = L_TRACK_SPEC
    spec = np.asarray(spec, dtype=np.float64)
    n = spec.shape[0]
    S = n + 1
    s0, seg_len, curv = np.zeros(S), np.zeros(S), np.zeros(S)
    x0, y0, psi0 = np.zeros(S), np.zeros(S), np.zeros(S)
    cx, cy, theta0 = np.zeros(S), np.zeros(S), np.zeros(S)

    x, y, psi, s = 0.0, 0.0, 0.0, 0.0
    for i in range(n):
        length, radius = spec[i]
        x0[i], y0[i], psi0[i], s0[i] = x, y, psi, s
        seg_len[i] = length
        if radius == 0.0:
            x += length * np.cos(psi)
            y += length * np.sin(psi)
        else:
            curv[i] = 1.0 / radius
            direction = 1.0 if radius >= 0 else -1.0
            cx[i] = x + abs(radius) * np.cos(psi + direction * np.pi / 2.0)
            cy[i] = y + abs(radius) * np.sin(psi + direction * np.pi / 2.0)
            theta0[i] = np.arctan2(y - cy[i], x - cx[i])
            span = length / abs(radius)
            ang_end = theta0[i] + direction * span
            x = cx[i] + abs(radius) * np.cos(ang_end)
            y = cy[i] + abs(radius) * np.sin(ang_end)
            psi = _wrap(psi + span * np.sign(radius))
        s += length

    x0[n], y0[n], psi0[n], s0[n] = x, y, psi, s
    seg_len[n] = np.hypot(x, y)
    total = s0[n] + seg_len[n]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return Track(
        s0=t(s0), seg_len=t(seg_len), curv=t(curv), x0=t(x0), y0=t(y0),
        psi0=t(psi0), cx=t(cx), cy=t(cy), theta0=t(theta0),
        total_len=t(total), half_width=t(half_width), slack=t(slack),
    )


def wrap_s(track: Track, s: torch.Tensor) -> torch.Tensor:
    """Wrap arc length into [0, L) for s > L (s <= L is left alone)."""
    L = track.total_len
    return torch.where(s > L, s - L * torch.floor(s / L), s)


def _segment_index(track: Track, s_w: torch.Tensor) -> torch.Tensor:
    idx = torch.searchsorted(track.s0, s_w.contiguous(), right=True) - 1
    return idx.clamp(0, track.s0.shape[0] - 1)


def curvature(track: Track, s: torch.Tensor) -> torch.Tensor:
    """Signed curvature at arc length ``s`` (any shape)."""
    return track.curv[_segment_index(track, wrap_s(track, s))]


def tangent_angle(track: Track, s: torch.Tensor, epsi=0.0) -> torch.Tensor:
    """Heading of the centerline tangent at ``s`` plus ``epsi``."""
    s_w = wrap_s(track, s)
    i = _segment_index(track, s_w)
    psi = track.psi0[i] + (s_w - track.s0[i]) * track.curv[i]
    psi = torch.atan2(torch.sin(psi), torch.cos(psi))
    return psi + epsi


def global_position(track: Track, s: torch.Tensor, ey: torch.Tensor):
    """Curvilinear (s, ey) -> inertial (X, Y)."""
    s_w = wrap_s(track, s)
    i = _segment_index(track, s_w)
    ds = s_w - track.s0[i]
    psi = track.psi0[i]
    kappa = track.curv[i]
    xs = track.x0[i] + ds * torch.cos(psi) - ey * torch.sin(psi)
    ys = track.y0[i] + ds * torch.sin(psi) + ey * torch.cos(psi)
    on_arc = kappa != 0.0
    r_abs = torch.where(
        on_arc, 1.0 / torch.abs(torch.where(on_arc, kappa, torch.ones_like(kappa))),
        torch.zeros_like(kappa))
    direction = torch.sign(kappa)
    ang = track.theta0[i] + direction * ds * torch.abs(kappa)
    xa = track.cx[i] + (r_abs - direction * ey) * torch.cos(ang)
    ya = track.cy[i] + (r_abs - direction * ey) * torch.sin(ang)
    return torch.where(on_arc, xa, xs), torch.where(on_arc, ya, ys)


def _wrap_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def local_position(track: Track, x: torch.Tensor, y: torch.Tensor,
                   psi: torch.Tensor):
    """Inertial (X, Y, psi) -> curvilinear (s, ey, epsi, valid).

    Every segment's candidate projection is evaluated and the first valid
    one is taken; off-track points return ``valid=False`` and the sentinel
    1e4 values.
    """
    x, y, psi = x[..., None], y[..., None], psi[..., None]
    tx, ty = torch.cos(track.psi0), torch.sin(track.psi0)
    vx_, vy_ = x - track.x0, y - track.y0
    s_loc_line = vx_ * tx + vy_ * ty
    ey_line = -vx_ * ty + vy_ * tx
    epsi_line = _wrap_angle(psi - track.psi0)
    lane = track.half_width + track.slack
    valid_line = ((track.curv == 0.0) & (s_loc_line >= 0.0)
                  & (s_loc_line <= track.seg_len) & (ey_line.abs() <= lane))

    on_arc = track.curv != 0.0
    kappa_safe = torch.where(on_arc, track.curv, torch.ones_like(track.curv))
    r_abs = 1.0 / torch.abs(kappa_safe)
    direction = torch.sign(track.curv)
    dxc, dyc = x - track.cx, y - track.cy
    theta = torch.atan2(dyc, dxc)
    arc2 = _wrap_angle(theta - track.theta0)
    arc1 = track.seg_len * track.curv
    s_loc_arc = torch.abs(arc2) * r_abs
    ey_arc = -direction * (torch.hypot(dxc, dyc) - r_abs)
    epsi_arc = _wrap_angle(psi - (track.psi0 + arc2))
    valid_arc = (on_arc & (torch.sign(arc1) == torch.sign(arc2))
                 & (arc2.abs() <= arc1.abs()) & (ey_arc.abs() <= lane))

    s_cand = track.s0 + torch.where(on_arc, s_loc_arc, s_loc_line)
    ey_cand = torch.where(on_arc, ey_arc, ey_line)
    epsi_cand = torch.where(on_arc, epsi_arc, epsi_line)
    valid = torch.where(on_arc, valid_arc, valid_line)

    any_valid = valid.any(-1)
    first = valid.to(torch.int8).argmax(-1, keepdim=True)
    sentinel = torch.full_like(any_valid, 10000.0, dtype=s_cand.dtype)

    def pick(c):
        return torch.where(any_valid, c.gather(-1, first)[..., 0], sentinel)

    return pick(s_cand), pick(ey_cand), pick(epsi_cand), any_valid
