"""The L-shaped track of RacingLMPC (``src/fnc/simulator/Track.py``,
``Map(halfWidth=0.4)``), as the float64 segment table the reference plant
and sys-ID read: cumulative arc length at each segment's start, signed
curvature, and the track length.

The segment list is the upstream's: rows ``[length, signed radius]``
(radius 0 for a straight), then a closing straight back to the origin.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

_CURVE = 4.5
SPEC = np.array([
    [1.0, 0.0],
    [_CURVE, _CURVE / np.pi],
    [_CURVE / 2.0, -_CURVE / np.pi],
    [_CURVE, _CURVE / np.pi],
    [_CURVE / np.pi * 2.0, 0.0],
    [_CURVE / 2.0, _CURVE / np.pi],
])
HALF_WIDTH = 0.4


class Table(NamedTuple):
    s0: np.ndarray      # (S,) arc length at each segment's start
    curv: np.ndarray    # (S,) signed curvature
    total_len: float


def table(spec: np.ndarray = SPEC) -> Table:
    """Walk the segments from the origin, heading 0; the last segment is
    the straight that closes the loop."""
    n = spec.shape[0]
    s0 = np.zeros(n + 1)
    curv = np.zeros(n + 1)
    x = y = psi = s = 0.0
    for i, (length, radius) in enumerate(spec):
        s0[i] = s
        if radius == 0.0:
            x += length * np.cos(psi)
            y += length * np.sin(psi)
        else:
            curv[i] = 1.0 / radius
            side = 1.0 if radius >= 0 else -1.0
            cx = x + abs(radius) * np.cos(psi + side * np.pi / 2.0)
            cy = y + abs(radius) * np.sin(psi + side * np.pi / 2.0)
            ang = np.arctan2(y - cy, x - cx) + side * length / abs(radius)
            x = cx + abs(radius) * np.cos(ang)
            y = cy + abs(radius) * np.sin(ang)
            psi = (psi + length / radius + np.pi) % (2.0 * np.pi) - np.pi
        s += length
    s0[n] = s
    return Table(s0=s0, curv=curv, total_len=float(s + np.hypot(x, y)))
