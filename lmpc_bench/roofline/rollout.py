"""B3 (``ops/cuda_rollout.py``): one control period of the plant, 100
Euler substeps a scenario.

Operations, float32, of one substep of the dual-frame model (the
reference's ``ref_plant.plant_step``): slip angles (7), the two Pacejka
forces (10), the three velocity derivatives (17), the curvature factor and
arc-length rate (8), the inertial pose (14) and the curvilinear pose (11):
73, each sine, cosine and arctangent counted as one operation. It is a
dependent chain, so it reads far below its roofline.

Bytes: x, x_glob and u read once, x and x_glob written once, float32.
"""
from __future__ import annotations

OPS_PER_SUBSTEP = 73


def work(w: dict):
    """(operations, bytes) of the profiled launches; ``w``: launches,
    batch, substeps."""
    lanes = float(w["launches"]) * int(w["batch"])
    return (lanes * int(w["substeps"]) * OPS_PER_SUBSTEP,
            4.0 * lanes * (6 + 6 + 2 + 6 + 6))
