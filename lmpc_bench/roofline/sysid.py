"""B2 (``ops/cuda_sysid.py``): the local sys-ID at the N horizon points,
one CTA a scenario, one warp a point.

Operations, float32, of one point: the scaled L1 distance to every
candidate row of every stored lap (5 differences, 5 scalings, 4 sums),
the Epanechnikov weight of each of the ``knn`` picks a lap (4), the two
weighted normal equations summed over the picks (5 weighted entries, the
upper 5 x 5 triangle and the right-hand sides of one and two columns:
100 a pick), two 5 x 5 Gauss-Jordan solves (200) and the kinematic rows
(60). The candidate rows are each lap's valid rows less its last (the
store's ``steps``); the kNN selection's comparisons are not counted.

Bytes: each stored lap's valid rows (x, u), its step count, the horizon
(x_lin, u_lin) read once, and A, B, C written once, float32, for every
scenario of every launch.
"""
from __future__ import annotations


def work(w: dict):
    """(operations, bytes) of the profiled launches; ``w``: launches,
    batch, N, knn, lap_rows (each stored lap's step count)."""
    rows = [int(v) for v in w["lap_rows"]]
    cand = sum(max(v - 1, 0) for v in rows)
    picks = sum(min(int(w["knn"]), max(v - 1, 0)) for v in rows)
    per_point = 14 * cand + 4 * picks + 100 * picks + 260
    points = float(w["launches"]) * int(w["batch"]) * int(w["N"])
    words_lane = 8 * sum(rows) + len(rows) + int(w["N"]) * (8 + 54)
    return points * per_point, 4.0 * words_lane * float(w["launches"]) * int(
        w["batch"])
