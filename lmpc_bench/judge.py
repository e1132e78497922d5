"""The comparison that decides ``correct``: what the timed window produced,
held against the float64 NumPy reference in ``reference/``.

The reference takes the benchmark's own inputs (the seed laps of the
traffic's data file, the plant draws, the settings of the configuration
file) and reads the program's outputs only to judge them. It imports no
code of the program.

A sampled step (episode, step, scenario) is judged three ways:

- **the solve** (``input_gap``): the reference rebuilds the safe set from
  the seed laps and the episode's earlier states and inputs (its addPoint
  rows), takes the controller's carried state at that step (the
  linearization trajectory, ``zt``, the last prediction, the last input,
  the step counter) and runs one step of the upstream controller: local
  sys-ID at the N horizon points, terminal-set selection, the FTOCP, an
  interior-point solve to 1e-10. The gap is between the input the
  program applied and the reference's, on every sampled live step: a
  rejected solve holds a stale input (or, after ``fallback_after``
  rejections, the PID law's), and that input is what the car got.
- **the plant** (``plant_gap``): the reference integrates the step's
  state with the applied input and the step's draw, 100 Euler substeps,
  and compares the next state. A substep whose arc length lies within
  float32 rounding of a curvature jump takes the curvature on the
  program's side of the jump (:func:`plant_next`); ``plant_gap.other_side``
  counts the sampled steps where that side is not the float64 one.
- **the carry** (counted in ``mismatches``): the state handed to the next
  step is the solution moved on by one row (the reference's roll), and
  ``zt`` is the successors of the reference's own terminal set weighted
  by the program's multipliers. The check above takes the carried state
  from the program, so the carry is judged here by itself.

The episode's start (the seeded safe set, its cost-to-go, the sys-ID
store, the first linearization trajectory) and each sampled lane's lap
closure (the lap stored with its cost-to-go, the addPoint rows flushed
into the lap before, the store) are compared exactly: their entries are
copies of the inputs, integers, or one float32 addition, which the
reference repeats in float32.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from lmpc_bench.reference import ref_controller, ref_plant
from lmpc_bench.reference import track as ref_track


class Reference(NamedTuple):
    """What the reference is built from: the benchmark's inputs only."""
    N: int
    K: int
    num_ss_it: int
    dR: np.ndarray
    q_slack: tuple
    q_terminal_slack: float
    ey_max: float
    delta_max: float
    a_max: float
    dt: float
    h: float
    knn: int
    model_laps: int
    fallback_after: int
    sigma: np.ndarray
    clip: float
    gain: float
    laps: List[tuple]          # seed laps (x (T, 6), u (T, 2)) float64
    curv: object               # s -> curvature, float64
    L: float
    jumps: tuple               # (s, curvature before, after) at each jump


def reference(config: dict, traffic: dict, seed_laps) -> Reference:
    up = config["upstream"]
    trk = ref_track.table()
    noise = traffic["noise"]
    return Reference(
        N=up["N"], K=up["numSS_Points"], num_ss_it=up["numSS_it"],
        dR=np.asarray(up["dR_LMPC"], float), q_slack=tuple(up["Qslack"]),
        q_terminal_slack=float(up["QterminalSlack"]),
        ey_max=float(up["halfWidth"]), delta_max=float(up["inputConstr"][0]),
        a_max=float(up["inputConstr"][1]),
        dt=float(up["dt"]), h=float(up["sysid"]["h"]),
        knn=int(up["sysid"]["MaxNumPoint"]),
        model_laps=int(up["sysid"]["usedIt"]),
        fallback_after=int(config["port"]["lmpc"]["fallback_after"]),
        sigma=np.asarray(noise["sigma"], float), clip=float(noise["clip"]),
        gain=float(noise["gain"]),
        laps=[(np.asarray(x[:n], float), np.asarray(u[:n], float))
              for x, u, _, n in seed_laps],
        curv=ref_plant.np_curvature_fn(trk), L=trk.total_len,
        jumps=tuple((float(trk.s0[i]), float(trk.curv[i - 1]),
                     float(trk.curv[i])) for i in range(1, len(trk.s0))
                    if trk.curv[i] != trk.curv[i - 1]))


class StepSample(NamedTuple):
    """One scenario's step as the program ran it (float64 copies)."""
    xs: np.ndarray        # (t, 6) the episode's states before this step
    us: np.ndarray        # (t, 2) their applied inputs
    x0: np.ndarray        # (6,) the state the step acted on
    xg0: np.ndarray       # (6,) its inertial twin
    u: np.ndarray         # (2,) the applied input
    x_next: np.ndarray    # (6,) the plant's next state (s not wrapped)
    draw: np.ndarray      # (3,) the step's standard-normal plant draw
    x_lin: np.ndarray     # (N+1, 6) carried state before the step
    u_lin: np.ndarray     # (N, 2)
    zt: np.ndarray        # (6,)
    x_pred: np.ndarray    # (N+1, 6)
    u_old: np.ndarray     # (2,)
    time_step: int
    rejects: int          # consecutive rejections after the step
    new_x_pred: np.ndarray  # (N+1, 6) carried state after the step
    new_u_pred: np.ndarray  # (N, 2)
    new_lam: np.ndarray     # (K,)
    new_x_lin: np.ndarray   # (N+1, 6)
    new_u_lin: np.ndarray   # (N, 2)
    new_zt: np.ndarray      # (6,)
    new_zt_u: np.ndarray    # (2,)
    new_u_old: np.ndarray   # (2,)


class _Judged(ref_controller.RefLMPC):
    """The reference controller, keeping the terminal set it selected."""

    def _terminal_components(self, x0):
        self.selected = super()._terminal_components(x0)
        return self.selected


def _controller(ref: Reference) -> _Judged:
    pm = ref_controller.RefPredictiveModel(ref.curv, ref.model_laps,
                                           h=ref.h, max_pts=ref.knn,
                                           dt=ref.dt)
    lm = _Judged(ref.N, ref.dR, ref.q_slack, ref.q_terminal_slack, ref.K,
                 ref.num_ss_it, pm, ref.L, ey_max=ref.ey_max,
                 delta_max=ref.delta_max, a_max=ref.a_max, dt=ref.dt)
    for x, u in ref.laps:
        pm.add_trajectory(x, u)
        lm.add_trajectory(x, u)
    return lm


# The program's plant sums the arc length in float32: each of a period's
# 100 substeps rounds s + dT * s_dot to within half an ulp of s, so the
# program's s lies within 50 ulps of the float64 reference's by the period's
# end (the float32 increments' own error adds well under an ulp over the
# period, the float32 table's jump lies within half an ulp of the float64
# one). A substep that close to a curvature jump may fall on either side of
# it in the program; 64 ulps of s leave room above that bound. Substeps are
# millimetres apart, so at most one of them lies that close to a jump.
JUMP_ULPS = 64


def _jump_near(ref: Reference, s: float):
    """(curvature the float64 lookup takes, the other side's) where the
    arc length ``s`` lies within ``JUMP_ULPS`` of a jump, else None."""
    if s > ref.L:
        s -= ref.L * np.floor(s / ref.L)
    for at, before, after in ref.jumps:
        if abs(s - at) <= JUMP_ULPS * np.spacing(np.float32(at)):
            return (after, before) if s >= at else (before, after)
    return None


def plant_next(ref: Reference, s: StepSample):
    """The reference's next state of a sampled step, and whether a substep
    at a curvature jump took the curvature on the other side of the jump
    from the float64 lookup's: of the float64 integration and, for each
    substep within ``JUMP_ULPS`` of a jump, the integration with that
    substep's curvature taken from the jump's other side, the one nearest
    the program's next state (the program's side)."""
    noise = np.clip(s.draw * ref.sigma, -ref.clip, ref.clip)
    seen = []

    def run(curv):
        # ref_plant adds 0.01 * noise; scale for another gain
        x, _ = ref_plant.plant_step(s.x0, s.xg0, s.u, curv, dt=ref.dt,
                                    noise=noise * (ref.gain / 0.01))
        return x

    def recorded(v):
        seen.append(v)
        return ref.curv(v)

    best = run(recorded)
    gap = np.abs(s.x_next - best).max()
    other = False
    for i, v in enumerate(list(seen)):
        near = _jump_near(ref, v)
        if near is None:
            continue
        calls = iter(range(len(seen)))

        def flipped(w, i=i, k=near[1]):
            return k if next(calls) == i else ref.curv(w)
        x = run(flipped)
        g = np.abs(s.x_next - x).max()
        if g < gap:
            best, gap, other = x, g, True
    return best, other


def judge_step(ref: Reference, s: StepSample) -> Dict[str, float]:
    """Gaps of one sampled step: ``input``, ``plant``, ``other_side`` (1
    where the plant's reference took a jump's other side), ``pred`` (the
    accepted solve's predicted states, a diagnostic), ``carry`` (entries
    of the carried state off the reference's roll)."""
    lm = _controller(ref)
    for x, u in zip(s.xs, s.us):
        lm.add_point(x, u)
    lm.time_step = int(s.time_step)
    lm.zt = s.zt.copy()
    lm.x_lin = s.x_lin.copy()
    lm.u_lin = s.u_lin.copy()
    lm.x_pred = s.x_pred.copy()
    lm.u_old = s.u_old.copy()
    accepted = s.rejects == 0
    x_next, other_side = plant_next(ref, s)
    plant = float(np.abs(s.x_next - x_next).max())
    try:
        u_ref = lm.solve(s.x0)
    except np.linalg.LinAlgError:
        # the upstream controller has no answer here (a singular sys-ID or
        # KKT system: the state left the region its data covers), so the
        # program's answer cannot be right
        return {"accepted": float(accepted), "input": float("inf"),
                "plant": plant, "other_side": float(other_side),
                "pred": float("nan"), "converged": 0.0, "carry": 0.0}
    return {"accepted": float(accepted),
            "input": float(np.abs(s.u - u_ref).max()), "plant": plant,
            "other_side": float(other_side),
            "pred": (float(np.abs(s.new_x_pred - lm.x_pred).max())
                     if accepted else float("nan")),
            "converged": float(lm.qp_converged),
            "carry": float(carry_mismatches(ref, s, lm.selected))}


def carry_mismatches(ref: Reference, s: StepSample, selected) -> int:
    """Entries of the state handed to the next step that are not the
    reference's roll of this step's result: the prediction moved on one
    row, the applied input as the last input, and ``zt`` / its input the
    selected successors weighted by the multipliers (or, under the PID
    law, the state and input repeated). Copies compare exactly; the
    weighted sums within float32 rounding of 48 terms."""
    N = ref.N
    pid = s.rejects >= ref.fallback_after
    if pid:
        zt, zt_u = s.x0, s.u
        x_rows = np.repeat(s.x0[None], N, 0)
        u_rows = np.repeat(s.u[None], N - 1, 0)
        tol_zt = 0.0
    else:
        _, succ_x, succ_u, _ = selected
        zt = succ_x @ s.new_lam if s.rejects == 0 else s.zt
        zt_u = succ_u @ s.new_lam if s.rejects == 0 else s.new_zt_u
        x_rows, u_rows = s.new_x_pred[1:], s.new_u_pred[1:]
        mag = np.abs(succ_x) @ np.abs(s.new_lam)
        tol_zt = 64 * np.finfo(np.float32).eps * np.maximum(mag, 1.0)
    bad = int((s.new_x_lin[:N] != x_rows).sum())
    bad += int((s.new_u_lin[:N - 1] != u_rows).sum())
    bad += int((s.new_u_old != s.u).sum())
    if s.rejects == 0 or pid:
        bad += int((np.abs(s.new_zt - zt) > tol_zt).sum())
        bad += int((np.abs(s.new_x_lin[N] - zt) > tol_zt).sum())
        if not pid:
            mag_u = np.abs(succ_u) @ np.abs(s.new_lam)
            tol_u = 64 * np.finfo(np.float32).eps * np.maximum(mag_u, 1.0)
            bad += int((np.abs(s.new_zt_u - zt_u) > tol_u).sum())
            bad += int((np.abs(s.new_u_lin[N - 1] - zt_u) > tol_u).sum())
    return bad


def cost_to_go(ref: Reference, x: np.ndarray) -> np.ndarray:
    """The reference's backward DP (computeCost) over one lap's states."""
    lm = ref_controller.RefLMPC(ref.N, ref.dR, ref.q_slack,
                                ref.q_terminal_slack, ref.K, ref.num_ss_it,
                                None, ref.L)
    return lm.compute_cost(x)


class StartSample(NamedTuple):
    """One scenario's seeded state, as the window starts from it."""
    ss_x: np.ndarray        # (laps, rows, 6) float32, rows >= longest lap
    ss_u: np.ndarray        # (laps, rows, 2)
    qfun: np.ndarray        # (laps, rows)
    n_pts: np.ndarray       # (laps,)
    n_laps: int
    store_x: np.ndarray     # (model_laps, rows, 6)
    store_u: np.ndarray
    store_steps: np.ndarray  # (model_laps,)
    x_lin: np.ndarray       # (N+1, 6)
    u_lin: np.ndarray       # (N, 2)
    zt: np.ndarray
    u_old: np.ndarray
    time_step: int


def judge_start(ref: Reference, s: StartSample, seed_laps) -> int:
    """Entries of the seeded state that differ from the seed laps: each lap
    stored in turn with the reference's cost-to-go, the store holding the
    fastest ``usedIt`` of them, the first lap's rows 1..N+1 as the first
    linearization trajectory, zt = [0, 0, 0, 0, 10, 0], no last input."""
    bad = 0
    n = len(seed_laps)
    bad += int(s.n_laps != n)
    for i, (x, u, _, steps) in enumerate(seed_laps):
        bad += int(s.n_pts[i] != steps)
        bad += int((s.ss_x[i, :steps] != x[:steps]).sum())
        bad += int((s.ss_u[i, :steps] != u[:steps]).sum())
        q = cost_to_go(ref, np.asarray(x[:steps], float))
        bad += int((s.qfun[i, :steps] != q).sum())
    order = sorted(range(n), key=lambda i: seed_laps[i][3])[:ref.model_laps]
    want = sorted(seed_laps[i][3] for i in order)
    bad += int(sorted(int(v) for v in s.store_steps) != want)
    for j, st in enumerate(int(v) for v in s.store_steps):
        bad += int(not any(
            seed_laps[i][3] == st
            and (s.store_x[j, :st] == seed_laps[i][0][:st]).all()
            and (s.store_u[j, :st] == seed_laps[i][1][:st]).all()
            for i in order))
    x0, u0 = seed_laps[0][0], seed_laps[0][1]
    bad += int((s.x_lin != x0[1:ref.N + 2]).sum())
    bad += int((s.u_lin != u0[1:ref.N + 1]).sum())
    bad += int((s.zt != np.array([0, 0, 0, 0, 10.0, 0])).sum())
    bad += int((s.u_old != 0).sum()) + int(s.time_step != 0)
    return bad


class ClosureSample(NamedTuple):
    """One scenario's lap closure after an episode (float32 copies)."""
    xs: np.ndarray          # (steps, 6) the lap's states
    us: np.ndarray          # (steps, 2)
    prev_x: np.ndarray      # (rows, 6) the lap before (addPoint target)
    prev_u: np.ndarray
    prev_q: np.ndarray      # (rows,)
    prev_n: int
    new_x: np.ndarray       # (rows, 6) the new slot
    new_u: np.ndarray
    new_q: np.ndarray
    new_n: int
    new_time: int
    n_laps: int
    store_steps: np.ndarray  # (model_laps,)
    store_x: np.ndarray      # (model_laps, rows, 6)
    L32: float               # the track length as float32 holds it


def judge_closure(ref: Reference, c: ClosureSample, seed_laps) -> int:
    """Entries of one closure that differ from the reference's: the lap
    stored in the next slot with its cost-to-go, each of its states
    appended to the lap before with s + L (one float32 addition) and the
    cost-to-go counting down from that lap's last, the store's slowest
    lap replaced when the new one is strictly faster."""
    bad = 0
    steps = c.xs.shape[0]
    n0 = len(seed_laps[-1][0][:seed_laps[-1][3]])
    bad += int(c.n_laps != len(seed_laps) + 1)
    bad += int(c.new_n != steps) + int(c.new_time != steps)
    bad += int((c.new_x[:steps] != c.xs).sum())
    bad += int((c.new_u[:steps] != c.us).sum())
    q = cost_to_go(ref, c.xs.astype(float))
    bad += int((c.new_q[:steps] != q).sum())
    bad += int(c.prev_n != n0 + steps)
    app = c.xs.astype(np.float32).copy()
    app[:, 4] = app[:, 4] + np.float32(c.L32)
    bad += int((c.prev_x[n0:n0 + steps] != app).sum())
    bad += int((c.prev_u[n0:n0 + steps] != c.us).sum())
    q_prev = c.prev_q[n0 - 1] - np.arange(1, steps + 1)
    bad += int((c.prev_q[n0:n0 + steps] != q_prev).sum())
    old = sorted(int(s[3]) for s in seed_laps)[:ref.model_laps]
    want = sorted(old[:-1] + [steps]) if steps < old[-1] else old
    bad += int(sorted(int(v) for v in c.store_steps) != want)
    if steps < old[-1]:
        bad += int(not any((c.store_x[j, :steps] == c.xs).all()
                           for j, v in enumerate(c.store_steps)
                           if int(v) == steps))
    return bad


def summarize(step_gaps: List[Dict[str, float]]) -> Dict[str, Optional[float]]:
    """The compared numbers over the sample, with diagnostics."""
    def widest(key, rows):
        v = [r[key] for r in rows if not np.isnan(r[key])]
        return max(v) if v else None

    acc = [r for r in step_gaps if r["accepted"]]
    med = (float(np.median([r["input"] for r in acc])) if acc else None)
    return {"input_gap": widest("input", step_gaps),
            "plant_gap": widest("plant", step_gaps),
            "plant_gap.other_side": int(sum(r["other_side"]
                                            for r in step_gaps)),
            "pred_gap": widest("pred", acc),
            "input_gap_median_accepted": med,
            "accepted_in_sample": len(acc),
            "sampled": len(step_gaps),
            "reference_unconverged": sum(1 for r in step_gaps
                                         if not r["converged"]),
            "carry_mismatches": int(sum(r["carry"] for r in step_gaps))}


def verdict(numbers: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, checks): each compared number beside its limit, with the
    numbers named ``<name>.<note>`` beside it as ``<note>``. A number the
    run could not produce fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v if good or (
            v is not None and np.isfinite(v)) else None, "limit": limit}
        checks[name].update((k[len(name) + 1:], n) for k, n in
                            numbers.items() if k.startswith(name + "."))
    return ok, checks
