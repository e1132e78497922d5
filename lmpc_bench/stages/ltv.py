"""The LTV stage: the upstream experiment's third lap, LTV-MPC over a
sys-ID store seeded by the PID lap, a fixed number of steps an episode.

The window drives the port's lap path as the experiment's LTV stage does:
``runtime/loop.run_lap(..., multi_lap=True)`` stepping
``MPCController.__call__`` (``controllers/mpc.make_ltv_mpc``: at every step
the plain local regression at the N points of the linearization
trajectory, the FTOCP, one QP solve, the roll) and ``loop.plant_step``.
Each episode starts from the seeded state that set-up built (kept on the
device), runs the mix's ``episode_steps`` steps from its start state and
is then dropped, so the next starts from the seeded state again. The
plant draws come from the mix's pool of noise streams on the experiment's
LTV stage index.

The configuration file holds the controller's settings under the upstream
project's names (``upstream``) and the port's batch, preset and buffer
sizes (``port``); :func:`port_configs` hands them to the port's configs by
name. The judge holds a sample of the window's steps, the seeded start of
the first episode's sampled lanes, and each sampled step's carry to the
float64 reference ``reference/ref_ltv_torch.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from lmpc_bench import cell as cell_mod
from lmpc_bench import judge as judge_mod
from lmpc_bench import spec
from lmpc_bench.reference import ref_ltv_torch
from lmpc_bench.reference import ref_plant
from lmpc_bench.reference import track as ref_track
from lmpc_bench.stages.lmpc import seed_laps
from racinglmpc_tpu_torch.controllers import mpc as mpc_mod
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop, tracing
from racinglmpc_tpu_torch.utils.config import VehicleParams

STEP_FIELDS = ("x_lin", "u_lin", "u_old")
NEW_FIELDS = ("x_pred", "u_pred", "x_lin", "u_lin", "u_old", "rejected")
keep_fields = (STEP_FIELDS, NEW_FIELDS)
# the state fields this stage reads, which a port without the LTV step's
# solve information lacks
NEEDS = ("iters", "rejected", "ns_iters", "warm")


def port_configs(config: dict, traffic: dict, overrides: dict = None):
    """(MPCConfig, LMPCConfig, SolverConfig, SimConfig) of a configuration
    under a mix. ``overrides`` replaces fields of the solver
    (``{"solver": {...}}``) or of the plant (``{"sim": {...}}``)."""
    from racinglmpc_tpu_torch.utils.config import (LMPCConfig, MPCConfig,
                                                   SimConfig, SolverConfig)
    up, port = config["upstream"], config["port"]
    overrides = overrides or {}
    bx, bu = up["bx"], up["bu"]
    if bx[0] != bx[1] or bu[0] != bu[1] or bu[2] != bu[3]:
        raise ValueError("the port's MPC takes symmetric bounds only")
    mpc = MPCConfig(N=up["N"], vt=up["vt"], Q=tuple(up["Q"]),
                    R=tuple(up["R"]), dR=tuple(up["dR"]), Qf=tuple(up["Qf"]),
                    q_slack=tuple(up["Qslack"]), ey_max=bx[0],
                    delta_max=bu[0], a_max=bu[2], time_varying=True)
    sid = up["sysid"]
    lmpc = LMPCConfig(N=up["N"], kernel_h=sid["h"],
                      knn_max=sid["MaxNumPoint"], model_laps=sid["usedIt"],
                      **port["lmpc"])
    s = dict(port["solver"], **overrides.get("solver", {}))
    solver = dataclasses.replace(getattr(SolverConfig, s.pop("preset"))(),
                                 **s)
    noise = traffic["noise"]
    sim = SimConfig(dt=up["dt"], noise=True,
                    noise_sigma=tuple(noise["sigma"]),
                    noise_clip=noise["clip"], noise_gain=noise["gain"],
                    **port["sim"], **overrides.get("sim", {}))
    return mpc, lmpc, solver, sim


class Setup(NamedTuple):
    cell: spec.Cell
    mcfg: Any
    lcfg: Any
    solver: Any
    sim: Any
    dtype: torch.dtype
    device: torch.device
    batch: int
    steps: int
    trk: Any
    table: Any
    vp: VehicleParams
    ctrl: mpc_mod.MPCController
    state0: mpc_mod.MPCState
    plant0: PlantState
    laps: List[tuple]

    @property
    def step(self):
        """The controller call the clock wraps."""
        return self.ctrl


def setup(cell: spec.Cell, device, overrides: Optional[dict] = None,
          batch: Optional[int] = None) -> Setup:
    """Build the controller and the seeded state: the mix's seed laps in
    the sys-ID store of every scenario. ``overrides``: solver or plant
    fields for the control; ``batch``: a smaller batch for tests."""
    missing = [f for f in NEEDS if f not in mpc_mod.MPCState._fields]
    if missing:
        raise RuntimeError(
            "this port's LTV-MPC state lacks the per-step solve information "
            f"{missing} (controllers/mpc.MPCState) that the ltv stage reads")
    port = cell.config["port"]
    mcfg, lcfg, solver, sim = port_configs(cell.config, cell.traffic,
                                           overrides)
    dtype = cell_mod.DTYPES[port["dtype"]]
    device = torch.device(device)
    B = int(batch or port["batch"])
    trk = make_track(dtype=dtype, device=device)
    laps = seed_laps(cell.traffic)
    store = sysid.make_lap_store(B, lcfg.model_laps, lcfg.model_pts,
                                 dtype=dtype, device=device)
    for x, u, _, n in laps:
        store = sysid.add_lap(
            store, *(torch.as_tensor(a, dtype=dtype, device=device)[None]
                     .expand(B, -1, -1) for a in (x, u)),
            torch.full((B,), n, dtype=torch.int32, device=device))
    ctrl, state = mpc_mod.make_ltv_mpc(mcfg, store, trk, lcfg, solver,
                                       sim.dt, dtype=dtype)
    x0 = torch.tensor(cell.traffic["x0"], dtype=dtype,
                      device=device).repeat(B, 1)
    return Setup(cell=cell, mcfg=mcfg, lcfg=lcfg, solver=solver, sim=sim,
                 dtype=dtype, device=device, batch=B,
                 steps=int(cell.traffic["episode_steps"]), trk=trk,
                 table=track_table(trk), vp=VehicleParams(), ctrl=ctrl,
                 state0=state, plant0=PlantState(x=x0, x_glob=x0.clone()),
                 laps=laps)


def collect(st: mpc_mod.MPCState):
    # per step: a rejected solve, and the solve's ADMM iterations
    return st.rejected, st.iters


def _collect_all(st: mpc_mod.MPCState):
    # collect's two, and B4's per-lane counts with the warm inverse the
    # next solve is handed (fac.valid: where its warm test runs)
    return collect(st) + (st.ns_iters, st.warm, st.fac.valid)


class Run(NamedTuple):
    """An episode's lap-runner result, as the harness reads it
    (``mask``, ``steps``, ``collected``), with B4's per-step counts."""
    x: torch.Tensor          # (B, T, 6)
    u: torch.Tensor          # (B, T, 2)
    x_glob: torch.Tensor
    mask: torch.Tensor       # (B, T) bool
    steps: torch.Tensor      # (B,) int32
    plant_final: PlantState
    collected: tuple         # (rejected, iterations), each (B, T)
    fused: tuple             # (ns_iters, warm, warm_next), each (B, T)


def run_episode(S: Setup, clock: cell_mod.Clock, stream: int,
                want=frozenset(),
                lanes: Optional[torch.Tensor] = None) -> cell_mod.Episode:
    """``S.steps`` steps from the seeded state on noise stream
    ``stream``; ``want``: the steps whose state the clock keeps;
    ``lanes``: scenarios whose seeded start the judge checks."""
    clock.want, clock.kept, clock.draws = frozenset(want), {}, {}
    calls0 = clock.calls
    noise = clock.noise(S, stream, exp.LTV)
    tracing.new_episode()
    sr = loop.run_lap(clock, S.state0, S.plant0, trk=S.trk, vp=S.vp,
                      sim_cfg=S.sim, max_steps=S.steps, multi_lap=True,
                      noise=noise, table=S.table, collect_fn=_collect_all)
    rej, its, ns, warm, valid = sr.collected
    run = Run(x=sr.x, u=sr.u, x_glob=sr.x_glob, mask=sr.mask,
              steps=sr.steps, plant_final=sr.plant_final,
              collected=(rej, its), fused=(ns, warm, valid))
    return cell_mod.Episode(sr=run, calls=clock.calls - calls0,
                            kept=clock.kept, draws=clock.draws, closure=None,
                            lanes=lanes)


def _cpu(t):
    return t.detach().cpu().numpy()


def fused_counts(S: Setup, eps) -> dict:
    """B4's lanes, warm lanes, Newton-Schulz lane-iterations and warm
    tests (lanes handed a warm inverse) over ``eps``' steps."""
    out = dict.fromkeys(("lanes", "warm_lanes", "ns_lane_iters",
                         "warm_tests"), 0)
    valid0 = int(S.state0.fac.valid.sum())
    for ep in eps:
        ns, warm, valid = (t[:, :ep.calls] for t in ep.sr.fused)
        out["lanes"] += ep.calls * S.batch
        out["warm_lanes"] += int(warm.sum())
        out["ns_lane_iters"] += int(ns.long().sum())
        out["warm_tests"] += valid0 + int(valid[:, :-1].sum())
    return out


def work(S: Setup, win) -> dict:
    """Counts the roofline functions and the ``fused.*`` readers read:
    B4's over the profiled episodes, and over the whole window."""
    sc = S.solver
    if not (sc.pallas_fused_ns and sc.use_pallas and not sc.kkt_structured):
        return {}
    d = S.ctrl.dims
    up = S.cell.config["upstream"]
    prof = fused_counts(S, win.episodes[:win.profiled])
    prof.update(n=d.nz, m=d.mi + d.me, N=S.mcfg.N, Q=up["Q"], R=up["R"],
                dR=up["dR"], Qf=up["Qf"], Qslack=up["Qslack"],
                window=fused_counts(S, win.episodes))
    return {"fused": prof}


# ---- the judge -------------------------------------------------------------

class StepSample(NamedTuple):
    """One scenario's step as the program ran it (float64 copies); the
    plant's fields are those ``judge.plant_next`` reads."""
    x0: np.ndarray        # (6,) the state the step acted on
    xg0: np.ndarray       # (6,)
    u: np.ndarray         # (2,) the applied input
    x_next: np.ndarray    # (6,) the plant's next state
    draw: np.ndarray      # (3,) the step's standard-normal plant draw
    x_lin: np.ndarray     # (N+1, 6) carried state before the step
    u_lin: np.ndarray     # (N, 2)
    u_old: np.ndarray     # (2,)
    new_x_pred: np.ndarray  # (N+1, 6) the state after the step
    new_u_pred: np.ndarray  # (N, 2)
    new_x_lin: np.ndarray
    new_u_lin: np.ndarray
    new_u_old: np.ndarray
    rejected: bool


def step_samples(S: Setup, win, seed: int, count: int) -> List[StepSample]:
    """A sample, drawn from the seed, of the window's live scenario-steps
    among those whose state the clock kept: host copies for the judge."""
    cand = []
    for e, ep in enumerate(win.episodes):
        steps = _cpu(ep.sr.steps)
        for t in sorted(ep.kept):
            for b in np.flatnonzero(steps > t):
                cand.append((e, t, int(b)))
    rng = np.random.default_rng([seed, 0x6A756467])
    pick = sorted(rng.choice(len(cand), min(count, len(cand)),
                             replace=False)) if cand else []
    out, host = [], {}
    for i in pick:
        e, t, b = cand[i]
        ep = win.episodes[e]
        if e not in host:
            sr = ep.sr
            host[e] = {k: _cpu(getattr(sr, k)).astype(float)
                       for k in ("x", "u", "x_glob")}
            host[e]["final"] = _cpu(sr.plant_final.x).astype(float)
            host[e]["steps"] = _cpu(sr.steps)
        h = host[e]
        before, after = ([np.asarray(_cpu(f[b]), float) for f in grp]
                         for grp in ep.kept[t])
        nxt = (h["x"][b, t + 1] if t + 1 < h["steps"][b]
               else h["final"][b])
        out.append(StepSample(
            x0=h["x"][b, t], xg0=h["x_glob"][b, t], u=h["u"][b, t],
            x_next=nxt, draw=_cpu(ep.draws[t][b]).astype(float),
            x_lin=before[0], u_lin=before[1], u_old=before[2],
            new_x_pred=after[0], new_u_pred=after[1], new_x_lin=after[2],
            new_u_lin=after[3], new_u_old=after[4],
            rejected=bool(after[5])))
    return out


def carry_mismatches(s: StepSample, bounds: np.ndarray) -> int:
    """Entries of the state handed to the next step that are not the
    program's own roll of its prediction: x_lin and u_lin the prediction
    moved on one row (its last row repeated), the applied input the
    prediction's first input clipped to the box, u_old that input, and a
    rejected solve's inputs the last input held. Copies and a clip
    compare exactly."""
    bad = int((s.new_x_lin != np.concatenate(
        [s.new_x_pred[1:], s.new_x_pred[-1:]])).sum())
    bad += int((s.new_u_lin != np.concatenate(
        [s.new_u_pred[1:], s.new_u_pred[-1:]])).sum())
    bad += int((s.u != np.clip(s.new_u_pred[0], -bounds, bounds)).sum())
    bad += int((s.new_u_old != s.u).sum())
    if s.rejected:
        bad += int((s.new_u_pred != s.u_old[None]).sum())
    return bad


def start_mismatches(S: Setup, lanes) -> int:
    """Entries of the sampled lanes' seeded state and start plant that
    differ from the mix: the store holding the seed laps (their steps,
    rows and nothing beyond), the first linearization trajectory the
    first lap's rows 0..N, no last input, the start state x0."""
    st, N, store = S.state0, S.mcfg.N, S.ctrl.store
    x_lap, u_lap, _, n = S.laps[0]
    x0 = np.asarray(S.cell.traffic["x0"], np.float32)
    bad = 0
    for b in lanes:
        steps = [int(v) for v in _cpu(store.steps[b])]
        bad += int(sorted(steps) != sorted(lap[3] for lap in
                                           S.laps[:S.lcfg.model_laps]))
        sx, su = _cpu(store.x[b, 0]), _cpu(store.u[b, 0])
        bad += int((sx[:n] != x_lap[:n]).sum()) + int((sx[n:] != 0).sum())
        bad += int((su[:n] != u_lap[:n]).sum()) + int((su[n:] != 0).sum())
        bad += int((_cpu(st.x_lin[b]) != x_lap[:N + 1]).sum())
        bad += int((_cpu(st.u_lin[b]) != u_lap[:N]).sum())
        bad += int((_cpu(st.u_old[b]) != 0).sum())
        bad += int((_cpu(S.plant0.x[b]) != x0).sum())
    return bad


def reference(S: Setup):
    """The reference's settings, track and store (the seed laps as the
    program stores them), and the plant's reference for ``plant_next``."""
    up, tr = S.cell.config["upstream"], S.cell.traffic
    tb = ref_track.table()
    st = ref_ltv_torch.settings(up)
    trk = ref_ltv_torch.track(tb.s0, tb.curv, tb.total_len)
    laps = sorted(S.laps, key=lambda lap: lap[3])[:st.used_it]
    laps = [(np.asarray(x[:n], float), np.asarray(u[:n], float))
            for x, u, _, n in laps]
    noise = tr["noise"]
    plant = judge_mod.Reference(
        N=st.N, K=0, num_ss_it=0, dR=np.asarray(up["dR"], float),
        q_slack=tuple(up["Qslack"]), q_terminal_slack=0.0,
        ey_max=float(up["bx"][0]), delta_max=float(up["bu"][0]),
        a_max=float(up["bu"][2]), dt=st.dt, h=st.h, knn=st.max_pts,
        model_laps=st.used_it, fallback_after=0,
        sigma=np.asarray(noise["sigma"], float), clip=float(noise["clip"]),
        gain=float(noise["gain"]), laps=laps,
        curv=ref_plant.np_curvature_fn(tb), L=tb.total_len,
        jumps=tuple((float(tb.s0[i]), float(tb.curv[i - 1]),
                     float(tb.curv[i])) for i in range(1, len(tb.s0))
                    if tb.curv[i] != tb.curv[i - 1]))
    return st, trk, laps, plant


def judge_step(st, trk, laps, plant, s: StepSample,
               bounds: np.ndarray) -> dict:
    """Gaps of one sampled step: ``input`` (the applied input against the
    reference's step from the program's carried state), ``plant``,
    ``other_side``, ``pred`` (the accepted solve's prediction, a
    diagnostic), ``converged`` and ``carry``."""
    x_next, other = judge_mod.plant_next(plant, s)
    carry = float(carry_mismatches(s, bounds))
    try:
        r = ref_ltv_torch.step(st, laps, trk, s.x0, s.x_lin, s.u_lin,
                               s.u_old)
    except RuntimeError:
        # a singular regression or KKT system: the upstream controller has
        # no answer here, so the program's answer cannot be right
        return {"accepted": float(not s.rejected), "input": float("inf"),
                "plant": float(np.abs(s.x_next - x_next).max()),
                "other_side": float(other), "pred": float("nan"),
                "converged": 0.0, "carry": carry}
    return {"accepted": float(not s.rejected),
            "input": float(np.abs(s.u - r.u.numpy()).max()),
            "plant": float(np.abs(s.x_next - x_next).max()),
            "other_side": float(other),
            "pred": (float("nan") if s.rejected else
                     float(np.abs(s.new_x_pred - r.x_pred.numpy()).max())),
            "converged": float(r.converged), "carry": carry}


def judge(S: Setup, win, seed: int, limits: dict) -> dict:
    """The sampled steps and the first episode's sampled lanes' start
    against the float64 reference."""
    chk = limits["check"]
    samples = step_samples(S, win, seed, int(chk["samples"]))
    lanes = _cpu(win.episodes[0].lanes)
    # host copies taken: the window's tensors are freed before the
    # reference runs
    cell_mod.release(win, S.device)
    st, trk, laps, plant = reference(S)
    bounds = np.asarray([S.mcfg.delta_max, S.mcfg.a_max], np.float32)
    gaps = [judge_step(st, trk, laps, plant, s, bounds) for s in samples]
    numbers = judge_mod.summarize(gaps)
    numbers["mismatches"] = (numbers.pop("carry_mismatches")
                             + start_mismatches(S, lanes))
    numbers["gaps"] = [[r["input"], r["plant"], r["accepted"]]
                       for r in gaps]
    return numbers
