"""The LMPC stage: the upstream experiment's learning controller, one lap
an episode from a seeded safe set.

The window drives the port's lap path as the experiment's LMPC stage does:
``runtime/experiment.run_lap_chunked`` over ``runtime/loop.run_lap``,
stepping ``LMPCController.step`` and ``loop.plant_step``, the lap closed by
``lmpc_add_trajectory``. Each episode starts from the seeded state that
set-up built (kept on the device), runs one lap from the mix's start state
in ``lap_chunk``-step pieces with the host exit, closes the lap, and is
then dropped, so the next starts from the seeded state again. Every
episode is the same kind of work; a faster program runs more of them. The
plant draws come from the mix's pool of noise streams on the experiment's
LMPC stage index.

The configuration file holds the controller's settings under the upstream
project's names (``upstream``) and the port's batch, lap runner, preset
and buffer sizes (``port``); :func:`port_configs` hands them to the port's
configs by name. The judge holds a sample of the window's steps, the
seeded start and each sampled lane's lap closure to the float64 reference
(``judge.py`` over ``reference/ref_controller.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from lmpc_bench import cell as cell_mod
from lmpc_bench import judge as judge_mod
from lmpc_bench import spec
from lmpc_bench.reference import track as ref_track
from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.config import VehicleParams

STEP_FIELDS = ("x_lin", "u_lin", "zt", "x_pred", "u_old", "time_step")
NEW_FIELDS = ("x_pred", "u_pred", "lam", "x_lin", "u_lin", "zt", "zt_u",
              "u_old", "rejects")
keep_fields = (STEP_FIELDS, NEW_FIELDS)


def port_configs(config: dict, traffic: dict, overrides: dict = None):
    """(LMPCConfig, SolverConfig, SimConfig) of a configuration under a
    mix. ``overrides`` replaces fields of the solver (``{"solver": {...}}``)
    or of the plant (``{"sim": {...}}``), for the control."""
    from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                                   SolverConfig)
    up, port = config["upstream"], config["port"]
    overrides = overrides or {}
    lmpc = LMPCConfig(
        N=up["N"], num_ss_it=up["numSS_it"], num_ss_points=up["numSS_Points"],
        dR=tuple(up["dR_LMPC"]), q_slack=tuple(up["Qslack"]),
        q_terminal_slack=up["QterminalSlack"], ey_max=up["halfWidth"],
        delta_max=up["inputConstr"][0], a_max=up["inputConstr"][1],
        fallback_vt=up["vt"], kernel_h=up["sysid"]["h"],
        knn_max=up["sysid"]["MaxNumPoint"],
        model_laps=up["sysid"]["usedIt"], **port["lmpc"])
    preset = port["solver"]["preset"]
    solver = dataclasses.replace(getattr(SolverConfig, preset)(),
                                 **port["solver"].get("replace", {}),
                                 **overrides.get("solver", {}))
    noise = traffic["noise"]
    sim = SimConfig(dt=up["dt"], noise=True,
                    noise_sigma=tuple(noise["sigma"]),
                    noise_clip=noise["clip"], noise_gain=noise["gain"],
                    **port["sim"], **overrides.get("sim", {}))
    return lmpc, solver, sim


def seed_laps(traffic: dict, root=spec.ROOT) -> List[tuple]:
    """The mix's seed laps as numpy (x (T, 6), u (T, 2), x_glob (T, 6),
    steps), in the order they are stored. Layout "laps": the arrays
    ``x{i}``, ``u{i}``, ``xg{i}``, ``steps{i}`` for i < ``n_laps``; layout
    "lap": one lap ``xs``, ``us`` (its states stand for ``x_glob``). Each
    lap is stored ``copies`` times."""
    sl = traffic["seed_laps"]
    f = np.load(root / sl["file"])
    if sl["layout"] == "laps":
        laps = [(f[f"x{i}"], f[f"u{i}"], f[f"xg{i}"], int(f[f"steps{i}"]))
                for i in range(int(f["n_laps"]))]
    elif sl["layout"] == "lap":
        xs = f["xs"].astype(np.float32)
        laps = [(xs, f["us"].astype(np.float32), xs, len(xs))]
    else:
        raise ValueError(f"unknown seed-lap layout {sl['layout']!r}")
    return [lap for lap in laps for _ in range(int(sl.get("copies", 1)))]


class Setup(NamedTuple):
    cell: spec.Cell
    lcfg: Any
    solver: Any
    sim: Any
    dtype: torch.dtype
    device: torch.device
    batch: int
    chunk: int
    max_steps: int
    trk: Any
    table: Any
    vp: VehicleParams
    ctrl: lmpc_mod.LMPCController
    state0: lmpc_mod.LMPCState
    plant0: PlantState
    laps: List[tuple]

    @property
    def step(self):
        """The controller call the clock wraps."""
        return self.ctrl.step


def setup(cell: spec.Cell, device, overrides: Optional[dict] = None,
          batch: Optional[int] = None) -> Setup:
    """Build the controller and the seeded state. ``overrides``: solver or
    plant fields for the control; ``batch``: a smaller batch for tests."""
    port = cell.config["port"]
    lcfg, solver, sim = port_configs(cell.config, cell.traffic, overrides)
    dtype = cell_mod.DTYPES[port["dtype"]]
    device = torch.device(device)
    B = int(batch or port["batch"])
    trk = make_track(dtype=dtype, device=device)
    ctrl = lmpc_mod.make_lmpc(lcfg, trk, solver, sim.dt, dtype=dtype)
    state = lmpc_mod.init_lmpc_state(lcfg, B, dtype=dtype, solver=solver,
                                     device=device)
    laps = seed_laps(cell.traffic)
    for x, u, xg, n in laps:
        t = [torch.as_tensor(a, dtype=dtype, device=device)[None].expand(
            B, -1, -1) for a in (x, u, xg)]
        steps = torch.full((B,), n, dtype=torch.int32, device=device)
        state = lmpc_mod.lmpc_add_trajectory(state, lcfg, *t, steps,
                                             trk.total_len)
    x0 = torch.tensor(cell.traffic["x0"], dtype=dtype,
                      device=device).repeat(B, 1)
    return Setup(cell=cell, lcfg=lcfg, solver=solver, sim=sim, dtype=dtype,
                 device=device, batch=B, chunk=int(port["lap_chunk"]),
                 max_steps=int(port["lap_max_steps"]), trk=trk,
                 table=track_table(trk), vp=VehicleParams(), ctrl=ctrl,
                 state0=state, plant0=PlantState(x=x0, x_glob=x0.clone()),
                 laps=laps)


def collect(st: lmpc_mod.LMPCState):
    # per step: a rejected solve, and the solve's ADMM iterations
    return st.rejects > 0, st.iters


def closure_pieces(S: Setup, closed: lmpc_mod.LMPCState,
                   lanes: torch.Tensor) -> tuple:
    """The sampled lanes' part of a closed state: the lap before the new
    one and the new slot (rows, cost-to-go, counts) and the store."""
    n = len(S.laps)
    ss, st = closed.ss, closed.store
    rows = min(ss.x.shape[2], max(n for *_, n in S.laps) + S.max_steps + 1)
    pick = [ss.x[lanes, n - 1:n + 1, :rows], ss.u[lanes, n - 1:n + 1, :rows],
            ss.qfun[lanes, n - 1:n + 1, :rows], ss.n_pts[lanes, n - 1:n + 1],
            ss.lap_time[lanes, n], ss.n_laps[lanes], st.steps[lanes],
            st.x[lanes, :, :S.max_steps]]
    return tuple(pick)


def run_episode(S: Setup, clock: cell_mod.Clock, stream: int,
                want=frozenset(),
                lanes: Optional[torch.Tensor] = None) -> cell_mod.Episode:
    """One lap from the seeded state on noise stream ``stream``, closed;
    ``want``: the steps whose state the clock keeps; ``lanes``: scenarios
    whose closure is kept."""
    clock.want, clock.kept, clock.draws = frozenset(want), {}, {}
    calls0 = clock.calls
    noise = clock.noise(S, stream, exp.LMPC)

    def runner(st, plant, done, step0):
        return loop.run_lap(clock, st, plant, trk=S.trk, vp=S.vp,
                            sim_cfg=S.sim, max_steps=S.chunk, done0=done,
                            step0=step0, noise=noise, table=S.table,
                            collect_fn=collect)

    sr, st = exp.run_lap_chunked(runner, S.state0, S.plant0, S.max_steps,
                                 S.chunk, S.max_steps)
    closed = lmpc_mod.lmpc_add_trajectory(st, S.lcfg, sr.x, sr.u, sr.x_glob,
                                          sr.steps, S.trk.total_len)
    pieces = closure_pieces(S, closed, lanes) if lanes is not None else None
    return cell_mod.Episode(sr=sr, calls=clock.calls - calls0,
                            kept=clock.kept, draws=clock.draws,
                            closure=pieces, lanes=lanes)


def _cpu(t):
    return t.detach().cpu().numpy()


def work(S: Setup, win) -> dict:
    """Counts the roofline functions read, over the profiled episodes."""
    eps = win.episodes[:win.profiled]
    steps = sum(ep.calls for ep in eps)
    ce = S.solver.check_every
    its = [ep.sr.collected[1][:, :ep.calls].long() for ep in eps]
    engaged_b2 = S.ctrl.use_kernel_sysid
    engaged_b3 = loop.use_kernel_rollout(S.sim, S.vp)
    store_steps = [int(v) for v in _cpu(S.state0.store.steps[0])
                   if v < 2**30]
    return {
        "admm": {"N": S.lcfg.N, "K": S.lcfg.num_ss_points,
                 "refine_steps": S.solver.kkt_refine_steps,
                 "check_every": ce, "lanes": steps * S.batch,
                 "iters": sum(int(i.sum()) for i in its),
                 "checks": sum(int((1 + (i + ce - 1) // ce).sum())
                               for i in its)},
        "sysid": {"launches": steps if engaged_b2 else 0, "batch": S.batch,
                  "N": S.lcfg.N, "knn": S.lcfg.knn_max,
                  "lap_rows": store_steps},
        "rollout": {"launches": steps if engaged_b3 else 0,
                    "batch": S.batch, "substeps": S.sim.substeps}}


def step_samples(S: Setup, win, seed: int, count: int):
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
    out = []
    host = {}
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
        before, after = (tuple(_cpu(f[b]) for f in grp)
                         for grp in ep.kept[t])
        f64 = [np.asarray(v, float) for v in before]
        a64 = [np.asarray(v, float) for v in after]
        nxt = (h["x"][b, t + 1] if t + 1 < h["steps"][b]
               else h["final"][b])
        out.append(judge_mod.StepSample(
            xs=h["x"][b, :t], us=h["u"][b, :t], x0=h["x"][b, t],
            xg0=h["x_glob"][b, t], u=h["u"][b, t], x_next=nxt,
            draw=_cpu(ep.draws[t][b]).astype(float),
            x_lin=f64[0], u_lin=f64[1], zt=f64[2], x_pred=f64[3],
            u_old=f64[4], time_step=int(before[5]),
            rejects=int(after[8]), new_x_pred=a64[0], new_u_pred=a64[1],
            new_lam=a64[2], new_x_lin=a64[3], new_u_lin=a64[4],
            new_zt=a64[5], new_zt_u=a64[6], new_u_old=a64[7]))
    return out


def start_samples(S: Setup, lanes) -> list:
    st = S.state0
    n = len(S.laps)
    rows = max(k for *_, k in S.laps)
    out = []
    for b in lanes:
        out.append(judge_mod.StartSample(
            ss_x=_cpu(st.ss.x[b, :n, :rows]), ss_u=_cpu(st.ss.u[b, :n, :rows]),
            qfun=_cpu(st.ss.qfun[b, :n, :rows]), n_pts=_cpu(st.ss.n_pts[b, :n]),
            n_laps=int(st.ss.n_laps[b]), store_x=_cpu(st.store.x[b, :, :rows]),
            store_u=_cpu(st.store.u[b, :, :rows]),
            store_steps=[v for v in _cpu(st.store.steps[b]) if v < 2**30],
            x_lin=_cpu(st.x_lin[b]), u_lin=_cpu(st.u_lin[b]),
            zt=_cpu(st.zt[b]), u_old=_cpu(st.u_old[b]),
            time_step=int(st.time_step[b])))
    return out


def closure_samples(S: Setup, win, L32: float) -> list:
    out = []
    for ep in win.episodes:
        pieces = [_cpu(p) for p in ep.closure]
        x, u, q, n_pts, lap_time, n_laps, st_steps, st_x = pieces
        steps = _cpu(ep.sr.steps)
        for j, b in enumerate(_cpu(ep.lanes)):
            k = int(steps[b])
            out.append(judge_mod.ClosureSample(
                xs=_cpu(ep.sr.x[b, :k]), us=_cpu(ep.sr.u[b, :k]),
                prev_x=x[j, 0], prev_u=u[j, 0], prev_q=q[j, 0],
                prev_n=int(n_pts[j, 0]), new_x=x[j, 1], new_u=u[j, 1],
                new_q=q[j, 1], new_n=int(n_pts[j, 1]),
                new_time=int(lap_time[j]), n_laps=int(n_laps[j]),
                store_steps=st_steps[j], store_x=st_x[j], L32=L32))
    return out


def judge(S: Setup, win, seed: int, limits: dict) -> dict:
    """The sampled steps, the first episode's lanes' start and every
    episode's kept closures against the float64 reference."""
    chk = limits["check"]
    samples = step_samples(S, win, seed, int(chk["samples"]))
    starts = start_samples(S, _cpu(win.episodes[0].lanes))
    L32 = float(np.float32(ref_track.table().total_len))
    closures = closure_samples(S, win, L32)
    # host copies taken: the window's tensors are freed before the
    # reference runs
    cell_mod.release(win, S.device)

    ref = judge_mod.reference(S.cell.config, S.cell.traffic, S.laps)
    gaps = [judge_mod.judge_step(ref, s) for s in samples]
    numbers = judge_mod.summarize(gaps)
    numbers["mismatches"] = (
        numbers.pop("carry_mismatches")
        + sum(judge_mod.judge_start(ref, s, S.laps) for s in starts)
        + sum(judge_mod.judge_closure(ref, s, S.laps) for s in closures))
    numbers["gaps"] = [[r["input"], r["plant"], r["accepted"]]
                       for r in gaps]
    return numbers
