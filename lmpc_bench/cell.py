"""One run of a cell: set-up, the timed window of episodes, the record.

The window drives the port's lap path as a session does:
``runtime/experiment.run_lap_chunked`` over ``runtime/loop.run_lap``,
stepping ``LMPCController.step`` and ``loop.plant_step``, the lap closed by
``lmpc_add_trajectory``. Traffic is made of episodes: each starts from the
seeded state that set-up built (kept on the device), runs one lap from the
mix's start state in ``lap_chunk``-step pieces with the host exit, closes
the lap, and is then dropped, so the next starts from the seeded state
again. Every episode is the same kind of work; a faster program runs more
of them. The plant draws come from the mix's fixed pool of noise streams
(``noise_pool``): stream ``k`` is a generator seeded by
``experiment.stream_seed(noise_pool["seed"], LMPC, k)``. The window runs
the pool's streams in cycles, every stream once a cycle, each cycle in an
order drawn from ``--seed``: every seed gets the same work in another
order, since the draws set how long a step takes (the solver's
iterations, the Newton-Schulz syncs at batch 1).

:class:`Clock` wraps the controller call: it records a CUDA event at the
start of every call (the step boundaries, read after the window; no host
sync) and keeps references to the small state fields at the steps chosen
for the check, which the program never writes again.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from lmpc_bench import spec
from racinglmpc_tpu_torch.controllers import lmpc as lmpc_mod
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.config import VehicleParams

DTYPES = {"float32": torch.float32, "float64": torch.float64}
WARMUP_STREAM = 1 << 20      # episode index of the warm-up's noise streams
STEP_FIELDS = ("x_lin", "u_lin", "zt", "x_pred", "u_old", "time_step")
NEW_FIELDS = ("x_pred", "u_pred", "lam", "x_lin", "u_lin", "zt", "zt_u",
              "u_old", "rejects")


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


def setup(cell: spec.Cell, device, overrides: Optional[dict] = None,
          batch: Optional[int] = None) -> Setup:
    """Build the controller and the seeded state. ``overrides``: solver or
    plant fields for the control; ``batch``: a smaller batch for tests."""
    port = cell.config["port"]
    lcfg, solver, sim = spec.port_configs(cell.config, cell.traffic,
                                          overrides)
    dtype = DTYPES[port["dtype"]]
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


class Clock:
    """The controller call, wrapped (see the module's docstring)."""

    def __init__(self, step, timed: bool):
        self.step = step
        self.timed = timed
        self.marks: List[torch.cuda.Event] = []
        self.t = -1                      # the lap runner's step index
        self.want = frozenset()          # steps of this episode to keep
        self.kept: Dict[int, tuple] = {}
        self.draws: Dict[int, torch.Tensor] = {}
        self.calls = 0

    def mark(self) -> None:
        if self.timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)

    def __call__(self, st, x, draws):
        self.mark()
        new, u = self.step(st, x, draws)
        self.calls += 1
        if self.t in self.want:
            self.kept[self.t] = (tuple(getattr(st, f) for f in STEP_FIELDS),
                                 tuple(getattr(new, f) for f in NEW_FIELDS))
        return new, u

    def noise(self, S: Setup, stream: int):
        gen = torch.Generator(device=S.device)
        gen.manual_seed(exp.stream_seed(
            int(S.cell.traffic["noise_pool"]["seed"]), exp.LMPC, stream))
        base = loop.gaussian_noise(S.batch, 0, S.sim, gen, S.dtype, S.device)

        def draw(t):
            c, p = base(t)
            self.t = t
            if t in self.want:
                self.draws[t] = p
            return c, p
        return draw


def _collect(st: lmpc_mod.LMPCState):
    # per step: a rejected solve, and the solve's ADMM iterations
    return st.rejects > 0, st.iters


class Episode(NamedTuple):
    sr: Any                     # experiment.StageResult of the lap
    calls: int                  # batched steps run
    kept: Dict[int, tuple]      # step -> (fields before, fields after)
    draws: Dict[int, torch.Tensor]
    closure: Optional[tuple]    # the closed state's pieces, sampled lanes
    lanes: Optional[torch.Tensor]


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


def run_episode(S: Setup, clock: Clock, stream: int, want=frozenset(),
                lanes: Optional[torch.Tensor] = None) -> Episode:
    """One lap from the seeded state on noise stream ``stream``, closed;
    ``want``: the steps whose state the clock keeps; ``lanes``: scenarios
    whose closure is kept."""
    clock.want, clock.kept, clock.draws = frozenset(want), {}, {}
    calls0 = clock.calls
    noise = clock.noise(S, stream)

    def runner(st, plant, done, step0):
        return loop.run_lap(clock, st, plant, trk=S.trk, vp=S.vp,
                            sim_cfg=S.sim, max_steps=S.chunk, done0=done,
                            step0=step0, noise=noise, table=S.table,
                            collect_fn=_collect)

    sr, st = exp.run_lap_chunked(runner, S.state0, S.plant0, S.max_steps,
                                 S.chunk, S.max_steps)
    closed = lmpc_mod.lmpc_add_trajectory(st, S.lcfg, sr.x, sr.u, sr.x_glob,
                                          sr.steps, S.trk.total_len)
    pieces = closure_pieces(S, closed, lanes) if lanes is not None else None
    return Episode(sr=sr, calls=clock.calls - calls0, kept=clock.kept,
                   draws=clock.draws, closure=pieces, lanes=lanes)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Window(NamedTuple):
    episodes: List[Episode]
    streams: List[int]          # each episode's noise stream
    seconds: float              # host clock, sync to sync
    step_ms: np.ndarray         # every batched step's wall (device events)
    profiled: int               # episodes inside the profiler
    prof: Any                   # the torch.profiler session, or None
    prof_seconds: float         # host clock over the profiled episodes


def streams(seed: int, episodes: int, traffic: dict) -> List[int]:
    """Each episode's noise stream: the pool's streams in cycles, every
    stream once a cycle, each cycle in an order drawn from the seed."""
    pool = int(traffic["noise_pool"]["streams"])
    rng = np.random.default_rng([seed, 0x706F6F6C])
    cycles = -(-episodes // pool)
    return [int(k) for _ in range(cycles)
            for k in rng.permutation(pool)][:episodes]


def plan(seed: int, episodes: int, cell: spec.Cell, batch: int):
    """The steps whose state each episode keeps and the lanes whose
    closure it keeps, drawn from the seed before the window."""
    tr = cell.traffic
    rng = np.random.default_rng([seed, 0x6C6D7063])
    horizon = int(cell.limits["check"]["step_range"])
    k = int(tr["snapshot_steps"])
    steps = [frozenset(int(v) for v in rng.choice(horizon, k, replace=False))
             for _ in range(episodes)]
    nl = min(batch, int(cell.limits["check"]["closure_lanes"]))
    lanes = [np.sort(rng.choice(batch, nl, replace=False))
             for _ in range(episodes)]
    return steps, lanes


def window(S: Setup, seed: int, seconds: float, *, trace: bool = False,
           max_episodes: int = 256, breaker=None) -> Window:
    """Episodes until ``seconds`` have passed on the host clock (whole
    episodes: the last one started before the time ran out). With
    ``trace`` the first ``profiled_episodes`` run inside torch.profiler.
    ``breaker(clock, S)``: a test's hook that breaks the timed path."""
    cuda = S.device.type == "cuda"
    clock = Clock(S.ctrl.step, timed=cuda)
    if breaker is not None:
        breaker(clock, S)
    steps, lanes = plan(seed, max_episodes, S.cell, S.batch)
    order = streams(seed, max_episodes, S.cell.traffic)
    lanes = torch.as_tensor(np.stack(lanes), device=S.device)
    n_prof = int(S.cell.traffic["profiled_episodes"]) if trace else 0
    prof, prof_s = None, 0.0
    eps: List[Episode] = []
    sync(S.device)
    t0 = time.perf_counter()
    while len(eps) < max_episodes:
        e = len(eps)
        lane_t = lanes[e]
        if e == 0 and n_prof:
            prof = _profiler()
            prof.__enter__()
            tp = time.perf_counter()
        eps.append(run_episode(S, clock, order[e], steps[e], lane_t))
        if prof is not None and e == n_prof - 1:
            sync(S.device)
            prof_s = time.perf_counter() - tp
            prof.__exit__(None, None, None)
        if time.perf_counter() - t0 >= seconds and len(eps) >= max(n_prof, 1):
            break
    clock.mark()
    sync(S.device)
    wall = time.perf_counter() - t0
    if cuda:
        ms = np.array([a.elapsed_time(b) for a, b in
                       zip(clock.marks[:-1], clock.marks[1:])])
    else:
        ms = np.zeros(0)
    return Window(episodes=eps, streams=order[:len(eps)], seconds=wall, step_ms=ms, profiled=n_prof,
                  prof=prof, prof_seconds=prof_s)


def _profiler():
    # the device's activity only: kernels, copies and the CUDA runtime
    # calls; the host's ATen ops are not recorded
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def warm_up(S: Setup) -> None:
    """The cell's shapes, once: whole episodes with their closure and the
    kept lanes' pieces, on noise streams the window never draws (the same
    for every seed)."""
    clock = Clock(S.ctrl.step, timed=False)
    lanes = torch.arange(min(S.batch, int(S.cell.limits["check"][
        "closure_lanes"])), device=S.device)
    for k in range(int(S.cell.traffic["warmup_episodes"])):
        run_episode(S, clock, WARMUP_STREAM + k, frozenset({0}), lanes)
    sync(S.device)
