"""One run of a cell: set-up, the timed window of episodes, the record.

What an episode is belongs to the cell's controller stage
(``stages/<name>.py``, found by the name its configuration gives): the
stage builds the controller and the seeded state, and runs one episode
from that state, a lap closed or a fixed number of steps. What stays here
is the same for every stage. Traffic is made of episodes, each from the
seeded state that set-up built, so every episode is the same kind of work
and a faster program runs more of them. The plant draws come from the
mix's fixed pool of noise streams (``noise_pool``): stream ``k`` is a
generator seeded by ``experiment.stream_seed(noise_pool["seed"], stage,
k)``, ``stage`` the experiment's index of the controller stage. The window
runs the pool's streams in cycles, every stream once a cycle, each cycle
in an order drawn from ``--seed``: every seed gets the same work in
another order, since the draws set how long a step takes (the solver's
iterations, the Newton-Schulz syncs at batch 1).

:class:`Clock` wraps the controller call: it records a CUDA event at the
start of every call (the step boundaries, read after the window; no host
sync) and keeps references to the stage's small state fields at the steps
chosen for the check, which the program never writes again.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from lmpc_bench import spec, stages
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop

DTYPES = {"float32": torch.float32, "float64": torch.float64}
WARMUP_STREAM = 1 << 20      # episode index of the warm-up's noise streams


def stage(cell: spec.Cell):
    """The cell's controller stage, ``stages/<name>.py``."""
    return stages.load(cell.stage)


def setup(cell: spec.Cell, device, overrides: Optional[dict] = None,
          batch: Optional[int] = None):
    """The stage's set-up: the controller and the seeded state.
    ``overrides``: solver or plant fields for the control; ``batch``: a
    smaller batch for tests."""
    return stage(cell).setup(cell, device, overrides, batch)


class Clock:
    """The controller call, wrapped (see the module's docstring). ``keep``:
    the state fields kept before and after a step (the stage's
    ``keep_fields``)."""

    def __init__(self, step, timed: bool, keep):
        self.step = step
        self.timed = timed
        self.before, self.after = keep
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
            self.kept[self.t] = (tuple(getattr(st, f) for f in self.before),
                                 tuple(getattr(new, f) for f in self.after))
        return new, u

    def noise(self, S, stream: int, stage_index: int):
        """The plant draws of the pool's stream ``stream`` on the
        experiment's stage index ``stage_index``."""
        gen = torch.Generator(device=S.device)
        gen.manual_seed(exp.stream_seed(
            int(S.cell.traffic["noise_pool"]["seed"]), stage_index, stream))
        base = loop.gaussian_noise(S.batch, 0, S.sim, gen, S.dtype, S.device)

        def draw(t):
            c, p = base(t)
            self.t = t
            if t in self.want:
                self.draws[t] = p
            return c, p
        return draw


class Episode(NamedTuple):
    sr: Any                     # the lap runner's result (mask, steps, ...)
    calls: int                  # batched steps run
    kept: Dict[int, tuple]      # step -> (fields before, fields after)
    draws: Dict[int, torch.Tensor]
    closure: Optional[tuple]    # the stage's end-of-episode pieces, sampled
    lanes: Optional[torch.Tensor]


def release(win, device) -> None:
    """Drop the window's episodes, and with them their device tensors,
    once the judge holds host copies."""
    win.episodes.clear()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


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


def window(S, seed: int, seconds: float, *, trace: bool = False,
           max_episodes: int = 256, breaker=None) -> Window:
    """Episodes until ``seconds`` have passed on the host clock (whole
    episodes: the last one started before the time ran out). With
    ``trace`` the first ``profiled_episodes`` run inside torch.profiler.
    ``breaker(clock, S)``: a test's hook that breaks the timed path."""
    cuda = S.device.type == "cuda"
    st = stage(S.cell)
    clk = Clock(S.step, cuda, st.keep_fields)
    if breaker is not None:
        breaker(clk, S)
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
        eps.append(st.run_episode(S, clk, order[e], steps[e], lane_t))
        if prof is not None and e == n_prof - 1:
            sync(S.device)
            prof_s = time.perf_counter() - tp
            prof.__exit__(None, None, None)
        if time.perf_counter() - t0 >= seconds and len(eps) >= max(n_prof, 1):
            break
    clk.mark()
    sync(S.device)
    wall = time.perf_counter() - t0
    if cuda:
        ms = np.array([a.elapsed_time(b) for a, b in
                       zip(clk.marks[:-1], clk.marks[1:])])
    else:
        ms = np.zeros(0)
    return Window(episodes=eps, streams=order[:len(eps)], seconds=wall, step_ms=ms, profiled=n_prof,
                  prof=prof, prof_seconds=prof_s)


def _profiler():
    # the device's activity only: kernels, copies and the CUDA runtime
    # calls; the host's ATen ops are not recorded
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def warm_up(S) -> None:
    """The cell's shapes, once: whole episodes with their closure and the
    kept lanes' pieces, on noise streams the window never draws (the same
    for every seed)."""
    st = stage(S.cell)
    clk = Clock(S.step, False, st.keep_fields)
    lanes = torch.arange(min(S.batch, int(S.cell.limits["check"][
        "closure_lanes"])), device=S.device)
    for k in range(int(S.cell.traffic["warmup_episodes"])):
        st.run_episode(S, clk, WARMUP_STREAM + k, frozenset({0}), lanes)
    sync(S.device)
