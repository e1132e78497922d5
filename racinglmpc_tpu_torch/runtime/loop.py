"""Closed-loop lap runner (port of ``racinglmpc_tpu/runtime/loop.py``).

Per control step: the controller acts on the latest state, the plant
advances one period, and (unless ``multi_lap``) a scenario is done once its
new arc length exceeds the track length. Done scenarios are frozen by a
mask (a ``multi_lap`` run from a fresh start freezes nothing: none is
ever done); the trajectory excludes the crossing state, which is returned
with its arc length reduced by one track length. ``done0``/``step0``
resume a lap in chunks: noise is drawn by the global step index, so a
chunked run equals one long run. ``collect_fn`` archives a value of each
step's new controller state (the reference's predicted-trajectory store).

A controller is ``step(ctrl_state, x (B, 6), draws) -> (ctrl_state, u)``;
``noise(t)`` returns ``(controller draws, plant draws (B, 3))`` for global
step t, either of which may be None.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from racinglmpc_tpu_torch.models import dynamics
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import Track, TrackTable, track_table
from racinglmpc_tpu_torch.ops import cuda_rollout
from racinglmpc_tpu_torch.runtime import tracing
from racinglmpc_tpu_torch.utils.config import SimConfig, VehicleParams
from racinglmpc_tpu_torch.utils.batched import bwhere, tree_map

Noise = Callable[[int], tuple]


class LapResult(NamedTuple):
    x: torch.Tensor        # (B, T, 6) states (row t valid iff mask[t])
    u: torch.Tensor        # (B, T, 2) applied inputs
    x_glob: torch.Tensor   # (B, T, 6)
    mask: torch.Tensor     # (B, T) bool
    steps: torch.Tensor    # (B,) int32
    x_final: PlantState    # crossing state, s reduced by L
    ctrl_state: Any
    plant_final: PlantState  # raw plant state (chunk resumption)
    done: torch.Tensor     # (B,) bool
    collected: Any = None  # collect_fn's leaves stacked to (B, T, ...)


def gaussian_noise(batch: int, ctrl_dims: int, sim_cfg: SimConfig,
                   generator: torch.Generator, dtype=torch.float32,
                   device="cuda", ctrl_noise: bool = True,
                   rows: Optional[slice] = None) -> Noise:
    """Standard-normal draws from ``generator``, one call per step, for the
    whole ``batch``; ``rows`` keeps those scenarios' rows (a rank of a
    scenario mesh draws what the unsharded run draws and keeps its own)."""
    def randn(cols):
        t = torch.randn((batch, cols), generator=generator, dtype=dtype,
                        device=device)
        return t if rows is None else t[rows]

    def draw(_t):
        c = randn(ctrl_dims) if ctrl_noise and ctrl_dims else None
        p = randn(3) if sim_cfg.noise else None
        return c, p

    return draw


def scalar_vp(vp: VehicleParams) -> bool:
    """Every field a Python number or a 0-dim tensor: one vehicle for the
    whole batch, which is all the rollout kernel takes."""
    return all(not torch.is_tensor(v) or v.dim() == 0 for v in vp)


def use_kernel_rollout(sim_cfg: SimConfig, vp: VehicleParams) -> bool:
    """Engagement rule of the rollout kernel: asked for by the config, and
    scalar vehicle parameters (a batched ``vp`` takes the plain plant step,
    as the reference's fused rollout engages for scalar params only)."""
    return sim_cfg.use_pallas_rollout and scalar_vp(vp)


@tracing.traced("lap.plant")
def plant_step(plant: PlantState, u, vp: VehicleParams, trk: Track,
               sim_cfg: SimConfig, draws, table: TrackTable) -> PlantState:
    """One period for the batch: the rollout kernel where
    :func:`use_kernel_rollout` engages it (its plain version on CPU
    tensors), then the noise."""
    if use_kernel_rollout(sim_cfg, vp):
        nx, nxg = cuda_rollout.plant_step_batch(plant.x, plant.x_glob, u, vp,
                                                trk, sim_cfg, table=table)
        return PlantState(x=dynamics.apply_noise(nx, draws, sim_cfg),
                          x_glob=nxg)
    return dynamics.plant_step(plant, u, vp, trk, sim_cfg, draws)


def run_lap(controller_step, ctrl_state, plant: PlantState, *, trk: Track,
            vp: VehicleParams, sim_cfg: SimConfig, max_steps: int,
            multi_lap: bool = False, done0: Optional[torch.Tensor] = None,
            step0: int = 0, noise: Optional[Noise] = None,
            table: Optional[TrackTable] = None,
            collect_fn: Optional[Callable[[Any], Any]] = None) -> LapResult:
    """Run one batched closed-loop lap (or ``max_steps`` steps when
    ``multi_lap``).

    ``collect_fn(ctrl_state)`` is called on each step's new controller
    state, before done scenarios are frozen (reference ``loop.py:101``),
    e.g. ``lambda st: (st.x_pred, st.u_pred)``; each leaf of its result
    (a tensor, or tuples, NamedTuples and lists of them) is stacked on a
    time axis after the batch axis into ``LapResult.collected``."""
    L = trk.total_len
    B = plant.x.shape[0]
    table = table if table is not None else track_table(trk)
    done = (torch.zeros((B,), dtype=torch.bool, device=plant.x.device)
            if done0 is None else done0)
    # multi-lap from a fresh start: no scenario is ever done, none frozen
    freeze = not multi_lap or done0 is not None
    xs, us, xgs, masks, extras = [], [], [], [], []
    for t in range(step0, step0 + max_steps):
        tracing.at_step(t)
        with tracing.span("lap.noise"):
            c_draw, p_draw = noise(t) if noise is not None else (None, None)
        new_ctrl, u = controller_step(ctrl_state, plant.x, c_draw)
        new_plant = plant_step(plant, u, vp, trk, sim_cfg, p_draw, table)
        with tracing.span("lap.freeze"):
            if collect_fn is not None:
                extras.append(collect_fn(new_ctrl))
            xs.append(plant.x)
            us.append(u)
            xgs.append(plant.x_glob)
            masks.append(~done)
            if freeze:
                ctrl_state = bwhere(done, ctrl_state, new_ctrl)
                plant = bwhere(done, plant, new_plant)
            else:
                ctrl_state, plant = new_ctrl, new_plant
            if not multi_lap:
                done = done | (new_plant.x[:, 4] > L)

    with tracing.span("lap.freeze"):
        mask = torch.stack(masks, 1)
        shift = torch.zeros_like(plant.x)
        shift[:, 4] = L
        return LapResult(
            x=torch.stack(xs, 1), u=torch.stack(us, 1),
            x_glob=torch.stack(xgs, 1), mask=mask,
            steps=mask.sum(1).to(torch.int32),
            x_final=PlantState(x=plant.x - shift, x_glob=plant.x_glob),
            ctrl_state=ctrl_state, plant_final=plant, done=done,
            collected=(tree_map(lambda *ts: torch.stack(ts, 1), *extras)
                       if extras else None))
