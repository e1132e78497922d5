"""Host-side matplotlib visualization (port of
``racinglmpc_tpu/viz/plots.py``).

The reference's plotting surface: :func:`plot_track` / :func:`plot_trajectory`
(track outline and one XY trajectory), :func:`plot_closed_loop` (the 7-panel
state / input time series), :func:`plot_lap_times` (the LMPC learning
curve), :func:`pred_to_global` (a predicted-trajectory archive as XY
polylines) and :func:`animate_xy` / :func:`animate_states` (playback over a
lap, optionally saved as a GIF).

Every function takes tensors (on any device) or numpy arrays of one
scenario and moves them to numpy at its entry; matplotlib is imported
inside the functions, so importing this module needs none. Figures are
returned, never shown, so they work headless.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from racinglmpc_tpu_torch.models import track as track_mod


def _np(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _track_lines(trk, n: int = 600):
    """Centerline and both lane edges as XY polylines."""
    L = float(trk.total_len)
    s = torch.as_tensor(np.linspace(0.0, L - 1e-6, n),
                        dtype=trk.total_len.dtype, device=trk.total_len.device)
    hw = float(trk.half_width)
    out = []
    for ey in (0.0, hw, -hw):
        xs, ys = track_mod.global_position(trk, s, torch.full_like(s, ey))
        out.append((_np(xs), _np(ys)))
    return out


def plot_track(trk, ax=None):
    """Draw the track: dashed centerline, solid lane edges."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 7))
    (cx, cy), (ux, uy), (lx, ly) = _track_lines(trk)
    ax.plot(cx, cy, "k--", linewidth=0.8)
    ax.plot(ux, uy, "k-", linewidth=1.2)
    ax.plot(lx, ly, "k-", linewidth=1.2)
    ax.set_aspect("equal")
    ax.set_xlabel("X [m]")
    ax.set_ylabel("Y [m]")
    return ax


def plot_trajectory(trk, x_glob, mask=None, ax=None, label=None,
                    color="tab:red"):
    """Track + one closed-loop XY trajectory."""
    ax = plot_track(trk, ax=ax)
    x_glob = _np(x_glob)
    if mask is not None:
        x_glob = x_glob[_np(mask)]
    ax.plot(x_glob[:, 4], x_glob[:, 5], "-", color=color, linewidth=1.0,
            label=label)
    if label:
        ax.legend()
    return ax


def plot_closed_loop(x, u, mask=None, dt: float = 0.1, fig=None):
    """7-panel state/input time series: vx, vy, wz, epsi, ey + steering,
    accel vs time."""
    import matplotlib.pyplot as plt

    x = _np(x)
    u = _np(u)
    if mask is not None:
        m = _np(mask)
        x, u = x[m], u[m]
    t = np.arange(x.shape[0]) * dt
    names = ["$v_x$ [m/s]", "$v_y$ [m/s]", "$\\omega_z$ [rad/s]",
             "$e_\\psi$ [rad]", "$e_y$ [m]"]
    cols = [0, 1, 2, 3, 5]
    if fig is None:
        fig, axes = plt.subplots(7, 1, figsize=(8, 12), sharex=True)
    else:
        axes = fig.subplots(7, 1, sharex=True)
    for ax, name, c in zip(axes[:5], names, cols):
        ax.plot(t, x[:, c], "-o", markersize=2)
        ax.set_ylabel(name)
    axes[5].plot(t[: u.shape[0]], u[:, 0], "-o", markersize=2)
    axes[5].set_ylabel("$\\delta$ [rad]")
    axes[6].plot(t[: u.shape[0]], u[:, 1], "-o", markersize=2)
    axes[6].set_ylabel("$a$ [m/s$^2$]")
    axes[6].set_xlabel("t [s]")
    return fig


def plot_lap_times(lap_times, dt_is_seconds=True, ax=None):
    """LMPC learning curve: per-iteration lap time, one line a scenario."""
    import matplotlib.pyplot as plt

    lt = np.atleast_2d(_np(lap_times))
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    for i in range(lt.shape[0]):
        ax.plot(np.arange(lt.shape[1]), lt[i], "-o", markersize=3,
                alpha=0.8, label=f"scenario {i}" if lt.shape[0] > 1 else None)
    ax.set_xlabel("LMPC iteration")
    ax.set_ylabel("lap time [s]")
    ax.grid(alpha=0.3)
    if lt.shape[0] > 1:
        ax.legend(fontsize=7)
    return ax


def pred_to_global(trk, x_pred_archive):
    """Convert a per-step predicted-trajectory archive (T, N+1, 6) of
    curvilinear states into XY polylines (T, N+1, 2) for
    :func:`animate_xy`'s ``pred_glob``."""
    arr = torch.as_tensor(_np(x_pred_archive), dtype=trk.total_len.dtype,
                          device=trk.total_len.device)
    xs, ys = track_mod.global_position(trk, arr[..., 4], arr[..., 5])
    return np.stack([_np(xs), _np(ys)], axis=-1)


def animate_xy(trk, x_glob, mask=None, pred_glob: Optional[Sequence] = None,
               gif_path: Optional[str] = None, stride: int = 2, fps: int = 10):
    """Car + (optional) predicted-trajectory playback on the track. Saves a
    GIF when ``gif_path`` is given; returns the matplotlib
    FuncAnimation."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    x_glob = _np(x_glob)
    if mask is not None:
        x_glob = x_glob[_np(mask)]
    frames = range(0, x_glob.shape[0], stride)

    fig, ax = plt.subplots(figsize=(7, 7))
    plot_track(trk, ax=ax)
    trail, = ax.plot([], [], "-", color="tab:red", linewidth=1.0)
    car, = ax.plot([], [], "o", color="tab:blue", markersize=6)
    pred_line, = ax.plot([], [], "-*", color="tab:green", markersize=3)

    def update(i):
        trail.set_data(x_glob[: i + 1, 4], x_glob[: i + 1, 5])
        car.set_data([x_glob[i, 4]], [x_glob[i, 5]])
        if pred_glob is not None and i < len(pred_glob):
            p = _np(pred_glob[i])
            pred_line.set_data(p[:, 0], p[:, 1])
        return trail, car, pred_line

    anim = FuncAnimation(fig, update, frames=frames, blit=True)
    if gif_path is not None:
        anim.save(gif_path, writer=PillowWriter(fps=fps))
    return anim


def animate_states(trk, x, u, x_glob, mask=None,
                   x_pred_archive=None, u_pred_archive=None,
                   dt: float = 0.1, gif_path: Optional[str] = None,
                   stride: int = 2, fps: int = 10):
    """Animated per-state panels + XY view over one lap.

    Layout: the closed-loop time series of the 5 tracked states and 2
    inputs with a moving cursor, the per-step *predicted* horizon overlaid
    when archives are given ((T, N+1, 6) states, (T, N, 2) inputs, e.g. the
    controller state's ``x_pred`` / ``u_pred`` collected each step), and the
    XY track view with the car.

    Returns the FuncAnimation; saves a GIF when ``gif_path`` is given.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    x = _np(x)
    u = _np(u)
    x_glob = _np(x_glob)
    if mask is not None:
        m = _np(mask)
        x, u, x_glob = x[m], u[m], x_glob[m]
        if x_pred_archive is not None:
            x_pred_archive = _np(x_pred_archive)[m]
        if u_pred_archive is not None:
            u_pred_archive = _np(u_pred_archive)[m]
    T = x.shape[0]
    t = np.arange(T) * dt

    fig = plt.figure(figsize=(14, 9))
    gs = fig.add_gridspec(4, 4)
    panels = [  # (grid cell, source, column, label)
        (gs[0, 0], "x", 0, "$v_x$ [m/s]"),
        (gs[0, 1], "x", 1, "$v_y$ [m/s]"),
        (gs[1, 0], "x", 2, "$\\omega_z$ [rad/s]"),
        (gs[1, 1], "x", 3, "$e_\\psi$ [rad]"),
        (gs[2, 0], "x", 5, "$e_y$ [m]"),
        (gs[2, 1], "u", 0, "$\\delta$ [rad]"),
        (gs[3, 0], "u", 1, "$a$ [m/s$^2$]"),
    ]
    cursors, preds = [], []
    for cell, src, col, label in panels:
        ax = fig.add_subplot(cell)
        series = x[:, col] if src == "x" else u[:, col]
        ax.plot(t[: series.shape[0]], series, "-", color="0.6", linewidth=1)
        cur, = ax.plot([], [], "o", color="tab:blue", markersize=5)
        pl, = ax.plot([], [], "-*", color="tab:green", markersize=3)
        ax.set_ylabel(label, fontsize=8)
        cursors.append((cur, src, col))
        preds.append((pl, src, col))
    ax_xy = fig.add_subplot(gs[:, 2:])
    plot_track(trk, ax=ax_xy)
    trail, = ax_xy.plot([], [], "-", color="tab:red", linewidth=1.0)
    car, = ax_xy.plot([], [], "o", color="tab:blue", markersize=6)

    def update(i):
        artists = []
        for cur, src, col in cursors:
            series = x[:, col] if src == "x" else u[:, col]
            j = min(i, series.shape[0] - 1)
            cur.set_data([t[j]], [series[j]])
            artists.append(cur)
        for pl, src, col in preds:
            arch = x_pred_archive if src == "x" else u_pred_archive
            if arch is not None and i < len(arch):
                horizon = _np(arch[i])[:, col]
                pl.set_data(t[i] + dt * np.arange(horizon.shape[0]), horizon)
            artists.append(pl)
        trail.set_data(x_glob[: i + 1, 4], x_glob[: i + 1, 5])
        car.set_data([x_glob[i, 4]], [x_glob[i, 5]])
        artists += [trail, car]
        return artists

    anim = FuncAnimation(fig, update, frames=range(0, T, stride), blit=True)
    if gif_path is not None:
        anim.save(gif_path, writer=PillowWriter(fps=fps))
    return anim
