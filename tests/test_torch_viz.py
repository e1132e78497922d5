"""The port's plots (``viz/plots.py``), headless on the Agg backend;
mirrors ``tests/test_viz.py`` with tensors as inputs, and holds
``pred_to_global`` against the JAX package's on the same archive."""
import os

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from racinglmpc_tpu.models import track as jtrack  # noqa: E402
from racinglmpc_tpu.viz import plots as jplots  # noqa: E402
from racinglmpc_tpu_torch.models import track as ttrack  # noqa: E402
from racinglmpc_tpu_torch.viz import (  # noqa: E402
    animate_states, animate_xy, plot_closed_loop, plot_lap_times,
    plot_trajectory, pred_to_global)

torch.set_num_threads(1)


def _fake_lap(T=50):
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.1, size=(T, 6))
    x[:, 0] += 0.8
    u = rng.normal(scale=0.1, size=(T, 2))
    xg = x.copy()
    xg[:, 4] = np.linspace(0, 2.0, T)
    xg[:, 5] = 0.1 * np.sin(np.linspace(0, 6, T))
    return torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(xg)


@pytest.fixture(scope="module")
def trk():
    return ttrack.make_track(device="cpu")


def test_track_and_trajectory_plots(trk):
    _, _, xg = _fake_lap()
    ax = plot_trajectory(trk, xg, mask=torch.ones(50, dtype=torch.bool),
                         label="lap")
    assert len(ax.lines) >= 4  # 3 track lines + trajectory


def test_closed_loop_panels():
    x, u, _ = _fake_lap()
    fig = plot_closed_loop(x, u)
    assert len(fig.axes) == 7


def test_lap_times_plot():
    ax = plot_lap_times(torch.tensor([[20.0, 16.0, 14.0],
                                      [21.0, 17.0, 15.0]]))
    assert len(ax.lines) == 2


def test_animation_gif(trk, tmp_path):
    _, _, xg = _fake_lap(T=12)
    gif = str(tmp_path / "lap.gif")
    animate_xy(trk, xg, gif_path=gif, stride=4)
    assert os.path.getsize(gif) > 0


def test_animate_states_gif(trk, tmp_path):
    x, u, xg = _fake_lap(T=12)
    x_pred = x[:, None, :].repeat(1, 5, 1)
    u_pred = u[:, None, :].repeat(1, 4, 1)
    gif = str(tmp_path / "states.gif")
    anim = animate_states(trk, x, u, xg, x_pred_archive=x_pred,
                          u_pred_archive=u_pred, gif_path=gif, stride=4)
    assert anim is not None
    assert os.path.getsize(gif) > 0


def test_pred_to_global_matches_reference():
    rng = np.random.default_rng(3)
    arch = np.zeros((7, 5, 6))
    arch[..., 4] = rng.uniform(0.0, 19.0, size=(7, 5))
    arch[..., 5] = rng.uniform(-0.4, 0.4, size=(7, 5))
    got = pred_to_global(ttrack.make_track(dtype=torch.float64, device="cpu"),
                         torch.from_numpy(arch))
    want = jplots.pred_to_global(jtrack.make_track(dtype=jnp.float64), arch)
    assert got.shape == (7, 5, 2)
    np.testing.assert_allclose(got, want, atol=1e-12)
