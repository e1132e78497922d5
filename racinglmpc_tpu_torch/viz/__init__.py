from racinglmpc_tpu_torch.viz.plots import (  # noqa: F401
    animate_states,
    animate_xy,
    plot_closed_loop,
    plot_lap_times,
    plot_track,
    plot_trajectory,
    pred_to_global,
)
