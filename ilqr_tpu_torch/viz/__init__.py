"""Rendering (numpy + matplotlib on the host): counterpart of ``ilqr_tpu/viz``."""

from ilqr_tpu_torch.viz.render import (
    imread_mat,
    make_car_sprite,
    plot_vehicle,
    plot_obstacle_boundary,
    render_frame,
    animate_episode,
)

__all__ = [
    "imread_mat",
    "make_car_sprite",
    "plot_vehicle",
    "plot_obstacle_boundary",
    "render_frame",
    "animate_episode",
]
