"""LQR path-tracking demo (CLI; capability of reference demo 1).

Counterpart of ``ilqr_tpu/apps/lqr_tracking.py``: tracks the reference's
spline course with the 5-state error-dynamics LQR controller
(scripts/1-lqr-pathtracking.py) over the whole episode, then renders the
course, trajectory, car and console HUD. Runs on the GPU unless
``--device cpu``; rendering needs matplotlib.

Usage: python -m ilqr_tpu_torch.apps.lqr_tracking [--save out.png] [--no-viz] [--animate]
    [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="LQR path tracking demo")
    parser.add_argument("--save", default=None)
    parser.add_argument("--no-viz", action="store_true")
    parser.add_argument("--animate", action="store_true",
                        help="per-tick animation instead of the final plot")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; raises without a GPU)")
    args = parser.parse_args(argv)

    from ilqr_tpu_torch.solvers.lqr_tracking import default_params, make_demo_course, simulate
    from ilqr_tpu_torch.types import entry_device

    device = entry_device(args.device)
    course, goal = make_demo_course(device=device)
    p = default_params(device=device)
    states, controls, reached = (a.cpu().numpy() for a in simulate(p, course, goal,
                                                                   max_ticks=5000))
    n = int(np.argmax(reached)) + 1 if reached.any() else len(controls)
    print(f"goal {'reached' if reached.any() else 'NOT reached'} after {n} ticks "
          f"({n * 0.1:.1f} s); final speed {states[n, 3] * 3.6:.1f} km/h")

    if args.no_viz:
        return 0
    import matplotlib
    if args.save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ilqr_tpu_torch.viz.render import (_steering_wheel_sprite, plot_tracking_console,
                                           plot_wire_car)

    cx, cy = course[0].cpu().numpy(), course[1].cpu().numpy()
    wheel = _steering_wheel_sprite()
    frames = range(0, n, 25) if args.animate else [n - 1]
    fig, ax = plt.subplots(figsize=(8, 8))
    for t in frames:
        # a tick's frame as the reference's animation loop draws it
        # (scripts/1-lqr-pathtracking.py:291-306): course, trajectory,
        # wireframe car at the commanded steering, console HUD, fixed view
        x, y, yaw = states[t + 1, 0], states[t + 1, 1], states[t + 1, 2]
        acc, steering = controls[t, 0], controls[t, 1]
        target_ind = int(np.argmin(np.hypot(cx - x, cy - y)))
        ax.cla()
        ax.plot(cx, cy, "-r", label="course")
        ax.plot(states[: t + 2, 0], states[: t + 2, 1], "-b", label="trajectory")
        plot_wire_car(ax, float(x), float(y), float(yaw), float(steering),
                      wheelbase=float(p.wheelbase))
        plot_tracking_console(ax, float(steering), float(acc), acc_max=float(p.max_acc),
                              wheel_sprite=wheel)
        ax.axis("equal")
        ax.grid(True)
        ax.set_xlim(-10, 38)
        ax.set_ylim(-15, 20)
        ax.legend(loc="lower left")
        ax.set_title(f"speed[km/h]: {states[t + 1, 3] * 3.6:.2f}, target index: {target_ind}")
        if args.animate and not args.save:
            plt.pause(0.01)
    if args.save:
        fig.savefig(args.save)
        print(f"saved {args.save}")
    elif not args.animate:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
