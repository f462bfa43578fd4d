"""Matplotlib rendering: vehicles, obstacle boundaries, HUD.

Counterpart of ``ilqr_tpu/viz/render.py``, the host-side equivalent of
the reference's embedded-CPython plotting (src/utils.cpp:117-260,
src/motion_planning.cpp:180-270, and scripts/utils/imshow.py):

- :func:`imread_mat` reads the reference's "Convert from PNG" text sprite
  format (header line, then "rows cols colors", then float rows);
- :func:`make_car_sprite` procedurally draws a top-down car RGBA sprite so
  the package ships standalone (no binary assets);
- :func:`plot_vehicle` blits a sprite rotated around the vehicle center
  (scripts/utils/imshow.py:5-16 semantics), shifting rear-center states to
  the footprint center (src/utils.cpp:158-170);
- :func:`render_frame` draws one MPC tick: lane lines, planned-trajectory
  ribbon, vehicles, ellipse boundaries, steering-wheel + pedal-bar HUD;
- the demo-1 wireframe car and console, the demo-2 replay.

numpy and matplotlib on the host; nothing here touches a device.
matplotlib is imported inside the functions, so the package imports where
it is not installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib
    if matplotlib.get_backend().lower() not in ("agg",) and not _has_display():
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _has_display() -> bool:
    import os
    return bool(os.environ.get("DISPLAY"))


def imread_mat(path: str) -> np.ndarray:
    """Read the reference's text sprite format (src/utils.cpp:117-145):
    line 1 'Convert from PNG', line 2 'rows cols colors', then floats."""
    with open(path) as f:
        header = f.readline().strip()
        if header != "Convert from PNG":
            raise ValueError(f"unsupported sprite format: {header!r}")
        rows, cols, colors = (int(v) for v in f.readline().split())
        data = np.loadtxt(f, dtype=np.float32)
    return data.reshape(rows, cols, colors)


def make_car_sprite(body_rgb=(0.2, 0.75, 0.8), px: int = 64) -> np.ndarray:
    """Procedural top-down car sprite, RGBA (h, w, 4), nose facing +x."""
    h, w = px // 2, px
    img = np.zeros((h, w, 4), dtype=np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = w / 2.0, h / 2.0
    # rounded-rectangle body via superellipse
    bx = np.abs((xx - cx) / (0.48 * w)) ** 4 + np.abs((yy - cy) / (0.42 * h)) ** 4
    body = bx < 1.0
    img[body, :3] = body_rgb
    img[body, 3] = 1.0
    # windshield (front third) and rear window, darker
    wind = (bx < 0.55) & (xx > cx + 0.08 * w) & (xx < cx + 0.3 * w)
    rear = (bx < 0.55) & (xx < cx - 0.12 * w) & (xx > cx - 0.3 * w)
    img[wind | rear, :3] = np.asarray(body_rgb, np.float32) * 0.35
    # wheels
    for wx in (0.25 * w, 0.75 * w):
        for wy in (0.12 * h, 0.88 * h):
            wheel = (np.abs(xx - wx) < 0.07 * w) & (np.abs(yy - wy) < 0.1 * h)
            img[wheel, :3] = 0.1
            img[wheel, 3] = 1.0
    return img


def plot_vehicle(ax, sprite: np.ndarray, state, length: float, width: float,
                 ref_point: str = "gravity_center", wheelbase: float = 0.0):
    """Blit sprite at state [x, y, yaw] (or [x, y, v, yaw]) rotated around
    the footprint center."""
    from matplotlib.transforms import Affine2D

    state = np.asarray(state, dtype=float)
    if state.shape[-1] == 4:
        x, y, yaw = state[0], state[1], state[3]
    else:
        x, y, yaw = state[0], state[1], state[2]
    if ref_point == "rear_center":
        x += 0.5 * wheelbase * np.cos(yaw)
        y += 0.5 * wheelbase * np.sin(yaw)
    tr = Affine2D().rotate_deg_around(x, y, np.degrees(yaw)) + ax.transData
    extent = [x - length / 2, x + length / 2,
              y - width / 2 - 0.15, y + width / 2 + 0.15]
    ax.imshow(sprite, transform=tr, extent=extent, zorder=10.0, clip_on=True)


def plot_obstacle_boundary(ax, ego_state, obstacle_states, width, length,
                           d_safe, wheelbase, ref_point="gravity_center"):
    """Ego front/rear safety discs + inflated obstacle ellipses
    (src/utils.cpp:172-213)."""
    from ilqr_tpu_torch.ops.constraints import ellipsoid_scales

    yaw = ego_state[3]
    whba = wheelbase * np.array([np.cos(yaw), np.sin(yaw)])
    pos = np.asarray(ego_state[:2], float)
    if ref_point == "rear_center":
        front, rear = pos + whba, pos
    else:
        front, rear = pos + 0.5 * whba, pos - 0.5 * whba
    t = np.linspace(0, 2 * np.pi, 300)
    radius = 0.5 * width
    for c in (front, rear):
        ax.plot(c[0] + radius * np.cos(t), c[1] + radius * np.sin(t),
                color="red", zorder=12)
    a, b = ellipsoid_scales(width, length, d_safe, 0.0)
    for obs in np.atleast_2d(obstacle_states):
        th = obs[2]
        ex = a * np.cos(t)
        ey = b * np.sin(t)
        ax.plot(obs[0] + ex * np.cos(th) - ey * np.sin(th),
                obs[1] + ex * np.sin(th) + ey * np.cos(th), "-r")


def _steering_wheel_sprite(px: int = 96) -> np.ndarray:
    img = np.zeros((px, px, 4), dtype=np.float32)
    yy, xx = np.mgrid[0:px, 0:px].astype(np.float32)
    r = np.hypot(xx - px / 2, yy - px / 2) / (px / 2)
    rim = (r < 0.98) & (r > 0.78)
    hub = r < 0.18
    ang = np.arctan2(yy - px / 2, xx - px / 2)
    spokes = (r < 0.8) & (
        (np.abs(ang) < 0.12) | (np.abs(ang - np.pi) < 0.12)
        | (np.abs(ang + np.pi) < 0.12) | (np.abs(ang + np.pi / 2) < 0.12)
    )
    mask = rim | hub | spokes
    img[mask, :3] = 0.15
    img[mask, 3] = 1.0
    return img


def render_frame(ax, setup, ego_state, planned_x, control, tick: int,
                 sprites=None, show_obstacle_boundary: Optional[bool] = None,
                 show_reference_line: Optional[bool] = None):
    """One MPC tick frame (reference src/motion_planning.cpp:182-269)."""
    from matplotlib.transforms import Affine2D

    gc = setup.gc
    plt = _plt()
    ax.cla()
    sprites = sprites or {}
    ego_sprite = sprites.get("ego")
    agent_sprite = sprites.get("agent")
    wheel = sprites.get("wheel")
    if ego_sprite is None:
        ego_sprite = make_car_sprite((0.2, 0.75, 0.8))
    if agent_sprite is None:
        agent_sprite = make_car_sprite((0.85, 0.85, 0.85))
    if wheel is None:
        wheel = _steering_wheel_sprite()

    for i, b in enumerate(setup.borders):
        style = dict(color="k", linewidth=2) if i in (0, len(setup.borders) - 1) \
            else dict(color="k", linewidth=1)
        ax.plot(b.x, b.y, **style)
    for c in setup.center_lines:
        ax.plot(c.x, c.y, "--k", linewidth=0.8)

    # planned trajectory ribbon (reference src/motion_planning.cpp:199-201)
    from ilqr_tpu_torch.utils.geometry import get_boundary, get_closed_curve

    width = gc["vehicle/width"]
    length = gc["vehicle/length"]
    curve = get_closed_curve(get_boundary(np.asarray(planned_x), width * 0.7))
    ax.fill(curve[0], curve[1], color="cyan", alpha=0.7)

    ref_point = gc["vehicle/reference_point"]
    wb = gc["vehicle/wheelbase"]
    plot_vehicle(ax, ego_sprite, ego_state, length, width, ref_point, wb)
    for rl in setup.obs_routing_lines:
        if tick < len(rl):
            plot_vehicle(ax, agent_sprite, rl[tick], length, width, ref_point, 0.0)

    if show_obstacle_boundary is None:
        show_obstacle_boundary = gc.get("visualization/show_obstacle_boundary", False)
    if show_obstacle_boundary and setup.num_obstacles:
        from ilqr_tpu_torch.utils.refline import get_cur_obstacle_states

        obs_states = get_cur_obstacle_states(setup.routing_lines, tick)
        plot_obstacle_boundary(ax, np.asarray(ego_state), obs_states, width,
                               length, gc["vehicle/d_safe"], wb, ref_point)
    if show_reference_line is None:
        show_reference_line = gc.get("visualization/show_reference_line", False)
    if show_reference_line:
        ax.plot(setup.center_lines[0].x, setup.center_lines[0].y, "-r", linewidth=0.8)

    # view window + HUD (src/motion_planning.cpp:220-265)
    x_min, y_min = ego_state[0] - 10, ego_state[1] - 5
    x_max, y_max = ego_state[0] + 30, ego_state[1] + 15
    if gc.has_key("visualization/x_lim"):
        x_min, x_max = gc["visualization/x_lim"]
    if gc.has_key("visualization/y_lim"):
        y_min, y_max = gc["visualization/y_lim"]

    steer_size = 5.0
    acc_cmd, steer_cmd = float(control[0]), float(control[1])
    wx, wy = x_min + steer_size / 1.5, y_max - steer_size / 1.5
    tr = Affine2D().rotate_deg_around(wx, wy, np.degrees(steer_cmd * 2.5)) + ax.transData
    ax.imshow(wheel, transform=tr, zorder=11, clip_on=True,
              extent=[wx - steer_size / 2, wx + steer_size / 2,
                      wy - steer_size / 2, wy + steer_size / 2])
    acc = max(acc_cmd, 0.0)
    brake = max(-acc_cmd, 0.0)
    acc_max = gc["vehicle/acc_max"]
    bar_bottom, bar_left = y_max - steer_size, x_min + steer_size * 1.3
    ax.fill([bar_left, bar_left + 1, bar_left + 1, bar_left],
            [bar_bottom, bar_bottom, bar_bottom + steer_size * acc / acc_max,
             bar_bottom + steer_size * acc / acc_max], color="red")
    ax.fill([bar_left + 2, bar_left + 3, bar_left + 3, bar_left + 2],
            [bar_bottom, bar_bottom, bar_bottom + steer_size * brake / acc_max,
             bar_bottom + steer_size * brake / acc_max], color="gray")
    tx, ty = bar_left + 4.5, y_max - 1.5
    ax.text(tx, ty, f"x = {ego_state[0]:.2f} m")
    ax.text(tx, ty - 1.5, f"y = {ego_state[1]:.2f} m")
    ax.text(tx, ty - 3.0, f"v = {ego_state[2]:.2f} m/s")
    ax.text(tx, ty - 4.5, f"yaw = {ego_state[3]:.2f} rad")
    ax.text(tx + 10, ty, f"acc = {acc_cmd:.2f}")
    ax.text(tx + 10, ty - 1.5, f"steer = {steer_cmd:.2f}")
    ax.set_xlim(x_min, x_max)
    ax.set_ylim(y_min, y_max)
    ax.set_aspect("equal")


def plot_wire_car(ax, x: float, y: float, yaw: float, steer: float = 0.0,
                  color: str = "k", length: float = 4.5, width: float = 2.2,
                  backtowheel: float = 1.0, wheel_len: float = 0.35,
                  wheel_width: float = 0.2, tread: float = 0.7,
                  wheelbase: float = 2.5):
    """Hand-drawn wireframe car: body outline, four wheel rectangles with
    the front pair rotated by ``steer``, and a heading arrow (demo-1 car,
    reference scripts/1-lqr-pathtracking.py:59-105 + plot_arrow :33-56).

    (x, y) is the rear axle; the body spans [-backtowheel,
    length - backtowheel] along the heading. The steer rotation is applied
    about the front axle's midpoint (so the wheel's lateral offset swings
    slightly with it) -- the reference's convention.
    """
    import math

    def rot(a):
        return np.array([[math.cos(a), -math.sin(a)],
                         [math.sin(a), math.cos(a)]])

    wheel = np.array([[1.0, -1.0, -1.0, 1.0, 1.0],
                      [-1.0, -1.0, 1.0, 1.0, -1.0]])
    wheel *= np.array([[wheel_len], [wheel_width]])
    outline = np.array(
        [[-backtowheel, length - backtowheel, length - backtowheel,
          -backtowheel, -backtowheel],
         [width / 2, width / 2, -width / 2, -width / 2, width / 2]])
    polys = [outline]
    for side in (-1.0, 1.0):
        polys.append(rot(steer) @ (wheel + [[0.0], [side * tread]])
                     + [[wheelbase], [0.0]])          # front, steered
        polys.append(wheel + [[0.0], [side * tread]])  # rear
    body = rot(yaw)
    for p in polys:
        q = body @ p + [[x], [y]]
        ax.plot(q[0], q[1], color=color)
    # heading arrow, stem 0.8*wheelbase with 30-degree hat lines (:33-56)
    L = 0.8 * wheelbase
    tip = np.array([x + L * math.cos(yaw), y + L * math.sin(yaw)])
    ax.plot([x, tip[0]], [y, tip[1]], color=color, linewidth=2)
    for s in (-1.0, 1.0):
        a = yaw + math.pi + s * math.radians(30)
        ax.plot([tip[0], tip[0] + 0.3 * L * math.cos(a)],
                [tip[1], tip[1] + 0.3 * L * math.sin(a)],
                color=color, linewidth=2)


def plot_tracking_console(ax, steer: float, acc: float, acc_max: float = 5.0,
                          wheel_sprite=None):
    """Demo-1 console HUD: steering-wheel sprite rotated by ``steer`` around
    (-5, 15) at extent [-8,-2]x[12,18], plus brake (cyan) and accelerator
    (orange) bars scaled 6*|cmd|/acc_max (reference
    scripts/1-lqr-pathtracking.py:108-123; drawn at fixed data coordinates,
    matching the reference's fixed xlim/ylim view)."""
    from matplotlib.transforms import Affine2D

    if wheel_sprite is None:
        wheel_sprite = _steering_wheel_sprite()
    brake = max(-acc, 0.0)
    acc = max(acc, 0.0)
    tr = Affine2D().rotate_deg_around(-5, 15, np.degrees(steer)) + ax.transData
    ax.imshow(wheel_sprite, transform=tr, extent=[-8, -2, 12, 18],
              zorder=10.0, clip_on=True)
    ax.fill([-1, 0, 0, -1],
            [12, 12, 12 + 6 * brake / acc_max, 12 + 6 * brake / acc_max], "c")
    ax.fill([1, 2, 2, 1],
            [12, 12, 12 + 6 * acc / acc_max, 12 + 6 * acc / acc_max],
            color="orange")


def _demo_plot_road(ax):
    """Demo-2 road: borders at y=6/-2, dashed center at y=2
    (reference scripts/2-cilqr-motionplanning.py:395-398)."""
    ax.plot([-10, 50], [6, 6], linewidth=2, color="black")
    ax.plot([-10, 50], [-2, -2], linewidth=2, color="black")
    ax.plot([-10, 50], [2, 2], linestyle="--", color="gray")


def _demo_plot_vehicle_fill(ax, state, length, width, is_ego):
    """Demo-2 'fill' draw style: rotated footprint rectangle
    (scripts/2-cilqr-motionplanning.py:419-436)."""
    x, y, yaw = float(state[0]), float(state[1]), float(state[3])
    box = np.array([[-length / 2, length / 2, length / 2, -length / 2, -length / 2],
                    [width / 2, width / 2, -width / 2, -width / 2, width / 2]])
    rot = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
    box = rot @ box + np.array([[x], [y]])
    if is_ego:
        ax.fill(box[0], box[1], color="cyan", alpha=0.5, zorder=1)
    else:
        ax.fill(box[0], box[1], color="red", alpha=0.5, zorder=1)


def animate_demo_replay(u, x, obs_preds, length: float, width: float,
                        acc_max: float, out_path: Optional[str] = None,
                        show: bool = False, fps: int = 10):
    """Demo-2 one-shot-solve animation replay + footprint summary.

    Mirrors reference scripts/2-cilqr-motionplanning.py:479-503: the solved
    trajectory is replayed frame by frame (road, console HUD, ego + the two
    predicted obstacles), then a final plot overlays every second footprint.
    Note the reference passes ``(acc, steer)`` into ``plot_console(steer,
    acc)`` (:482) -- a plot-only argument swap; we draw the console with
    the correct mapping.

    Args: u (N, 2) controls, x (N+1, 4) states, obs_preds (M, N+1, 4).
    Returns the matplotlib figure.
    """
    plt = _plt()
    from matplotlib.transforms import Affine2D

    u = np.asarray(u)
    x = np.asarray(x)
    obs_preds = np.asarray(obs_preds)
    N = u.shape[0]
    ego_sprite = make_car_sprite((0.2, 0.75, 0.8))
    agent_sprite = make_car_sprite((0.9, 0.9, 0.9))
    wheel = _steering_wheel_sprite()
    fig, ax = plt.subplots(figsize=(10, 5))

    def draw(i):
        ax.cla()
        _demo_plot_road(ax)
        # console (scripts/2-cilqr-motionplanning.py:434-450): wheel rotated
        # 1.5x steer at extent [-8,-2]x[8,14], brake/acc bars beside it
        acc_cmd, steer_cmd = float(u[i, 0]), float(u[i, 1])
        tr = Affine2D().rotate_deg_around(
            -5, 11, 1.5 * np.degrees(steer_cmd)) + ax.transData
        ax.imshow(wheel, transform=tr, extent=[-8, -2, 8, 14], zorder=10.0,
                  clip_on=True)
        acc = max(acc_cmd, 0.0)
        brake = max(-acc_cmd, 0.0)
        ax.fill([-1, 0, 0, -1],
                [8, 8, 8 + 6 * brake / acc_max, 8 + 6 * brake / acc_max], "c")
        ax.fill([1, 2, 2, 1],
                [8, 8, 8 + 6 * acc / acc_max, 8 + 6 * acc / acc_max],
                color="orange")
        plot_vehicle(ax, ego_sprite, x[i], length, width)
        for m in range(obs_preds.shape[0]):
            plot_vehicle(ax, agent_sprite, obs_preds[m, i], length, width)
        ax.set_xlim(-10, 50)
        ax.set_ylim(-5, 15)
        ax.set_aspect("equal")

    if out_path:
        from matplotlib.animation import FuncAnimation
        anim = FuncAnimation(fig, draw, frames=N, interval=1000 / fps)
        anim.save(out_path, fps=fps)
    elif show:
        for i in range(N):
            draw(i)
            plt.pause(1.0 / fps)
    else:
        draw(N - 1)

    # footprint summary: every second step, fill style (:497-503)
    ax.cla()
    _demo_plot_road(ax)
    for i in range(0, N, 2):
        _demo_plot_vehicle_fill(ax, x[i], length, width, True)
        for m in range(obs_preds.shape[0]):
            _demo_plot_vehicle_fill(ax, obs_preds[m, i], length, width, False)
    ax.set_xlim(-10, 50)
    ax.set_ylim(-5, 15)
    ax.set_aspect("equal")
    if show:
        plt.pause(2.0)
    return fig


def animate_episode(setup, history, out_path: Optional[str] = None,
                    fps: int = 10, show: bool = False):
    """Render a whole run_mpc() history; optionally save as GIF/MP4."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 5))
    sprites = {
        "ego": make_car_sprite((0.2, 0.75, 0.8)),
        "agent": make_car_sprite((0.9, 0.9, 0.9)),
        "wheel": _steering_wheel_sprite(),
    }
    frames = len(history["u"])

    def draw(t):
        render_frame(ax, setup, history["ego"][t + 1], history["x"][t],
                     history["u"][t][0], t, sprites=sprites)

    if out_path:
        from matplotlib.animation import FuncAnimation
        anim = FuncAnimation(fig, draw, frames=frames, interval=1000 / fps)
        anim.save(out_path, fps=fps)
    elif show:
        for t in range(frames):
            draw(t)
            plt.pause(1.0 / fps)
    else:
        draw(frames - 1)
    return fig
