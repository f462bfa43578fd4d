"""The benchmark's inputs, made from a configuration's scenario and the seed.

A frozen copy of the port's host-side scenario construction, so that the
inputs do not move when the program does (``ilqr_tpu_torch/sim/scenario.py``,
``utils/refline.py``, ``utils/splines.py``; upstream
src/motion_planning.cpp:91-174, src/cubic_spline.cpp, src/utils.cpp:21-67):

- the centre line 0 as the ego's reference line: the natural cubic spline of
  the waypoints over arc length, sampled every 0.1 m, as (P, 4) rows
  [x, y, yaw, s];
- each agent's predicted route: snapped to the nearest centre line by the
  upstream walk, then advanced along it at its initial speed each tick for
  the episode and 10 s more, as (M, T, 3) rows [x, y, yaw], held at the last
  row where an episode needs more;
- the road borders [max, min] of the border widths and the target velocity;
- the ego's starts: the scenario's ego state plus Gaussian noise of scales
  (0.5, 0.2, 0.5, 0.02) (``sim/scenario.py:perturbed_initial_states``),
  drawn from the seed and the batch's index.

Everything is numpy float64; the harness rounds it once to the type the
configuration states and hands the same rounded values to the program and
to the plain reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

START_SCALES = (0.5, 0.2, 0.5, 0.02)
LINE_STEP = 0.1  # metres between reference-line samples


def _spline_coeffs(x, y):
    """Natural cubic spline coefficients (a, b, c, d) over knots x."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    h = np.diff(x)
    lower, diag, upper, rhs = np.zeros(n), np.ones(n), np.zeros(n), np.zeros(n)
    for i in range(1, n - 1):
        lower[i] = h[i - 1]
        diag[i] = 2.0 * (h[i - 1] + h[i])
        upper[i] = h[i]
        rhs[i] = 3.0 * (y[i + 1] - y[i]) / h[i] - 3.0 * (y[i] - y[i - 1]) / h[i - 1]
    cp, dp = np.zeros(n), np.zeros(n)  # Thomas algorithm
    cp[0], dp[0] = upper[0] / diag[0], rhs[0] / diag[0]
    for i in range(1, n):
        den = diag[i] - lower[i] * cp[i - 1]
        cp[i] = upper[i] / den if i < n - 1 else 0.0
        dp[i] = (rhs[i] - lower[i] * dp[i - 1]) / den
    c = np.zeros(n)
    c[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        c[i] = dp[i] - cp[i] * c[i + 1]
    d = (c[1:] - c[:-1]) / (3.0 * h)
    b = (y[1:] - y[:-1]) / h - h * (c[1:] + 2.0 * c[:-1]) / 3.0
    return y, b, c, d


class _Spline1D:
    def __init__(self, x, y):
        self.x = np.asarray(x, dtype=np.float64)
        self.a, self.b, self.c, self.d = _spline_coeffs(x, y)

    def __call__(self, t, dd: int = 0):
        i = np.clip(np.searchsorted(self.x, t, side="right") - 1, 0, len(self.x) - 2)
        dx = np.asarray(t, dtype=np.float64) - self.x[i]
        if dd == 0:
            return self.a[i] + self.b[i] * dx + self.c[i] * dx**2 + self.d[i] * dx**3
        return self.b[i] + 2.0 * self.c[i] * dx + 3.0 * self.d[i] * dx**2


class _Lane:
    """A lane line: the waypoints' arc-length spline offset by ``width``
    to the left, sampled every LINE_STEP metres as the upstream loop does
    (float64 accumulation of s, the end included)."""

    def __init__(self, xs, ys, width: float):
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        self.s_knots = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(xs), np.diff(ys)))])
        self.sx, self.sy = _Spline1D(self.s_knots, xs), _Spline1D(self.s_knots, ys)
        self.width = float(width)
        s_all, s = [], 0.0
        while s <= self.s_knots[-1]:
            s_all.append(s)
            s += LINE_STEP
        self.s = np.asarray(s_all)
        pos = self.at(self.s)
        self.x, self.y, self.yaw = pos[:, 0], pos[:, 1], pos[:, 2]

    def at(self, s):
        """(..., 3) [x, y, yaw] of the offset line at arc length s."""
        yaw = np.arctan2(self.sy(s, 1), self.sx(s, 1))
        return np.stack([self.sx(s) - self.width * np.sin(yaw),
                         self.sy(s) + self.width * np.cos(yaw), yaw], axis=-1)


def _route(lanes, cond, ticks_total: int, dt: float) -> np.ndarray:
    """(T, 3) predicted route of one agent from its [x, y, v, yaw]: the first
    local minimum of the distance along each lane picks the lane and the
    start, then constant speed along it, backwards when the yaw is past
    pi / 2 (upstream src/motion_planning.cpp:126-158)."""
    x0, y0, v0, yaw0 = (float(c) for c in cond[:4])
    lane_idx, start_s, min_diff = 0, lanes[0].s_knots[-1], -1.0
    for idx, lane in enumerate(lanes):
        for i in range(1, len(lane.x)):
            last = math.hypot(lane.x[i - 1] - x0, lane.y[i - 1] - y0)
            if math.hypot(lane.x[i] - x0, lane.y[i] - y0) > last:
                if min_diff < 0 or last < min_diff:
                    min_diff, lane_idx, start_s = last, idx, lane.s[i - 1]
                break
    lane = lanes[lane_idx]
    rows, t = [], 0.0
    for _ in range(ticks_total):
        if yaw0 <= math.pi / 2:
            p = lane.at(min(start_s + t * v0, lane.s[-1]))
        else:
            p = lane.at(max(start_s - t * v0, lane.s[0]))
            p = np.array([p[0], p[1], math.fmod(float(p[2]) + math.pi, 2 * math.pi)])
        rows.append(p)
        t += dt
    return np.stack(rows)


class Scene(NamedTuple):
    """A scenario's inputs, float64."""

    line: np.ndarray  # (P, 4) [x, y, yaw, s] of centre line 0
    obs: np.ndarray  # (M, T, 3), T >= ticks + N + 1
    road_borders: np.ndarray  # (2,) [max, min]
    ref_velo: float
    ego_x0: np.ndarray  # (4,)
    ticks: int  # the episode's ticks
    N: int


def build_scene(sc: dict) -> Scene:
    """The inputs of the scenario ``sc`` (a configuration file's "scenario")."""
    dt, horizon = float(sc["delta_t"]), int(sc["lqr"]["N"])
    ticks = int(round(float(sc["max_simulation_time"]) / dt))
    ref = sc["laneline"]["reference"]
    lanes = [_Lane(ref["x"], ref["y"], w) for w in sc["laneline"]["center_line"]]
    line = np.stack([lanes[0].x, lanes[0].y, lanes[0].yaw, lanes[0].s], axis=-1)
    # the upstream routes run max_simulation_time + 10 s, sampled by
    # accumulating t += dt while t < that
    total, t = 0, 0.0
    while t < float(sc["max_simulation_time"]) + 10:
        total += 1
        t += dt
    conds = sc["initial_condition"]
    need = ticks + horizon + 1
    obs = np.stack([_route(lanes, c, total, dt) for c in conds[1:]]) if len(conds) > 1 \
        else np.zeros((0, need, 3))
    if obs.shape[1] < need:  # hold the last prediction
        obs = np.concatenate([obs, np.repeat(obs[:, -1:], need - obs.shape[1], axis=1)], 1)
    borders = [float(b) for b in sc["laneline"]["border"]]
    return Scene(line=line, obs=obs, road_borders=np.array([max(borders), min(borders)]),
                 ref_velo=float(sc["vehicle"]["target_velocity"]),
                 ego_x0=np.asarray(conds[0][:4], dtype=np.float64), ticks=ticks, N=horizon)


def starts(ego_x0: np.ndarray, batch: int, seed: int, index: int) -> np.ndarray:
    """(batch, 4) float64 starts of batch ``index`` of run ``seed``."""
    rng = np.random.default_rng([int(seed) % 2**64, int(index)])
    return ego_x0[None, :] + rng.normal(size=(batch, 4)) * np.asarray(START_SCALES)
