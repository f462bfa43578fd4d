"""Reference lines and routing lines (host side, numpy).

Counterpart of ``ilqr_tpu/utils/refline.py``:

- ``ReferenceLine``: densely sampled, laterally offset lane line on the
  arc-length spline (reference src/utils.cpp:21-35, 60-67), offset
  perpendicular to the local yaw: lx = x - w*sin(yaw), ly = y + w*cos(yaw);
- ``RoutingLine``: a time-indexed (x, y, yaw) agent trajectory (reference
  src/utils.cpp:37-58);
- ``get_cur_obstacle_states``: the agents' states at one tick (reference
  src/utils.cpp:105-115), which the renderer draws.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ilqr_tpu_torch.utils.splines import CubicSpline2D

# Coordinate of the rows that pad a line: far enough that they never win a
# nearest-point argmin and never activate obstacle constraints, while
# (coord**2)**2 stays finite in float32.
PAD_COORD = 1.0e6


class ReferenceLine:
    """Dense offset lane line sampled every ``accuracy`` metres."""

    def __init__(self, x: Sequence[float], y: Sequence[float], width: float = 0.0,
                 accuracy: float = 0.1):
        self.delta_s = float(accuracy)
        self.delta_d = float(width)
        self.spline = CubicSpline2D(x, y)
        xs: List[float] = []
        ys: List[float] = []
        yaws: List[float] = []
        ss: List[float] = []
        # accumulate s exactly like the reference loop (src/utils.cpp:25):
        # float64 accumulation, endpoint inclusive, so the sample count (and
        # thus the nearest-point candidates) matches.
        s = 0.0
        s_end = float(self.spline.s[-1])
        while s <= s_end:
            px, py = self.spline.calc_position(s)
            lyaw = float(self.spline.calc_yaw(s))
            xs.append(float(px) - width * np.sin(lyaw))
            ys.append(float(py) + width * np.cos(lyaw))
            yaws.append(lyaw)
            ss.append(s)
            s += self.delta_s
        self.x = np.asarray(xs)
        self.y = np.asarray(ys)
        self.yaw = np.asarray(yaws)
        self.longitude = np.asarray(ss)

    def __len__(self) -> int:
        return len(self.x)

    @property
    def size(self) -> int:
        return len(self.x)

    @property
    def length(self) -> float:
        return float(self.spline.s[-1])

    def calc_position(self, cur_s: float) -> np.ndarray:
        """(x, y, yaw) of the offset line at arc length ``cur_s``
        (reference src/utils.cpp:60-67)."""
        px, py = self.spline.calc_position(cur_s)
        lyaw = self.spline.calc_yaw(cur_s)
        lx = px - self.delta_d * np.sin(lyaw)
        ly = py + self.delta_d * np.cos(lyaw)
        return np.stack([lx, ly, lyaw], axis=-1)

    def as_array(self, pad_to: int | None = None, dtype=np.float64) -> np.ndarray:
        """(P, 4) array of [x, y, yaw, s], padded to ``pad_to`` rows with
        x = y = PAD_COORD and yaw = s = 0."""
        arr = np.stack([self.x, self.y, self.yaw, self.longitude], axis=-1).astype(dtype)
        if pad_to is not None and pad_to > arr.shape[0]:
            pad = np.zeros((pad_to - arr.shape[0], 4), dtype=dtype)
            pad[:, :2] = PAD_COORD
            arr = np.concatenate([arr, pad], axis=0)
        return arr


class RoutingLine:
    """Time-indexed (x, y, yaw) agent trajectory."""

    def __init__(self, x=None, y=None, yaw=None):
        self.x = list(x) if x is not None else []
        self.y = list(y) if y is not None else []
        self.yaw = list(yaw) if yaw is not None else []

    def __len__(self) -> int:
        return min(len(self.x), len(self.y), len(self.yaw))

    def __getitem__(self, index: int) -> np.ndarray:
        if index >= len(self):
            raise IndexError("RoutingLine index out of range")
        return np.array([self.x[index], self.y[index], self.yaw[index]])

    def as_array(self, dtype=np.float64) -> np.ndarray:
        """(T, 3) array of [x, y, yaw]."""
        return np.stack(
            [np.asarray(self.x), np.asarray(self.y), np.asarray(self.yaw)], axis=-1
        ).astype(dtype)


def stack_routing_lines(lines: Sequence[RoutingLine], dtype=np.float64) -> np.ndarray:
    """(M, T, 3) stacked agent trajectories, truncated to the common length."""
    if not lines:
        return np.zeros((0, 0, 3), dtype=dtype)
    t = min(len(line) for line in lines)
    return np.stack([line.as_array(dtype)[:t] for line in lines], axis=0)


def get_cur_obstacle_states(routing_lines: Sequence[RoutingLine], time_index: int,
                            dtype=np.float64) -> np.ndarray:
    """(M, 3) obstacle states at ``time_index``: routing line 0 is the ego's,
    so the obstacles are ``routing_lines[1:]`` sampled at the tick
    (reference src/utils.cpp:105-115 returns the columns of a 3xM matrix)."""
    obstacles = routing_lines[1:]
    if not obstacles:
        return np.zeros((0, 3), dtype=dtype)
    return np.stack([np.asarray(rl[time_index], dtype=dtype) for rl in obstacles], axis=0)
