"""Trajectory ribbon geometry (reference src/utils.cpp:441-473).

Counterpart of ``ilqr_tpu/utils/geometry.py`` (host-side numpy there as
here): the ribbon of a planned trajectory, with the reference's
``utils::get_boundary`` and ``utils::get_closed_curve`` semantics.
"""

from __future__ import annotations

import numpy as np


def get_boundary(trajectory, width: float) -> np.ndarray:
    """Left/right offsets of trajectory rows 1..n-1.

    trajectory: (n, 4) rows [x, y, v, yaw]. Returns (n-1, 4) rows
    [left_x, left_y, right_x, right_y] offset half of ``width``
    perpendicular to the local yaw (reference src/utils.cpp:441-457 --
    note the first trajectory row is skipped).
    """
    t = np.asarray(trajectory, dtype=float)
    half = width / 2.0
    x, y, yaw = t[1:, 0], t[1:, 1], t[1:, 3]
    return np.stack([x - half * np.sin(yaw), y + half * np.cos(yaw),
                     x + half * np.sin(yaw), y - half * np.cos(yaw)], axis=-1)


def get_closed_curve(boundary) -> np.ndarray:
    """Close a boundary ribbon into one polygon: the left side reversed,
    then the right side forward (reference src/utils.cpp:459-473).

    boundary: (n, 4) rows [lx, ly, rx, ry]. Returns (2, 2n) [xs; ys].
    """
    b = np.asarray(boundary, dtype=float)
    xs = np.concatenate([b[::-1, 0], b[:, 2]])
    ys = np.concatenate([b[::-1, 1], b[:, 3]])
    return np.stack([xs, ys])
