"""Natural cubic splines, fitted and evaluated on the host in float64.

The part of ``ilqr_tpu/utils/splines.py`` that the reference lines need:
the Thomas-algorithm fit of the natural-spline system (reference
src/cubic_spline.cpp:17-193) and the arc-length 2-D spline. The lines are
static per scenario, so this stays numpy; the device only sees the sampled
arrays.
"""

from __future__ import annotations

import numpy as np


def _thomas_solve(lower, diag, upper, rhs):
    """Solve a tridiagonal system."""
    n = len(diag)
    c = np.zeros(n)
    d = np.zeros(n)
    c[0] = upper[0] / diag[0]
    d[0] = rhs[0] / diag[0]
    for i in range(1, n):
        den = diag[i] - lower[i] * c[i - 1]
        c[i] = upper[i] / den if i < n - 1 else 0.0
        d[i] = (rhs[i] - lower[i] * d[i - 1]) / den
    x = np.zeros(n)
    x[-1] = d[-1]
    for i in range(n - 2, -1, -1):
        x[i] = d[i] - c[i] * x[i + 1]
    return x


def _natural_spline_coeffs(x: np.ndarray, y: np.ndarray):
    """Natural-cubic coefficients (a, b, c, d) per knot
    (the linear system of reference src/cubic_spline.cpp:41-68)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    h = np.diff(x)
    if np.any(h < 0):
        raise ValueError("x coordinates must be sorted in ascending order")
    a = y.copy()
    lower = np.zeros(n)
    diag = np.ones(n)
    upper = np.zeros(n)
    rhs = np.zeros(n)
    for i in range(1, n - 1):
        lower[i] = h[i - 1]
        diag[i] = 2.0 * (h[i - 1] + h[i])
        upper[i] = h[i]
        rhs[i] = 3.0 * (a[i + 1] - a[i]) / h[i] - 3.0 * (a[i] - a[i - 1]) / h[i - 1]
    c = _thomas_solve(lower, diag, upper, rhs)
    b = np.zeros(n - 1)
    d = np.zeros(n - 1)
    for i in range(n - 1):
        d[i] = (c[i + 1] - c[i]) / (3.0 * h[i])
        b[i] = (a[i + 1] - a[i]) / h[i] - h[i] * (c[i + 1] + 2.0 * c[i]) / 3.0
    return a, b, c[:n], d


class CubicSpline1D:
    """Natural cubic spline over (x, y) knots."""

    def __init__(self, x, y):
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.a, self.b, self.c, self.d = _natural_spline_coeffs(self.x, self.y)

    def _index(self, t):
        t = np.asarray(t, dtype=np.float64)
        return np.clip(np.searchsorted(self.x, t, side="right") - 1, 0, len(self.x) - 2)

    def calc_position(self, t):
        i = self._index(t)
        dx = np.asarray(t, dtype=np.float64) - self.x[i]
        return self.a[i] + self.b[i] * dx + self.c[i] * dx**2 + self.d[i] * dx**3

    def calc_first_derivative(self, t):
        i = self._index(t)
        dx = np.asarray(t, dtype=np.float64) - self.x[i]
        return self.b[i] + 2.0 * self.c[i] * dx + 3.0 * self.d[i] * dx**2


class CubicSpline2D:
    """Arc-length-parameterized 2-D spline (reference src/cubic_spline.cpp:126-175)."""

    def __init__(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        ds = np.hypot(np.diff(x), np.diff(y))
        self.s = np.concatenate([[0.0], np.cumsum(ds)])
        self.sx = CubicSpline1D(self.s, x)
        self.sy = CubicSpline1D(self.s, y)

    def calc_position(self, s):
        return self.sx.calc_position(s), self.sy.calc_position(s)

    def calc_yaw(self, s):
        dx = self.sx.calc_first_derivative(s)
        dy = self.sy.calc_first_derivative(s)
        return np.arctan2(dy, dx)
