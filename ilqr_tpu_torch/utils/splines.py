"""Natural cubic splines.

Counterpart of ``ilqr_tpu/utils/splines.py`` (reference
src/cubic_spline.cpp:17-193 and scripts/utils/cubic_spline.py): the
Thomas-algorithm fit of the natural-spline system and the arc-length 2-D
spline with yaw and curvature, fitted and evaluated on the host in float64
(the lines are static per scenario; the device only sees the sampled
arrays), the dense course sampler of the tracking demo, and a tensor fit
and evaluation (``fit_natural_cubic``, ``eval_spline``) for building
splines on a device.
"""

from __future__ import annotations

import numpy as np
import torch


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


def fit_natural_cubic(x, y):
    """Natural-cubic fit of tensors (the Thomas algorithm as two loops over
    the knots, over any leading axes of x (..., n), y (..., n)).

    Same math as the host fit. Returns (a, b, c, d) (a, c length n; b, d
    length n-1)."""
    h = x[..., 1:] - x[..., :-1]
    a = y
    zero = torch.zeros_like(x[..., :1])
    lower = torch.cat([zero, h[..., :-1], zero], dim=-1)
    diag = torch.cat([zero + 1.0, 2.0 * (h[..., :-1] + h[..., 1:]), zero + 1.0], dim=-1)
    upper = torch.cat([zero, h[..., 1:], zero], dim=-1)
    interior = (3.0 * (a[..., 2:] - a[..., 1:-1]) / h[..., 1:]
                - 3.0 * (a[..., 1:-1] - a[..., :-2]) / h[..., :-1])
    rhs = torch.cat([zero, interior, zero], dim=-1)
    n = x.shape[-1]
    cs, ds = [], []
    c_prev = d_prev = zero[..., 0]
    for i in range(n):  # forward elimination
        den = diag[..., i] - lower[..., i] * c_prev
        c_prev = upper[..., i] / den
        d_prev = (rhs[..., i] - lower[..., i] * d_prev) / den
        cs.append(c_prev)
        ds.append(d_prev)
    sol = []
    x_next = zero[..., 0]
    for i in range(n - 1, -1, -1):  # back substitution
        x_next = ds[i] - cs[i] * x_next
        sol.append(x_next)
    c = torch.stack(sol[::-1], dim=-1)
    d = (c[..., 1:] - c[..., :-1]) / (3.0 * h)
    b = (a[..., 1:] - a[..., :-1]) / h - h * (c[..., 1:] + 2.0 * c[..., :-1]) / 3.0
    return a, b, c, d


def eval_spline(knots_x, a, b, c, d, t, dd: int = 0):
    """Evaluate a fitted cubic spline at t, clamped to the knots' range;
    dd = 0/1/2 selects position / first / second derivative
    (``CubicSpline::operator()``, reference src/cubic_spline.cpp:109-124).
    knots_x and the coefficients are 1-D."""
    idx = torch.clamp(torch.searchsorted(knots_x, t, right=True) - 1, 0, knots_x.shape[0] - 2)
    dx = t - knots_x[idx]
    if dd == 0:
        return a[idx] + b[idx] * dx + c[idx] * dx**2 + d[idx] * dx**3
    if dd == 1:
        return b[idx] + 2.0 * c[idx] * dx + 3.0 * d[idx] * dx**2
    if dd == 2:
        return 2.0 * c[idx] + 6.0 * d[idx] * dx
    raise ValueError("dd must be 0, 1 or 2")


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

    def calc_second_derivative(self, t):
        i = self._index(t)
        dx = np.asarray(t, dtype=np.float64) - self.x[i]
        return 2.0 * self.c[i] + 6.0 * self.d[i] * dx

    def __call__(self, t, dd: int = 0):
        if dd == 0:
            return self.calc_position(t)
        if dd == 1:
            return self.calc_first_derivative(t)
        if dd == 2:
            return self.calc_second_derivative(t)
        raise ValueError("dd must be 0, 1 or 2")


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

    def calc_curvature(self, s):
        dx = self.sx.calc_first_derivative(s)
        ddx = self.sx.calc_second_derivative(s)
        dy = self.sy.calc_first_derivative(s)
        ddy = self.sy.calc_second_derivative(s)
        return (ddy * dx - ddx * dy) / np.power(dx * dx + dy * dy, 1.5)


def calc_spline_course(x, y, ds: float = 0.1):
    """Dense (x, y, yaw, curvature, s) course along the spline
    (reference scripts/utils/cubic_spline.py:244-256, which the tracking
    demo consumes): the samples run from s[0] to s[-1], exclusive, by
    accumulating ``s += ds``."""
    sp = CubicSpline2D(x, y)
    s_samples = []
    s = float(sp.s[0])
    while s < sp.s[-1]:
        s_samples.append(s)
        s += ds
    s_arr = np.asarray(s_samples, dtype=np.float64)
    rx, ry = sp.calc_position(s_arr)
    return rx, ry, sp.calc_yaw(s_arr), sp.calc_curvature(s_arr), s_arr
