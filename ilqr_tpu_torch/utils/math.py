"""Small math helpers (reference: template utils in include/utils.hpp:108-232).

Counterpart of ``ilqr_tpu/utils/math.py``: torch, shape-polymorphic,
dtype-preserving. Array-likes are taken with ``torch.as_tensor``.
"""

from __future__ import annotations

import math

import torch


def sign(x):
    """+1 for x >= 0, -1 for x < 0 (reference include/utils.hpp:110-117 --
    note sign(0) = +1, unlike torch.sign). Floating inputs keep their
    dtype; others give int32."""
    x = torch.as_tensor(x)
    out = torch.where(x < 0, -1, 1)
    return out.to(x.dtype if x.is_floating_point() else torch.int32)


def pi_2_pi(theta):
    """Wrap an angle to [-pi, pi) with the modulo form the reference demos
    use (scripts/1-lqr-pathtracking.py:143-144)."""
    return torch.remainder(torch.as_tensor(theta) + math.pi, 2.0 * math.pi) - math.pi


def rotation_matrix2d(theta):
    """(..., 2, 2) CCW rotation (reference include/utils.hpp:127-133)."""
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def transformation_matrix2d(x, y, theta):
    """(..., 3, 3) SE(2) transform (reference include/utils.hpp:119-125)."""
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, x * o], dim=-1),
        torch.stack([s, c, y * o], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def diff(v, axis=-1):
    return torch.diff(torch.as_tensor(v), dim=axis)


def cumsum(v, axis=-1):
    return torch.cumsum(torch.as_tensor(v), dim=axis)


def variance(v):
    """Population variance (reference include/utils.hpp:217-232)."""
    v = torch.as_tensor(v)
    return torch.mean((v - torch.mean(v)) ** 2)
