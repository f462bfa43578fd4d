"""Constraint geometry + penalty terms (barrier / augmented Lagrangian).

Counterpart of ``ilqr_tpu/ops/constraints.py``: elementwise math over any
leading axes. Parity notes (against the reference C++):

- ellipse semi-axes keep the 6x d_safe major-axis inflation
  (src/utils.cpp:387-393): a = 0.5*length + 6*d_safe + r,
  b = 0.5*width + d_safe + r;
- safety margin c = 1 - ((x'/a)^2 + (y'/b)^2) in the obstacle frame
  (src/utils.cpp:395-407); c > 0 means violation;
- exponential barrier b(c) = q1*exp(q2*c), b' = q2*b*c',
  b'' = q2^2*b*c'c'^T (src/cilqr_solver.cpp:692-699);
- ALM item rho/2*max(c + mu/rho, 0)^2 (include/cilqr_solver.hpp:81-83)
  with Hessian b'' = b' c'^T (src/cilqr_solver.cpp:701-713) and dual
  precompute mu_next = clip(mu + rho*c, 0, max_mu) (:622-637).
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.models.bicycle import front_rear_center_jacobians, front_rear_centers

# exp-barrier exponent clamp: inactive for float64, keeps float32 finite for
# deeply violated constraints.
EXP_CLIP_F32 = 60.0
EXP_CLIP_F64 = 700.0


def default_exp_clip(dtype) -> float:
    return EXP_CLIP_F64 if dtype == torch.float64 else EXP_CLIP_F32


def upper_bound_constr(var, bound):
    """c = var - bound (c > 0 => violated; src/cilqr_solver.cpp:316-324)."""
    return var - bound


def lower_bound_constr(var, bound):
    """c = bound - var (c > 0 => violated)."""
    return bound - var


def ellipsoid_scales(width, length, d_safe, ego_pnt_radius=0.0):
    """(a, b) semi-axes of the inflated obstacle ellipse."""
    a = 0.5 * length + 6.0 * d_safe + ego_pnt_radius
    b = 0.5 * width + d_safe + ego_pnt_radius
    return a, b


def _obstacle_frame(pnt, obs_state):
    diff = pnt - obs_state[..., :2]
    theta = obs_state[..., 2]
    ct, st = torch.cos(theta), torch.sin(theta)
    # rotate by -theta into the obstacle frame (src/utils.cpp:400-402)
    xs = ct * diff[..., 0] + st * diff[..., 1]
    ys = -st * diff[..., 0] + ct * diff[..., 1]
    return xs, ys, ct, st


def ellipsoid_safety_margin(pnt, obs_state, ab):
    """c = 1 - ((R(theta) (p - center)) scaled)^2; pnt (..., 2),
    obs_state (..., 3) = [cx, cy, theta]."""
    a, b = ab
    xs, ys, _, _ = _obstacle_frame(pnt, obs_state)
    return 1.0 - (xs**2 / a**2 + ys**2 / b**2)


def ellipsoid_safety_margin_grad(pnt, obs_state, ab):
    """dc/dp as (..., 2) (reference src/utils.cpp:409-439)."""
    a, b = ab
    xs, ys, ct, st = _obstacle_frame(pnt, obs_state)
    gxs = -2.0 * xs / a**2
    gys = -2.0 * ys / b**2
    # chain through the (-theta) rotation: dc/dp = R(theta)^T @ [gxs, gys]
    return torch.stack([ct * gxs - st * gys, st * gxs + ct * gys], dim=-1)


def obstacle_avoidance_constr(ego_state, obs_state, wheelbase, width, length,
                              d_safe, ref_point: str):
    """(front_margin, rear_margin) for one obstacle
    (reference src/cilqr_solver.cpp:326-335)."""
    front, rear = front_rear_centers(ego_state, wheelbase, ref_point)
    ab = ellipsoid_scales(width, length, d_safe, 0.5 * width)
    return (ellipsoid_safety_margin(front, obs_state, ab),
            ellipsoid_safety_margin(rear, obs_state, ab))


def obstacle_avoidance_constr_grads(ego_state, obs_state, wheelbase, width,
                                    length, d_safe, ref_point: str):
    """d(front_margin)/dx, d(rear_margin)/dx as (..., 4)
    (reference src/cilqr_solver.cpp:715-739)."""
    front, rear = front_rear_centers(ego_state, wheelbase, ref_point)
    ab = ellipsoid_scales(width, length, d_safe, 0.5 * width)
    g_front_pnt = ellipsoid_safety_margin_grad(front, obs_state, ab)
    g_rear_pnt = ellipsoid_safety_margin_grad(rear, obs_state, ab)
    jf, jr = front_rear_center_jacobians(ego_state[..., 3], wheelbase, ref_point)
    g_front = (jf @ g_front_pnt[..., None])[..., 0]
    g_rear = (jr @ g_rear_pnt[..., None])[..., 0]
    return g_front, g_rear


# penalty scalars: both families have gradient gamma(c) * c' and Hessian
# eta(c) * c' c'^T

def exp_barrier(c, q1, q2, exp_clip=None):
    """b = q1 * exp(q2 * c), exponent clamped for low-precision dtypes."""
    e = q2 * c
    if exp_clip is not None:
        e = torch.minimum(e, exp_clip)
    return q1 * torch.exp(e)


def exp_barrier_coeffs(c, q1, q2, exp_clip=None):
    """(value, gamma, eta): b, q2*b, q2^2*b."""
    b = exp_barrier(c, q1, q2, exp_clip)
    return b, q2 * b, q2 * q2 * b


def alm_item(c, rho, mu):
    """rho/2 * max(c + mu/rho, 0)^2."""
    act = torch.clamp_min(c + mu / rho, 0.0)
    return 0.5 * rho * act**2


def alm_coeffs(c, rho, mu):
    """(value, gamma, eta) with gamma = eta = rho*(c + mu/rho) when active
    (the reference's rank-1 Hessian, src/cilqr_solver.cpp:707-709)."""
    shifted = c + mu / rho
    active = shifted > 0
    zero = torch.zeros_like(shifted)
    value = torch.where(active, 0.5 * rho * shifted**2, zero)
    gamma = torch.where(active, rho * shifted, zero)
    return value, gamma, gamma


def alm_mu_next(c, rho, mu, max_mu):
    """Dual precompute mu_next = clip(mu + rho*c, 0, max_mu)."""
    return torch.minimum(torch.clamp_min(mu + rho * c, 0.0), max_mu)


def lateral_offset(x_k, ref_pt):
    """Signed lateral distance of states (..., 4) w.r.t. the nearest ref
    points (..., 3) = [rx, ry, ryaw]; positive = left of the line, with
    sign(0) = +1 (src/cilqr_solver.cpp:507-509)."""
    dx = x_k[..., 0] - ref_pt[..., 0]
    dy = x_k[..., 1] - ref_pt[..., 1]
    ryaw = ref_pt[..., 2]
    d_sign = dy * torch.cos(ryaw) - dx * torch.sin(ryaw)
    sgn = torch.where(d_sign < 0, -1.0, 1.0).to(x_k.dtype)
    return sgn * torch.hypot(dx, dy), d_sign


def lateral_offset_grad(x_k, ref_pt):
    """d(cur_d)/dx for the upper road-border constraint as (..., 4)
    (reference src/cilqr_solver.cpp:527-533); the lower constraint uses the
    negation. Zero-distance rows get a zero gradient."""
    dx = x_k[..., 0] - ref_pt[..., 0]
    dy = x_k[..., 1] - ref_pt[..., 1]
    h = torch.hypot(dx, dy)
    pos = h > 0
    safe = torch.where(pos, h, torch.ones_like(h))
    zero = torch.zeros_like(h)
    gx = torch.where(pos, dx / safe, zero)
    gy = torch.where(pos, dy / safe, zero)
    _, d_sign = lateral_offset(x_k, ref_pt)
    flip = torch.where(d_sign < 0, -1.0, 1.0).to(x_k.dtype)
    return torch.stack([flip * gx, flip * gy, zero, zero], dim=-1)
