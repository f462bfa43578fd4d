"""Kinematic bicycle model: dynamics + analytic Jacobians (PyTorch port).

Counterpart of ``ilqr_tpu/models/bicycle.py``. State x = [px, py, v, yaw],
control u = [acc, steer], over any leading axes:

- gravity center (slip angle beta = atan(tan(steer)/2)), reference
  src/utils.cpp:274-279;
- rear axle (tan form), reference src/utils.cpp:269-273.

Jacobian layout as reference src/utils.cpp:295-309:
df_dx[..., r, c] = d next_state[r] / d state[c], df_du similarly.
"""

from __future__ import annotations

import torch

GRAVITY_CENTER = "gravity_center"
REAR_CENTER = "rear_center"


def kinematic_propagate(x, u, dt, wheelbase, ref_point: str = GRAVITY_CENTER):
    """One step of the discrete bicycle model. x: (..., 4), u: (..., 2)."""
    px, py, v, yaw = x.unbind(-1)
    acc, stl = u.unbind(-1)
    if ref_point == REAR_CENTER:
        nx = px + v * torch.cos(yaw) * dt
        ny = py + v * torch.sin(yaw) * dt
        nv = v + acc * dt
        nyaw = yaw + v * torch.tan(stl) * dt / wheelbase
    else:
        beta = torch.atan(torch.tan(stl) / 2.0)
        nx = px + v * torch.cos(beta + yaw) * dt
        ny = py + v * torch.sin(beta + yaw) * dt
        nv = v + acc * dt
        nyaw = yaw + 2.0 * v * torch.sin(beta) * dt / wheelbase
    return torch.stack([nx, ny, nv, nyaw], dim=-1)


def kinematic_jacobians(x, u, dt, wheelbase, ref_point: str = GRAVITY_CENTER):
    """Analytic (A, B) = (df/dx, df/du) along a trajectory.

    x: (..., N, 4) states at steps 0..N-1, u: (..., N, 2). Returns
    A: (..., N, 4, 4), B: (..., N, 4, 2) (reference src/utils.cpp:285-342).
    """
    v = x[..., 2]
    yaw = x[..., 3]
    stl = u[..., 1]
    zeros = torch.zeros_like(v)
    ones = torch.ones_like(v)
    if ref_point == REAR_CENTER:
        a02 = torch.cos(yaw) * dt
        a03 = -v * torch.sin(yaw) * dt
        a12 = torch.sin(yaw) * dt
        a13 = v * torch.cos(yaw) * dt
        a32 = torch.tan(stl) * dt / wheelbase
        b01 = zeros
        b11 = zeros
        b31 = (v * dt / wheelbase) / (torch.cos(stl) ** 2)
    else:
        # REFERENCE QUIRK, kept on purpose: the Jacobian's slip angle is
        # atan(tan(stl / 2)) (src/utils.cpp:292) while the dynamics use
        # atan(tan(stl) / 2) (src/utils.cpp:265); the derivative factor is
        # the exact d/dstl of the dynamics' beta (src/utils.cpp:293).
        beta = torch.atan(torch.tan(stl / 2.0))
        t2 = torch.tan(stl) ** 2
        beta_over_stl = 0.5 * (1.0 + t2) / (1.0 + 0.25 * t2)
        a02 = torch.cos(beta + yaw) * dt
        a03 = -v * torch.sin(beta + yaw) * dt
        a12 = torch.sin(beta + yaw) * dt
        a13 = v * torch.cos(beta + yaw) * dt
        a32 = 2.0 * torch.sin(beta) * dt / wheelbase
        b01 = -v * torch.sin(beta + yaw) * dt * beta_over_stl
        b11 = v * torch.cos(beta + yaw) * dt * beta_over_stl
        b31 = (2.0 * v * dt / wheelbase) * torch.cos(beta) * beta_over_stl
    A = torch.stack([
        torch.stack([ones, zeros, a02, a03], dim=-1),
        torch.stack([zeros, ones, a12, a13], dim=-1),
        torch.stack([zeros, zeros, ones, zeros], dim=-1),
        torch.stack([zeros, zeros, a32, ones], dim=-1),
    ], dim=-2)
    bdt = ones * dt
    B = torch.stack([
        torch.stack([zeros, b01], dim=-1),
        torch.stack([zeros, b11], dim=-1),
        torch.stack([bdt, zeros], dim=-1),
        torch.stack([zeros, b31], dim=-1),
    ], dim=-2)
    return A, B


def rollout(x0, u_seq, dt, wheelbase, ref_point: str = GRAVITY_CENTER):
    """Roll a control sequence forward: x0 (..., 4), u_seq (..., N, 2)
    -> (..., N+1, 4) (reference loop: src/cilqr_solver.cpp:169-178)."""
    xs = [x0]
    for k in range(u_seq.shape[-2]):
        xs.append(kinematic_propagate(xs[-1], u_seq[..., k, :], dt, wheelbase, ref_point))
    return torch.stack(xs, dim=-2)


def const_velo_prediction(x0, steps: int, dt, wheelbase, ref_point: str = GRAVITY_CENTER):
    """Zero-control rollout (reference src/cilqr_solver.cpp:182-197):
    x0 (..., 4) -> (..., steps+1, 4)."""
    u = x0.new_zeros((*x0.shape[:-1], steps, 2))
    return rollout(x0, u, dt, wheelbase, ref_point)


def front_rear_centers(state, wheelbase, ref_point: str = GRAVITY_CENTER):
    """Front/rear disc centers of the ego footprint. state (..., 4).

    Gravity center: +-wheelbase/2 along yaw; rear center: rear = position,
    front = +wheelbase (reference src/utils.cpp:344-361).
    """
    pos = state[..., :2]
    yaw = state[..., 3]
    # the wheelbase scales each coordinate before the stack, so a per-row
    # wheelbase shaped like ``yaw`` broadcasts
    whba = torch.stack([wheelbase * torch.cos(yaw), wheelbase * torch.sin(yaw)], dim=-1)
    if ref_point == REAR_CENTER:
        return pos + whba, pos
    return pos + 0.5 * whba, pos - 0.5 * whba


def front_rear_center_jacobians(yaw, wheelbase, ref_point: str = GRAVITY_CENTER):
    """d(front)/d(state), d(rear)/d(state) as (..., 4, 2) arrays, rows
    indexing the state and columns the point coordinate (reference
    src/utils.cpp:363-385)."""
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    if ref_point == REAR_CENTER:
        f3x = -wheelbase * torch.sin(yaw)
        f3y = wheelbase * torch.cos(yaw)
        r3x = z
        r3y = z
    else:
        half = 0.5 * wheelbase
        f3x = -half * torch.sin(yaw)
        f3y = half * torch.cos(yaw)
        r3x = half * torch.sin(yaw)
        r3y = -half * torch.cos(yaw)

    def jac(p3x, p3y):
        return torch.stack([
            torch.stack([o, z], dim=-1),
            torch.stack([z, o], dim=-1),
            torch.stack([z, z], dim=-1),
            torch.stack([p3x, p3y], dim=-1),
        ], dim=-2)

    return jac(f3x, f3y), jac(r3x, r3y)
