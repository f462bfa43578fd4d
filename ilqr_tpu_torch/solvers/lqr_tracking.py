"""LQR path tracking with the kinematic bicycle (capability of reference
demo 1).

Counterpart of ``ilqr_tpu/solvers/lqr_tracking.py`` (reference
scripts/1-lqr-pathtracking.py: 5-state error dynamics [e, de, th_e, dth_e,
dv] with the DARE solved anew every tick (:163-226), feedforward steering
from the path's curvature, a steering low-pass, a speed profile with
stop/reverse handling (:311-337) and the rear-axle bicycle in tan form
(:134-140)).

Batched-first: a tick steps S episodes at once, states (S, 4), each tick's
DARE batched over them. ``simulate`` runs the JAX package's fixed number
of ticks with a goal mask that freezes a row after its goal, but stops as
soon as every row is frozen and pads the rest with the frozen values: a
frozen row's outputs repeat from then on, so the result is the full run's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ilqr_tpu_torch.ops.dare import solve_dare
from ilqr_tpu_torch.utils.splines import calc_spline_course

DT = 0.1
_SYNC_EVERY = 8  # ticks between host checks of the goal mask


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    Q: torch.Tensor  # (5, 5)
    R: torch.Tensor  # (2, 2)
    wheelbase: torch.Tensor
    max_steer: torch.Tensor
    max_acc: torch.Tensor
    dt: torch.Tensor

    @classmethod
    def from_numpy(cls, d: dict, dtype=torch.float64, device="cpu") -> "TrackerParams":
        """From ``{field: array}`` (the JAX package's ``TrackerParams._asdict()``
        as numpy)."""
        return cls(**{f.name: torch.tensor(np.array(d[f.name], dtype=np.float64), dtype=dtype,
                                           device=device)
                      for f in dataclasses.fields(cls)})


def default_params(dtype=torch.float64, device="cpu") -> TrackerParams:
    return TrackerParams.from_numpy(dict(
        Q=np.eye(5), R=np.eye(2), wheelbase=2.5, max_steer=np.deg2rad(40.0), max_acc=5.0,
        dt=DT), dtype=dtype, device=device)


def pi_2_pi(angle):
    """Wrap to [-pi, pi) with a floored remainder (``%`` on tensors floors,
    as ``jnp`` does; ``torch.fmod`` would not)."""
    return (angle + math.pi) % (2 * math.pi) - math.pi


def calc_speed_profile(cyaw: np.ndarray, target_speed: float) -> np.ndarray:
    """Direction-switch aware speed profile with a slow-down tail
    (reference scripts/1-lqr-pathtracking.py:311-337), on the host."""
    n = len(cyaw)
    sp = np.full(n, target_speed, dtype=np.float64)
    direction = 1.0
    for i in range(n - 1):
        dyaw = abs(cyaw[i + 1] - cyaw[i])
        switch = (np.pi / 4.0 <= dyaw) and (dyaw < np.pi / 2.0)
        if switch:
            direction *= -1
        sp[i] = -target_speed if direction != 1.0 else target_speed
        if switch:
            sp[i] = 0.0
    for i in range(50):
        # the reference's i = 0 writes sp[-0], which is sp[0]
        sp[-i] = target_speed / (60 - i)
        if sp[-i] <= 1.0 / 3.6:
            sp[-i] = 1.0 / 3.6
    return sp


def nearest_index(state, cx, cy, cyaw):
    """Global first-min argmin over the course and the signed lateral error
    (reference scripts/1-lqr-pathtracking.py:229-245). state (S, 4);
    returns (ind (S,), e (S,))."""
    dx = state[:, 0:1] - cx
    dy = state[:, 1:2] - cy
    d2 = dx * dx + dy * dy
    ind = torch.argmin(d2, dim=-1)
    mind = torch.sqrt(d2.gather(-1, ind[:, None])[:, 0])
    angle = pi_2_pi(cyaw[ind] - torch.atan2(cy[ind] - state[:, 1], cx[ind] - state[:, 0]))
    return ind, torch.where(angle < 0, -mind, mind)


def control_step(p: TrackerParams, state, course, pe, pth_e):
    """One controller tick: error-state LQR by DARE + curvature feedforward
    (reference scripts/1-lqr-pathtracking.py:163-226).

    state (S, 4) = [x, y, yaw, v]; course = (cx, cy, cyaw, ck, sp) 1-D
    tensors; pe, pth_e (S,). Returns (delta, accel, ind, e, th_e), each (S,).
    """
    cx, cy, cyaw, ck, sp = course
    ind, e = nearest_index(state, cx, cy, cyaw)
    tv = sp[ind]
    k = ck[ind]
    v = state[:, 3]
    th_e = pi_2_pi(state[:, 2] - cyaw[ind])

    S = state.shape[0]
    A = state.new_zeros((S, 5, 5))
    A[:, 0, 0] = 1.0
    A[:, 0, 1] = p.dt
    A[:, 1, 2] = v
    A[:, 2, 2] = 1.0
    A[:, 2, 3] = p.dt
    A[:, 4, 4] = 1.0
    B = state.new_zeros((S, 5, 2))
    B[:, 3, 0] = v / p.wheelbase
    B[:, 4, 1] = p.dt

    P = solve_dare(A, B, p.Q, p.R)
    BtP = B.transpose(-1, -2) @ P
    K = torch.linalg.solve_ex(p.R + BtP @ B, BtP @ A)[0]

    xvec = torch.stack([e, (e - pe) / p.dt, th_e, (th_e - pth_e) / p.dt, v - tv], dim=-1)
    ustar = -(K @ xvec[..., None])[..., 0]
    ff = torch.atan2(p.wheelbase * k, torch.ones_like(k))
    fb = pi_2_pi(ustar[:, 0])
    return ff + fb, ustar[:, 1], ind, e, th_e


def vehicle_update(p: TrackerParams, state, accel, delta):
    """Rear-axle bicycle, tan form (reference scripts/1-lqr-pathtracking.py:134-140)."""
    x, y, yaw, v = state.unbind(-1)
    return torch.stack([
        x + v * torch.cos(yaw) * p.dt,
        y + v * torch.sin(yaw) * p.dt,
        yaw + v / p.wheelbase * torch.tan(delta) * p.dt,
        v + accel * p.dt,
    ], dim=-1)


def simulate(p: TrackerParams, course, goal, x0=None, max_ticks: int = 5000,
             goal_dis: float = 0.3):
    """Tracking episodes with a goal mask (reference loop:
    scripts/1-lqr-pathtracking.py:248-308).

    x0: (4,), (S, 4) or None (the origin at rest). Returns (states (T+1, 4),
    controls (T, 2) [acc, steering], reached (T,) goal mask), with a leading
    S axis when x0 is (S, 4). A row that reached its goal keeps its state,
    error terms and last steering, so its later ticks repeat one output;
    once every row has, the rest of the run is that repetition.
    """
    cx = course[0]
    dtype, dev = cx.dtype, cx.device
    single = x0 is None or x0.dim() == 1
    x0 = (torch.zeros(4, dtype=dtype, device=dev) if x0 is None else x0).reshape(-1, 4)
    goal = torch.as_tensor(goal, dtype=dtype, device=dev)
    S = x0.shape[0]
    state = x0
    zero = x0.new_zeros(S)
    pe, pth_e, last_dl = zero, zero, zero
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    states, controls, reached = [], [], []
    for t in range(max_ticks):
        frozen = t % _SYNC_EVERY == 0 and bool(done.all())
        dl, acc, _, e, th_e = control_step(p, state, course, pe, pth_e)
        dl = torch.clamp(dl, -p.max_steer, p.max_steer)
        acc = torch.clamp(acc, -p.max_acc, p.max_acc)
        steering = dl * 0.75 + last_dl * 0.25  # low-pass (:269-271)
        new_state = vehicle_update(p, state, acc, steering)
        hit = torch.hypot(new_state[:, 0] - goal[0], new_state[:, 1] - goal[1]) <= goal_dis
        done_n = done | hit
        state = torch.where(done[:, None], state, new_state)
        pe = torch.where(done, pe, e)
        pth_e = torch.where(done, pth_e, th_e)
        last_dl = torch.where(done, last_dl, steering)
        done = done_n
        states.append(state)
        controls.append(torch.stack([acc, steering], dim=-1))
        reached.append(done)
        if frozen:
            break
    # the last tick ran with every row frozen (or was tick T - 1): repeat it
    pad = max_ticks - len(states)
    states = torch.stack([x0] + states + states[-1:] * pad, dim=1)
    controls = torch.stack(controls + controls[-1:] * pad, dim=1)
    reached = torch.stack(reached + reached[-1:] * pad, dim=1)
    if single:
        return states[0], controls[0], reached[0]
    return states, controls, reached


def make_demo_course(dtype=torch.float64, device="cpu"):
    """The demo-1 course (reference scripts/1-lqr-pathtracking.py:341-347):
    ((cx, cy, cyaw, ck, sp) tensors, goal (x, y))."""
    ax = [0.0, 15.0, 31.25, 25.0, 18.75, 7.5, -2.5]
    ay = [0.0, -7.5, -12.25, 16.25, 7.5, 12.5, -5.0]
    cx, cy, cyaw, ck, _ = calc_spline_course(ax, ay, ds=0.1)
    sp = calc_speed_profile(cyaw, 20.0 / 3.6)
    course = tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (cx, cy, cyaw, ck, sp))
    return course, (ax[-1], ay[-1])
