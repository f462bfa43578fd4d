"""Barrier-only CILQR variant with the *Python demo's* semantics.

Counterpart of ``ilqr_tpu/solvers/cilqr_demo.py``: the reference's
pedagogical numpy planner (scripts/2-cilqr-motionplanning.py), as opposed
to its C++ solver (``solvers/cilqr.py``). Its behaviours, each kept:

- regularization on the *model*: the gains use Q_uu + B^T(lambda I)B and
  Q_ux + B^T(lambda I)A, while the value recursion keeps the unregularized
  terms (scripts/2-cilqr-motionplanning.py:310-320); Q_uu is inverted in
  closed form by its determinant, as the JAX package does;
- a fixed line-search schedule alpha in {1, .5, .25, .125, .0625}: every
  trial is rolled out and costed, and the first with new_J < J is taken
  (:354-362);
- simple ellipse inflation a = len/2 + d_safe + r (scripts/utils/
  kinematic.py:108-112, no 6x major-axis quirk), per-obstacle attributes;
- a reference yaw target of 0 and no road-border constraints (:96-100);
- the k = 0 state row receives barrier derivative terms although the cost
  sums k = 1..N (:181 against :109);
- the nearest waypoint is the first minimum of a global argmin over the
  whole waypoint list (scripts/utils/kinematic.py:69-75);
- J carried across iterations, the exit on |dJ| < tol or a lambda overflow
  (``done = conv | overflow``), lambda decay/amplify on success/failure
  (:364-393).

Everything is batched-first: u (B, N, 2), x (B, N+1, 4). The scenario
tensors (waypoints (P, 2), ref_velo, obstacle attributes (M, 3) and
predictions (M, N+1, 4)) are shared by the rows or carry the leading B
axis themselves. ``solve`` runs an iteration while any row is active and
freezes each row at its own exit, as the JAX package's ``while_loop`` does
under ``vmap``. The horizon is not capped (N = 60 in the demo).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.bicycle import (
    GRAVITY_CENTER,
    const_velo_prediction,
    front_rear_center_jacobians,
    front_rear_centers,
    kinematic_jacobians,
    kinematic_propagate,
    rollout,
)
from ilqr_tpu_torch.ops.constraints import (
    ellipsoid_safety_margin,
    ellipsoid_safety_margin_grad,
    exp_barrier_coeffs,
)

# the script's constants (scripts/2-cilqr-motionplanning.py:44-80)
_DEFAULTS = dict(
    dt=0.1, wheelbase=3.6, width=2.0, state_weight=[1.0, 1.0, 0.5, 0.0],
    ctrl_weight=[1.0, 1.0], exp_q1=5.5, exp_q2=5.75, init_lamb=20.0, lamb_decay=0.7,
    lamb_amplify=2.0, max_lamb=10000.0, tol=1e-3, velo_max=10.0, velo_min=0.0, acc_max=2.0,
    acc_min=-2.0, stl_lim=1.57)


@dataclasses.dataclass(frozen=True)
class DemoCILQRParams:
    """Tunables of the demo planner, each a tensor of the working dtype."""

    dt: torch.Tensor
    wheelbase: torch.Tensor
    width: torch.Tensor
    state_weight: torch.Tensor  # (4,) diag
    ctrl_weight: torch.Tensor  # (2,) diag
    exp_q1: torch.Tensor
    exp_q2: torch.Tensor
    init_lamb: torch.Tensor
    lamb_decay: torch.Tensor
    lamb_amplify: torch.Tensor
    max_lamb: torch.Tensor
    tol: torch.Tensor
    velo_max: torch.Tensor
    velo_min: torch.Tensor
    acc_max: torch.Tensor
    acc_min: torch.Tensor
    stl_lim: torch.Tensor

    @classmethod
    def from_numpy(cls, d: dict, dtype=torch.float64, device="cpu") -> "DemoCILQRParams":
        """From ``{field: array}`` (the JAX package's params as numpy)."""
        return cls(**{f.name: torch.tensor(np.array(d[f.name], dtype=np.float64),
                                              dtype=dtype, device=device)
                      for f in dataclasses.fields(cls)})

    @classmethod
    def default(cls, dtype=torch.float64, device="cpu") -> "DemoCILQRParams":
        return cls.from_numpy(_DEFAULTS, dtype=dtype, device=device)


ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)


def _scene(B, ref_waypoints, ref_velo, obs_attrs, obs_preds):
    """The scenario tensors with the leading B axis (views where shared)."""
    ref_velo = torch.as_tensor(ref_velo)
    return (ref_waypoints.expand(B, *ref_waypoints.shape[-2:]),
            ref_velo.to(ref_waypoints.device).expand(B),
            obs_attrs.expand(B, *obs_attrs.shape[-2:]),
            obs_preds.expand(B, *obs_preds.shape[-3:]))


def _ellipse_ab(obs_attr, ego_radius):
    """a = len/2 + d_safe + r, b = width/2 + d_safe + r (simple inflation)."""
    width, length, d_safe = obs_attr[..., 0], obs_attr[..., 1], obs_attr[..., 2]
    return length * 0.5 + d_safe + ego_radius, width * 0.5 + d_safe + ego_radius


def _nearest_waypoints(pos, ref_waypoints):
    """First-min global argmin over the waypoints: pos (B, K, 2),
    ref_waypoints (B, P, 2) -> (B, K, 2) (scripts/utils/kinematic.py:69-75)."""
    dx = pos[..., 0:1] - ref_waypoints[:, None, :, 0]
    dy = pos[..., 1:2] - ref_waypoints[:, None, :, 1]
    idx = torch.argmin(dx * dx + dy * dy, dim=-1)
    return torch.gather(ref_waypoints, 1, idx[..., None].expand(-1, -1, 2))


def _ref_states(x, ref_waypoints, ref_velo):
    """(B, K, 4) tracking target [nearest x, nearest y, ref_velo, 0]."""
    ref_xy = _nearest_waypoints(x[..., :2], ref_waypoints)
    v = ref_velo.to(x.dtype)[:, None, None].expand(-1, x.shape[1], 1)
    return torch.cat([ref_xy, v, torch.zeros_like(v)], dim=-1)


def _obs3(obs_preds):
    """[x, y, yaw] of (..., 4) [x, y, v, yaw] predictions."""
    return torch.cat([obs_preds[..., :2], obs_preds[..., 3:4]], dim=-1)


def _obs_margins(p: DemoCILQRParams, x, obs_attrs, obs_preds_k):
    """Front/rear margins (B, M, K) of state rows x (B, K, 4) against the
    obstacles' predicted states obs_preds_k (B, M, K, 4)."""
    front, rear = front_rear_centers(x, p.wheelbase, GRAVITY_CENTER)
    a, b = _ellipse_ab(obs_attrs, 0.5 * p.width)  # (B, M)
    ab = (a[..., None], b[..., None])
    obs3 = _obs3(obs_preds_k)
    return (ellipsoid_safety_margin(front[:, None], obs3, ab),
            ellipsoid_safety_margin(rear[:, None], obs3, ab))


def total_cost(p: DemoCILQRParams, u, x, ref_waypoints, ref_velo, obs_attrs, obs_preds):
    """(B,) J (scripts/2-cilqr-motionplanning.py:91-156)."""
    ref_waypoints, ref_velo, obs_attrs, obs_preds = _scene(
        u.shape[0], ref_waypoints, ref_velo, obs_attrs, obs_preds)
    dxs = x - _ref_states(x, ref_waypoints, ref_velo)
    J = (dxs * dxs * p.state_weight).sum(dim=(1, 2)) + (u * u * p.ctrl_weight).sum(dim=(1, 2))

    def bar(c):
        return p.exp_q1 * torch.exp(p.exp_q2 * c)

    # bound constraints at k = 1..N (controls align with u[k-1])
    J = J + (bar(u[..., 0] - p.acc_max) + bar(p.acc_min - u[..., 0])
             + bar(u[..., 1] - p.stl_lim) + bar(-p.stl_lim - u[..., 1])).sum(dim=1)
    v = x[:, 1:, 2]
    J = J + (bar(v - p.velo_max) + bar(p.velo_min - v)).sum(dim=1)
    cf, cr = _obs_margins(p, x[:, 1:], obs_attrs, obs_preds[:, :, 1:])
    return J + (bar(cf) + bar(cr)).sum(dim=(1, 2))


def cost_derivatives(p: DemoCILQRParams, u, x, ref_waypoints, ref_velo, obs_attrs, obs_preds):
    """(l_x (B,N+1,4), l_u (B,N,2), l_xx (B,N+1,4,4), l_uu (B,N,2,2))
    (scripts/2-cilqr-motionplanning.py:159-278). The k = 0 state row *does*
    receive barrier terms here, unlike the cost."""
    B, N = u.shape[0], u.shape[1]
    ref_waypoints, ref_velo, obs_attrs, obs_preds = _scene(
        B, ref_waypoints, ref_velo, obs_attrs, obs_preds)
    l_u = 2.0 * u * p.ctrl_weight
    l_x = 2.0 * (x - _ref_states(x, ref_waypoints, ref_velo)) * p.state_weight
    l_uu = torch.diag(2.0 * p.ctrl_weight).expand(B, N, 2, 2)
    l_xx = torch.diag(2.0 * p.state_weight).expand(B, N + 1, 4, 4)

    def coeffs(c):
        return exp_barrier_coeffs(c, p.exp_q1, p.exp_q2)[1:]

    # control bounds (gradients +-e0 / +-e1)
    g_au, h_au = coeffs(u[..., 0] - p.acc_max)
    g_al, h_al = coeffs(p.acc_min - u[..., 0])
    g_su, h_su = coeffs(u[..., 1] - p.stl_lim)
    g_sl, h_sl = coeffs(-p.stl_lim - u[..., 1])
    l_u = l_u + torch.stack([g_au - g_al, g_su - g_sl], dim=-1)
    zero = torch.zeros_like(h_au)
    l_uu = l_uu + torch.stack([torch.stack([h_au + h_al, zero], dim=-1),
                               torch.stack([zero, h_su + h_sl], dim=-1)], dim=-2)

    # velocity bounds over ALL k = 0..N (the demo's k = 0 quirk)
    g_vu, h_vu = coeffs(x[..., 2] - p.velo_max)
    g_vl, h_vl = coeffs(p.velo_min - x[..., 2])
    l_x[..., 2] += g_vu - g_vl
    l_xx = l_xx.clone()
    l_xx[..., 2, 2] += h_vu + h_vl

    # obstacles over ALL k = 0..N
    front, rear = front_rear_centers(x, p.wheelbase, GRAVITY_CENTER)
    jf, jr = front_rear_center_jacobians(x[..., 3], p.wheelbase, GRAVITY_CENTER)  # (B,K,4,2)
    a, b = _ellipse_ab(obs_attrs, 0.5 * p.width)
    ab = (a[..., None], b[..., None])
    obs3 = _obs3(obs_preds)
    for pnt, jac in ((front, jf), (rear, jr)):
        c = ellipsoid_safety_margin(pnt[:, None], obs3, ab)  # (B, M, K)
        gp = ellipsoid_safety_margin_grad(pnt[:, None], obs3, ab)  # (B, M, K, 2)
        g4 = (jac[:, None] * gp[..., None, :]).sum(dim=-1)  # (B, M, K, 4)
        _, gam, eta = exp_barrier_coeffs(c, p.exp_q1, p.exp_q2)
        l_x = l_x + (gam[..., None] * g4).sum(dim=1)
        l_xx = l_xx + (eta[..., None, None] * g4[..., :, None] * g4[..., None, :]).sum(dim=1)
    return l_x, l_u, l_xx, l_uu


class DemoSolveResult(NamedTuple):
    u: Any
    x: Any
    J: Any
    iters: Any
    converged: Any


def backward_pass(p: DemoCILQRParams, u, x, lamb, ref_waypoints, ref_velo, obs_attrs,
                  obs_preds):
    """Riccati recursion of the demo solver (scripts/2-cilqr-motionplanning.py:
    281-325); lamb (B,). Returns (d (B,N,2), K (B,N,2,4))."""
    N = u.shape[1]
    l_x, l_u, l_xx, l_uu = cost_derivatives(p, u, x, ref_waypoints, ref_velo, obs_attrs,
                                            obs_preds)
    A, Bm = kinematic_jacobians(x[:, :-1], u, p.dt, p.wheelbase, GRAVITY_CENTER)
    lamb = lamb[:, None, None]
    V_x = l_x[:, N, :, None]
    V_xx = l_xx[:, N]
    d = u.new_empty(u.shape)
    K = u.new_empty((*u.shape, 4))
    for i in range(N - 1, -1, -1):
        A_i, B_i = A[:, i], Bm[:, i]
        At, Bt = A_i.transpose(-1, -2), B_i.transpose(-1, -2)
        Q_x = l_x[:, i, :, None] + At @ V_x
        Q_u = l_u[:, i, :, None] + Bt @ V_x
        Q_xx = l_xx[:, i] + At @ V_xx @ A_i
        Q_uu = l_uu[:, i] + Bt @ V_xx @ B_i
        Q_ux = Bt @ V_xx @ A_i
        # model-space regularization (:310-312)
        Bt_reg = Bt * lamb
        Q_ux_r = Q_ux + Bt_reg @ A_i
        Q_uu_r = Q_uu + Bt_reg @ B_i
        q00, q01 = Q_uu_r[:, 0, 0], Q_uu_r[:, 0, 1]
        q10, q11 = Q_uu_r[:, 1, 0], Q_uu_r[:, 1, 1]
        det = q00 * q11 - q01 * q10
        inv = torch.stack([torch.stack([q11, -q01], dim=-1),
                           torch.stack([-q10, q00], dim=-1)], dim=-2) / det[:, None, None]
        d_i = -(inv @ Q_u)
        K_i = -(inv @ Q_ux_r)
        # value recursion with the UNregularized terms (:319-320)
        Kt, Q_uxt = K_i.transpose(-1, -2), Q_ux.transpose(-1, -2)
        V_x = Q_x + Kt @ Q_uu @ d_i + Kt @ Q_u + Q_uxt @ d_i
        V_xx = Q_xx + Kt @ Q_uu @ K_i + Kt @ Q_ux + Q_uxt @ K_i
        d[:, i] = d_i[..., 0]
        K[:, i] = K_i
    return d, K


def forward_pass(p: DemoCILQRParams, u, x, d, K, alpha):
    """Line-search rollout (scripts/2-cilqr-motionplanning.py:328-343; its
    get_bounded_ctrl is a no-op stub, scripts/utils/constraint.py:68):
    u'_i = u_i + alpha d_i + K_i (x'_i - x_i)."""
    cur = x[:, 0]
    nus, nxs = [], [cur]
    for i in range(u.shape[1]):
        nu = u[:, i] + alpha * d[:, i] + (K[:, i] @ (cur - x[:, i])[..., None])[..., 0]
        cur = kinematic_propagate(cur, nu, p.dt, p.wheelbase, GRAVITY_CENTER)
        nus.append(nu)
        nxs.append(cur)
    return torch.stack(nus, dim=1), torch.stack(nxs, dim=1)


def iter_step(p: DemoCILQRParams, u, x, J, lamb, ref_waypoints, ref_velo, obs_attrs,
              obs_preds):
    """One iteration: backward pass + the fixed-alpha line search, taking
    each row's first J-improving trial (scripts/2-cilqr-motionplanning.py:
    346-362). Returns (new_u, new_x, new_J, effective)."""
    scene = (ref_waypoints, ref_velo, obs_attrs, obs_preds)
    d, K = backward_pass(p, u, x, lamb, *scene)
    hit = torch.zeros_like(J, dtype=torch.bool)
    bu, bx, bj = u, x, J
    for alpha in ALPHAS:
        nu, nx = forward_pass(p, u, x, d, K, alpha)
        nJ = total_cost(p, nu, nx, *scene)
        take = ~hit & (nJ < J)
        bu = torch.where(take[:, None, None], nu, bu)
        bx = torch.where(take[:, None, None], nx, bx)
        bj = torch.where(take, nJ, bj)
        hit = hit | take
    return bu, bx, bj, hit


def solve(p: DemoCILQRParams, x0, ref_waypoints, ref_velo, obs_attrs, obs_preds,
          max_iter: int = 50) -> DemoSolveResult:
    """scripts/2-cilqr-motionplanning.py:364-393 for x0 (B, 4), or (4,) for
    one solve (then the result has no B axis)."""
    single = x0.dim() == 1
    x0 = x0.reshape(-1, 4)
    Bn, N = x0.shape[0], obs_preds.shape[-2] - 1
    scene = (ref_waypoints, ref_velo, obs_attrs, obs_preds)
    u = x0.new_zeros((Bn, N, 2))
    x = rollout(x0, u, p.dt, p.wheelbase, GRAVITY_CENTER)
    J = total_cost(p, u, x, *scene)
    lamb = p.init_lamb.to(x0.dtype).expand(Bn).clone()
    it = torch.zeros(Bn, dtype=torch.int32, device=x0.device)
    done = torch.zeros(Bn, dtype=torch.bool, device=x0.device)
    conv = torch.zeros_like(done)
    for _ in range(max_iter):
        active = ~done
        if not bool(active.any()):
            break
        nu, nx, nJ, eff = iter_step(p, u, x, J, lamb, *scene)
        conv_now = active & eff & ((nJ - J).abs() < p.tol)
        u = torch.where((active & eff)[:, None, None], nu, u)
        x = torch.where((active & eff)[:, None, None], nx, x)
        J = torch.where(active & eff, nJ, J)
        lamb2 = torch.where(eff, lamb * p.lamb_decay, lamb * p.lamb_amplify)
        overflow = active & ~eff & (lamb2 > p.max_lamb)
        lamb = torch.where(active, lamb2, lamb)
        it = it + active.to(torch.int32)
        done = done | conv_now | overflow
        conv = conv | conv_now
    res = DemoSolveResult(u, x, J, it, conv)
    return DemoSolveResult(*(t[0] for t in res)) if single else res


def _line_x(length: float, num: int, dtype, device):
    """``jnp.linspace(0, length, num)`` rounded as XLA folds it:
    i * (length * (1 / (num - 1))), then the end point."""
    i = torch.arange(num - 1, dtype=torch.float64, device=device)
    out = torch.cat([i * (length * (1.0 / (num - 1))),
                     torch.tensor([length], dtype=torch.float64, device=device)])
    return out.to(dtype)


def demo_scenario(dtype=torch.float64, device="cpu"):
    """The shipped demo problem (scripts/2-cilqr-motionplanning.py:453-468):
    a straight 1000-point reference and two constant-velocity obstacles, N =
    60. Returns (p, x0 (4,), ref (1000, 2), ref_velo, obs_attrs (2, 3),
    obs_preds (2, 61, 4))."""
    N = 60
    p = DemoCILQRParams.default(dtype, device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    x0 = t([0.0, 0.0, 5.0, 0.0])
    ref = torch.stack([_line_x(50.0, 1000, dtype, device),
                       torch.zeros(1000, dtype=dtype, device=device)], dim=-1)
    obs_attrs = t([[2.0, 4.5, 1.5], [2.0, 4.5, 1.5]])
    obs_preds = torch.stack([
        const_velo_prediction(t([6.5, -0.2, 3.0, 0.0]), N, p.dt, p.wheelbase),
        const_velo_prediction(t([20.0, 4.0, 2.0, 0.0]), N, p.dt, p.wheelbase)])
    return p, x0, ref, t(6.0), obs_attrs, obs_preds
