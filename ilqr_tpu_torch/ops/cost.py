"""Total cost and derivative assembly, batched over scenarios and the horizon.

Counterpart of ``ilqr_tpu/ops/cost.py`` (reference
src/cilqr_solver.cpp:199-287 and :463-690). Shapes carry a leading batch
axis B: u (B, N, 2), x (B, N+1, 4). Constraint column order matches the
reference's ALM dual layout (src/cilqr_solver.cpp:622-676):
  0 acc_up, 1 acc_lo, 2 stl_up, 3 stl_lo,
  4 velo_up, 5 velo_lo, 6 pos_up, 7 pos_lo,
  8+2j obs_j_front, 9+2j obs_j_rear.

``row_limits`` (optional, (N+1,) integers) bounds each step's nearest-point
search to the first rows of ``scenario.ref_line``, and ``modes`` picks the
fused solve's projection mode (``Modes``, see ops/projection.py);
``cfg.projection`` ("exact" or "hier") the search itself.

A weight of ``w`` may be 0-d or (B,), one value per row (``types.per_row``,
``types.stack_last``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_tpu_torch.ops import constraints as C
from ilqr_tpu_torch.ops.projection import Modes, nearest_ref_points
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, per_row, stack_last


class CostDerivatives(NamedTuple):
    l_x: torch.Tensor  # (B, N+1, 4)
    l_u: torch.Tensor  # (B, N, 2)
    l_xx: torch.Tensor  # (B, N+1, 4, 4)
    l_uu: torch.Tensor  # (B, N, 2, 2)
    alm_mu_next: torch.Tensor  # (B, N, C)


def _ref_states(cfg: CILQRConfig, x, scenario, row_limits, modes):
    """Nearest ref rows + the (B, N+1, 4) tracking target [rx, ry, v_ref, ryaw]
    (reference src/cilqr_solver.cpp:205-209)."""
    ref_pts = nearest_ref_points(x[..., :2], scenario.ref_line, row_limits, modes,
                                 cfg.projection)[..., :3]
    v_ref = scenario.ref_velo.to(x.dtype)[:, None].expand(-1, x.shape[1])
    ref_states = torch.stack([ref_pts[..., 0], ref_pts[..., 1], v_ref, ref_pts[..., 2]],
                             dim=-1)
    return ref_pts, ref_states


def _constraint_values(cfg: CILQRConfig, w: CILQRWeights, u, x, ref_pts, scenario):
    """(c_u (B,N,4), c_x (B,N,4), c_obs (B,N,2M)) at steps k = 1..N."""
    xk = x[:, 1:]
    rk = ref_pts[:, 1:]
    rb = scenario.road_borders.to(x.dtype)
    stl_lim = per_row(w.stl_lim, 2)
    c_u = torch.stack([
        C.upper_bound_constr(u[..., 0], per_row(w.acc_max, 2)),
        C.lower_bound_constr(u[..., 0], per_row(w.acc_min, 2)),
        C.upper_bound_constr(u[..., 1], stl_lim),
        C.lower_bound_constr(u[..., 1], -stl_lim),
    ], dim=-1)
    cur_d, _ = C.lateral_offset(xk, rk)
    width = per_row(w.width, 2)
    c_x = torch.stack([
        C.upper_bound_constr(xk[..., 2], per_row(w.velo_max, 2)),
        C.lower_bound_constr(xk[..., 2], per_row(w.velo_min, 2)),
        C.upper_bound_constr(cur_d, rb[:, 0:1] - width / 2),
        C.lower_bound_constr(cur_d, rb[:, 1:2] + width / 2),
    ], dim=-1)
    B, N = u.shape[0], cfg.N
    if cfg.num_obstacles > 0:
        obs_k = scenario.obs_preds[:, :, 1:, :].to(x.dtype)  # (B, M, N, 3)
        front, rear = C.obstacle_avoidance_constr(
            xk[:, None], obs_k, *_obstacle_weights(w), cfg.reference_point)  # each (B, M, N)
        # interleave -> (B, N, 2M): col 2j front_j, 2j+1 rear_j
        c_obs = torch.stack([front, rear], dim=-1).permute(0, 2, 1, 3)
        c_obs = c_obs.reshape(B, N, 2 * cfg.num_obstacles)
    else:
        c_obs = x.new_zeros((B, N, 0))
    return c_u, c_x, c_obs


def _obstacle_weights(w: CILQRWeights):
    """(wheelbase, width, length, d_safe) as factors of the (B, M, N) obstacle
    terms."""
    return tuple(per_row(t, 3) for t in (w.wheelbase, w.width, w.length, w.d_safe))


def _columns(state_q, obstacle_q, M: int):
    """A barrier weight per constraint column, as a factor of the (B, N, C)
    constraint values: (1, C), or (B, 1, C) when either weight is per row."""
    return stack_last([state_q] * 8 + [obstacle_q] * (2 * M)).unsqueeze(-2)


def _penalty_coeffs(cfg: CILQRConfig, w: CILQRWeights, c_all, alm_rho, alm_mu):
    """(value, gamma, eta) each (B, N, C) for the active penalty family."""
    if cfg.solve_type == "alm":
        return C.alm_coeffs(c_all, alm_rho[:, None, None], alm_mu)
    M = cfg.num_obstacles
    q1 = _columns(w.state_exp_q1, w.obstacle_exp_q1, M)
    q2 = _columns(w.state_exp_q2, w.obstacle_exp_q2, M)
    return C.exp_barrier_coeffs(c_all, q1, q2, per_row(w.exp_clip, 3))


def _prime_cost(w: CILQRWeights, u, x, ref_states):
    dxs = x - ref_states
    sdiag, cdiag = w.state_weight_diag.unsqueeze(-2), w.ctrl_weight_diag.unsqueeze(-2)
    return (dxs * dxs * sdiag).sum(dim=(1, 2)) + (u * u * cdiag).sum(dim=(1, 2))


def total_cost(cfg: CILQRConfig, w: CILQRWeights, u, x, scenario,
               alm_rho=None, alm_mu=None, row_limits=None, modes: Modes = Modes()):
    """(B,) J = quadratic tracking + control energy + penalty terms
    (reference src/cilqr_solver.cpp:199-287)."""
    ref_pts, ref_states = _ref_states(cfg, x, scenario, row_limits, modes)
    c_all = torch.cat(_constraint_values(cfg, w, u, x, ref_pts, scenario), dim=-1)
    value, _, _ = _penalty_coeffs(cfg, w, c_all, alm_rho, alm_mu)
    return _prime_cost(w, u, x, ref_states) + value.sum(dim=(1, 2))


def cost_and_derivatives(cfg: CILQRConfig, w: CILQRWeights, u, x, scenario,
                         alm_rho=None, alm_mu=None, row_limits=None,
                         modes: Modes = Modes()):
    """(J (B,), CostDerivatives) in one pass (reference
    src/cilqr_solver.cpp:199-287 and :463-690), sharing the projection,
    constraint values and penalty coefficients."""
    N, M = cfg.N, cfg.num_obstacles
    B = x.shape[0]
    ref_pts, ref_states = _ref_states(cfg, x, scenario, row_limits, modes)
    xk = x[:, 1:]
    rk = ref_pts[:, 1:]

    # prime-objective terms (src/cilqr_solver.cpp:491-494)
    # each diagonal (K,) or per row (B, K), as (1, K) or (B, 1, K)
    sdiag, cdiag = w.state_weight_diag.unsqueeze(-2), w.ctrl_weight_diag.unsqueeze(-2)
    l_u_prime = 2.0 * u * cdiag
    l_x_prime = 2.0 * (x - ref_states) * sdiag
    l_uu_prime = torch.diag_embed(2.0 * cdiag).expand(B, N, 2, 2)
    l_xx_prime = torch.diag_embed(2.0 * sdiag).expand(B, N + 1, 4, 4)

    c_u, c_x, c_obs = _constraint_values(cfg, w, u, x, ref_pts, scenario)
    c_all = torch.cat([c_u, c_x, c_obs], dim=-1)

    # gradient directions
    g_u = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
                       dtype=x.dtype, device=x.device).expand(B, N, 4, 2)
    g_pos_up = C.lateral_offset_grad(xk, rk)  # (B, N, 4)
    vel_grad = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=x.dtype,
                            device=x.device).expand(B, N, 4)
    g_x = [vel_grad, -vel_grad, g_pos_up, -g_pos_up]
    if M > 0:
        obs_k = scenario.obs_preds[:, :, 1:, :].to(x.dtype)
        gf, gr = C.obstacle_avoidance_constr_grads(
            xk[:, None], obs_k, *_obstacle_weights(w), cfg.reference_point)  # each (B, M, N, 4)
        g_obs = torch.stack([gf, gr], dim=-2).permute(0, 2, 1, 3, 4)  # (B,N,M,2,4)
        g_x = torch.cat([torch.stack(g_x, dim=2), g_obs.reshape(B, N, 2 * M, 4)], dim=2)
    else:
        g_x = torch.stack(g_x, dim=2)  # (B, N, 4+2M, 4)

    value, gamma, eta = _penalty_coeffs(cfg, w, c_all, alm_rho, alm_mu)
    gamma_u, gamma_x = gamma[..., :4], gamma[..., 4:]
    eta_u, eta_x = eta[..., :4], eta[..., 4:]

    l_u_barrier = torch.einsum("bnc,bnci->bni", gamma_u, g_u)
    l_uu_barrier = torch.einsum("bnc,bnci,bncj->bnij", eta_u, g_u, g_u)
    l_x_barrier_k = torch.einsum("bnc,bnci->bni", gamma_x, g_x)
    l_xx_barrier_k = torch.einsum("bnc,bnci,bncj->bnij", eta_x, g_x, g_x)

    # barrier terms live at steps 1..N; step 0 carries only the prime term
    l_x = l_x_prime.clone()
    l_x[:, 1:] += l_x_barrier_k
    l_xx = l_xx_prime.clone()
    l_xx[:, 1:] += l_xx_barrier_k
    l_u = l_u_prime + l_u_barrier
    l_uu = l_uu_prime + l_uu_barrier

    if cfg.solve_type == "alm":
        mu_next = C.alm_mu_next(c_all, alm_rho[:, None, None], alm_mu, per_row(w.max_mu, 3))
    else:
        mu_next = x.new_zeros((B, N, cfg.num_constraints))

    J = _prime_cost(w, u, x, ref_states) + value.sum(dim=(1, 2))
    return J, CostDerivatives(l_x, l_u, l_xx, l_uu, mu_next)


def cost_derivatives(cfg: CILQRConfig, w: CILQRWeights, u, x, scenario,
                     alm_rho=None, alm_mu=None, row_limits=None,
                     modes: Modes = Modes()) -> CostDerivatives:
    """l_x, l_u, l_xx, l_uu (+ ALM dual precompute): the derivatives of
    :func:`cost_and_derivatives`."""
    return cost_and_derivatives(cfg, w, u, x, scenario, alm_rho, alm_mu, row_limits, modes)[1]
