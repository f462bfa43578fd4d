"""The port's ops against ``ilqr_tpu``'s in float64, on the same numpy inputs.

Bar: 1e-10 absolute. Both sides evaluate the same float64 formulas; they
differ only in the order of a few sums and in the last ulp of libm
transcendentals, which stays far below 1e-10 at these magnitudes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.models import bicycle as jbic
from ilqr_tpu.ops import constraints as jcon
from ilqr_tpu.ops import cost as jcost
from ilqr_tpu.ops import projection as jproj
from ilqr_tpu.ops import riccati as jric
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.models import bicycle as bic
from ilqr_tpu_torch.ops import constraints as con
from ilqr_tpu_torch.ops import cost
from ilqr_tpu_torch.ops import projection as proj
from ilqr_tpu_torch.ops import riccati as ric

from tests.torch_parity import load_both, port_config, port_weights, t64

TOL = 1e-10
REF_POINTS = ["rear_center", "gravity_center"]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


def _states(rng, shape):
    x = rng.normal(size=shape + (4,)) * np.array([5.0, 2.0, 2.0, 0.3])
    x[..., 2] += 8.0
    u = rng.normal(size=shape + (2,)) * np.array([1.0, 0.08])
    return x, u


@pytest.mark.parametrize("ref_point", REF_POINTS)
def test_bicycle_propagate_and_jacobians(ref_point, rng):
    x, u = _states(rng, (3, 7))
    close(bic.kinematic_propagate(t64(x), t64(u), 0.1, 2.8, ref_point),
          jbic.kinematic_propagate(jnp.asarray(x), jnp.asarray(u), 0.1, 2.8, ref_point))
    A, B = bic.kinematic_jacobians(t64(x), t64(u), 0.1, 2.8, ref_point)
    jA, jB = jbic.kinematic_jacobians(jnp.asarray(x), jnp.asarray(u), 0.1, 2.8, ref_point)
    close(A, jA)
    close(B, jB)
    x0 = x[:, 0]
    close(bic.rollout(t64(x0), t64(u), 0.1, 2.8, ref_point),
          jax.vmap(lambda a, b: jbic.rollout(a, b, 0.1, 2.8, ref_point))(
              jnp.asarray(x0), jnp.asarray(u)))
    for got, want in zip(bic.front_rear_centers(t64(x), 2.8, ref_point),
                         jbic.front_rear_centers(jnp.asarray(x), 2.8, ref_point)):
        close(got, want)
    for got, want in zip(bic.front_rear_center_jacobians(t64(x[..., 3]), 2.8, ref_point),
                         jbic.front_rear_center_jacobians(jnp.asarray(x[..., 3]), 2.8,
                                                          ref_point)):
        close(got, want)


def test_gravity_center_jacobian_keeps_the_slip_angle_quirk():
    """The Jacobian's beta is atan(tan(stl/2)), not the dynamics'
    atan(tan(stl)/2): a32 = 2 sin(beta) dt / wb with that beta."""
    stl = 0.4
    x = t64([[0.0, 0.0, 8.0, 0.0]])
    u = t64([[0.0, stl]])
    A, _ = bic.kinematic_jacobians(x, u, 0.1, 2.8, "gravity_center")
    quirk = 2.0 * np.sin(np.arctan(np.tan(stl / 2.0))) * 0.1 / 2.8
    dyn = 2.0 * np.sin(np.arctan(np.tan(stl) / 2.0)) * 0.1 / 2.8
    assert abs(float(A[0, 3, 2]) - quirk) < 1e-15
    assert abs(quirk - dyn) > 1e-4


@pytest.mark.parametrize("ref_point", REF_POINTS)
def test_constraints(ref_point, rng):
    x, _ = _states(rng, (5, 6))
    obs = np.concatenate([x[..., :2] + rng.normal(size=(5, 6, 2)) * 3.0,
                          rng.normal(size=(5, 6, 1)) * 0.3], axis=-1)
    ref = np.concatenate([x[..., :2] + rng.normal(size=(5, 6, 2)),
                          rng.normal(size=(5, 6, 1)) * 0.3], axis=-1)
    ref[0, 0, :2] = x[0, 0, :2]  # zero lateral distance: guarded gradient, sign +1
    args = (2.8, 2.0, 4.5, 1.0, ref_point)
    for got, want in zip(con.obstacle_avoidance_constr(t64(x), t64(obs), *args),
                         jcon.obstacle_avoidance_constr(jnp.asarray(x), jnp.asarray(obs),
                                                        *args)):
        close(got, want)
    for got, want in zip(con.obstacle_avoidance_constr_grads(t64(x), t64(obs), *args),
                         jcon.obstacle_avoidance_constr_grads(jnp.asarray(x),
                                                              jnp.asarray(obs), *args)):
        close(got, want)
    for got, want in zip(con.lateral_offset(t64(x), t64(ref)),
                         jcon.lateral_offset(jnp.asarray(x), jnp.asarray(ref))):
        close(got, want)
    close(con.lateral_offset_grad(t64(x), t64(ref)),
          jcon.lateral_offset_grad(jnp.asarray(x), jnp.asarray(ref)))
    c = rng.uniform(-2.0, 1.0, size=(5, 6))  # near-feasible, as on a solve's path
    mu = np.abs(rng.normal(size=(5, 6)))
    q1, q2, clip, rho = t64(5.5), t64(5.75), t64(700.0), t64(20.0)
    for got, want in zip(con.exp_barrier_coeffs(t64(c), q1, q2, clip),
                         jcon.exp_barrier_coeffs(jnp.asarray(c), 5.5, 5.75, 700.0)):
        close(got, want)
    for got, want in zip(con.alm_coeffs(t64(c), rho, t64(mu)),
                         jcon.alm_coeffs(jnp.asarray(c), 20.0, jnp.asarray(mu))):
        close(got, want)
    close(con.alm_mu_next(t64(c), rho, t64(mu), t64(1.5)),
          jcon.alm_mu_next(jnp.asarray(c), 20.0, jnp.asarray(mu), 1.5))
    # the 6 x d_safe major-axis inflation
    assert con.ellipsoid_scales(2.0, 4.5, 1.0, 1.0) == jcon.ellipsoid_scales(2.0, 4.5, 1.0, 1.0)


def test_projection_first_min(rng):
    _, jst, _, st = load_both("scenario_three_bend")
    ref = st.center_lines[0].as_array()
    pos = ref[rng.integers(0, len(ref), size=(3, 11)), :2] + rng.normal(size=(3, 11, 2))
    # a query exactly between two samples ties; both sides pick the first
    pos[0, 0] = 0.5 * (ref[100, :2] + ref[101, :2])
    got = proj.nearest_ref_points(t64(pos), t64(np.broadcast_to(ref, (3,) + ref.shape)))
    want = jax.vmap(lambda p: jproj.nearest_ref_points(p, jnp.asarray(ref)))(jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # row limits: step k searches rows [0, limit[k]) only
    limits = torch.tensor([50 + 10 * k for k in range(11)])
    lim = proj.nearest_ref_points(t64(pos), t64(np.broadcast_to(ref, (3,) + ref.shape)),
                                  limits)
    for k in range(11):
        d2 = ((pos[:, k, None, :] - ref[None, :50 + 10 * k, :2]) ** 2).sum(-1)
        np.testing.assert_array_equal(lim[:, k].numpy(), ref[np.argmin(d2, axis=1)])


def _solver_problem(name, rng, B=3, solve_type=None):
    jgc, jst, _, st = load_both(name)
    jcfg = JaxConfig.from_global_config(jgc)
    if solve_type:
        jcfg = dataclasses.replace(jcfg, solve_type=solve_type)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    N = jcfg.N
    x0 = jst.ego_x0 + rng.normal(size=(B, 4)) * np.array([0.5, 0.2, 0.5, 0.02])
    u = rng.normal(size=(B, N, 2)) * np.array([1.0, 0.05])
    x = np.asarray(jax.vmap(lambda a, b: jbic.rollout(a, b, jw.dt, jw.wheelbase,
                                                      jcfg.reference_point))(
        jnp.asarray(x0), jnp.asarray(u)))
    jsc = jst.device_scenario(tick=2, dtype=jnp.float64)
    sc = st.device_scenario(tick=2, dtype=torch.float64, batch=B)
    rho = np.full(B, 20.0)
    mu = np.abs(rng.normal(size=(B, N, jcfg.num_constraints)))
    return jcfg, jw, port_config(jcfg), port_weights(jw), x, u, jsc, sc, rho, mu


@pytest.mark.parametrize("name,solve_type", [
    ("scenario_two_straight", None),        # rear center, barrier, 3 obstacles
    ("scenario_two_borrow", None),          # gravity center, 4 obstacles
    ("scenario_three_straight", "alm"),     # ALM penalty family, 8 obstacles
])
def test_cost_and_derivatives(name, solve_type, rng):
    jcfg, jw, cfg, w, x, u, jsc, sc, rho, mu = _solver_problem(name, rng,
                                                               solve_type=solve_type)
    J, der = cost.cost_and_derivatives(cfg, w, t64(u), t64(x), sc, t64(rho), t64(mu))
    jf = jax.jit(jax.vmap(
        lambda uu, xx, r, m: jcost.cost_and_derivatives(jcfg, jw, uu, xx, jsc, r, m)))
    jJ, jder = jf(jnp.asarray(u), jnp.asarray(x), jnp.asarray(rho), jnp.asarray(mu))
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=TOL)
    for got, want in zip(der, jder):
        close(got, want)
    tc = cost.total_cost(cfg, w, t64(u), t64(x), sc, t64(rho), t64(mu))
    jtc = jax.jit(jax.vmap(lambda uu, xx, r, m: jcost.total_cost(jcfg, jw, uu, xx, jsc, r, m)))(
        jnp.asarray(u), jnp.asarray(x), jnp.asarray(rho), jnp.asarray(mu))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jtc), rtol=TOL)


@pytest.mark.parametrize("name", ["scenario_two_straight", "scenario_two_borrow"])
def test_riccati_backward_and_forward(name, rng):
    jcfg, jw, cfg, w, x, u, jsc, sc, rho, mu = _solver_problem(name, rng)
    _, der = cost.cost_and_derivatives(cfg, w, t64(u), t64(x), sc)
    A, B = bic.kinematic_jacobians(t64(x[:, :-1]), t64(u), w.dt, w.wheelbase,
                                   cfg.reference_point)
    lamb = np.array([0.0, 1.0, 64.0])
    bw = ric.backward_pass(A, B, der.l_x, der.l_u, der.l_xx, der.l_uu, t64(lamb))
    jbw = jax.jit(jax.vmap(jric.backward_pass))(*(jnp.asarray(a.numpy()) for a in (
        A, B, der.l_x, der.l_u, der.l_xx, der.l_uu)), jnp.asarray(lamb))
    for got, want in zip(bw, jbw):
        close(got, want)
    for alpha in (1.0, 0.125):
        nu, nx = ric.forward_pass(t64(u), t64(x), bw.d, bw.K, alpha, w.dt, w.wheelbase,
                                  cfg.reference_point)
        jnu, jnx = jax.vmap(lambda uu, xx, dd, kk: jric.forward_pass(
            uu, xx, dd, kk, alpha, jw.dt, jw.wheelbase, jcfg.reference_point))(
            jnp.asarray(u), jnp.asarray(x), jnp.asarray(bw.d.numpy()),
            jnp.asarray(bw.K.numpy()))
        close(nu, jnu)
        close(nx, jnx)


def test_backward_pass_flags_non_pd():
    """A negative-definite l_uu latches the failure flag on that row only."""
    N = 3
    A = torch.eye(4, dtype=torch.float64).expand(2, N, 4, 4)
    B = torch.zeros((2, N, 4, 2), dtype=torch.float64)
    l_x = torch.zeros((2, N + 1, 4), dtype=torch.float64)
    l_u = torch.zeros((2, N, 2), dtype=torch.float64)
    l_xx = torch.eye(4, dtype=torch.float64).expand(2, N + 1, 4, 4)
    l_uu = torch.eye(2, dtype=torch.float64).repeat(2, N, 1, 1)
    l_uu[1, 1] = -l_uu[1, 1]
    bw = ric.backward_pass(A, B, l_x, l_u, l_xx, l_uu, torch.zeros(2, dtype=torch.float64))
    assert bw.fail.tolist() == [False, True]
