"""The fused solve's ALM variants and their dual carry, against ``ilqr_tpu``.

On CPU tensors ``cilqr_solve_cuda`` runs the plain version, so these
tests hold the dual I/O of the ALM instantiations (the duals in and out,
and a warm start from given duals) and the plain version to the JAX
package's XLA solver in float64 -- the port's counterparts of the JAX
package's ``test_kernel_alm_*`` tests (the episode carry is in
``tests/test_torch_mpc_alm.py``). Sizes are those of
``tests/test_pallas_kernel.py``. Bars: exact iteration counts and statuses,
everything else within 1e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu.types import CILQRCarry as JaxCarry

from tests.torch_parity import TOL, check_solution, jax_batch, port_solve, small_problem, t64


# (scenario, overrides). The shipped configs rarely exhaust a line search
# at N = 6, so their duals stay at the cold reset; the last case cuts the
# line search to two trials and lets rho grow, so the duals move (mu
# reaches max_mu on some columns, rho grows on some rows).
ALM_CASES = {
    "rear": ("scenario_two_straight", {}),
    "gravity": ("scenario_two_borrow", {}),
    "gravity_duals_move": ("scenario_three_straight", dict(
        min_alpha=0.3,
        weights=dict(alm_rho_init=20.0, alm_gamma=0.3, max_rho=100.0, max_mu=3.0))),
}


@pytest.mark.parametrize("case", list(ALM_CASES))
def test_alm_matches_jax_and_returns_its_carry(case):
    """ALM solve and the returned duals (mu, rho) against the JAX solve's
    carry (the port's ``test_kernel_alm_carry_matches_xla_carry``)."""
    name, kw = ALM_CASES[case]
    jcfg, jw, x0, jsc, cfg, w, sc = small_problem(name, 6, seed=0, max_iter=8,
                                                  solve_type="alm", **kw)
    ju, jx, jstats, jcarry = jax_batch(jcfg, jw, x0, jsc)
    u, x, stats, (mu, rho) = port_solve(cfg, w, x0, sc, return_alm=True)
    check_solution(u, x, stats, ju, jx, jstats)
    assert mu.shape == (6, cfg.N, cfg.num_constraints)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jcarry.alm_rho), rtol=TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jcarry.alm_mu), rtol=0, atol=TOL)
    if case == "gravity_duals_move":
        assert float(mu.max()) == float(w.max_mu) and bool((rho > float(w.alm_rho_init)).any())


@pytest.mark.parametrize("case", list(ALM_CASES))
def test_alm_warm_start_matches_jax(case):
    """A second solve seeded with the first's duals and shifted controls
    equals the JAX solve given the same carry (the port's
    ``test_kernel_alm_warm_start_matches_xla``)."""
    name, kw = ALM_CASES[case]
    jcfg, jw, x0, jsc, cfg, w, sc = small_problem(name, 6, seed=1, max_iter=8,
                                                  solve_type="alm", **kw)
    jcfg = dataclasses.replace(jcfg, use_last_solution=True)
    cfg = dataclasses.replace(cfg, use_last_solution=True)
    # the first solve (held to JAX by the test above), with its duals
    # perturbed so the warm start carries more than the cold reset
    u1, _, _, (mu1, rho1) = port_solve(cfg, w, x0, sc, return_alm=True)
    rng = np.random.default_rng(3)
    mu1 = mu1.numpy() + rng.uniform(0.0, 1.0, tuple(mu1.shape))
    rho1 = rho1.numpy() * rng.uniform(0.5, 1.5, len(x0))
    u1 = u1.numpy()
    carry = JaxCarry(last_u=jnp.asarray(u1), is_first=jnp.zeros((len(x0),), bool),
                     alm_rho=jnp.asarray(rho1), alm_mu=jnp.asarray(mu1))
    ju, jx, jstats, jc2 = jax_batch(jcfg, jw, x0, jsc, carry)
    shifted = t64(np.concatenate([u1[:, 1:], u1[:, -1:]], axis=1))
    u, x, stats, (mu, rho) = port_solve(cfg, w, x0, sc, u_init=shifted, alm_mu0=t64(mu1),
                                        alm_rho0=t64(rho1), return_alm=True)
    check_solution(u, x, stats, ju, jx, jstats)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jc2.alm_rho), rtol=TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jc2.alm_mu), rtol=0, atol=TOL)
