"""The port's eager CILQR solver against ``ilqr_tpu.solvers.cilqr`` in float64.

Bars: iteration counts and statuses exactly equal; u and x within 1e-8
absolute (the bar ``tests/test_cilqr.py`` holds the JAX solver to against
its oracle: sums taken in another order drift by ~1e-13 over a solve). The
goldens are held to their own bar, 1e-10 and exact iteration counts.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.solvers.cilqr import CILQRSolver as JaxSolver
from ilqr_tpu.solvers.cilqr import solve as jax_solve
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.sim.mpc import run_mpc
from ilqr_tpu_torch.solvers.cilqr import CILQRSolver, solve
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.torch_parity import SCENARIOS, load_both, port_config, port_weights, t64

TOL = 1e-8
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _check_batch(stats, u, x, jstats, ju, jx):
    np.testing.assert_array_equal(stats.iters.numpy(), np.asarray(jstats.iters))
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(jstats.status))
    np.testing.assert_array_equal(stats.converged.numpy(), np.asarray(jstats.converged))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=TOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    np.testing.assert_allclose(stats.final_cost.numpy(), np.asarray(jstats.final_cost),
                               rtol=TOL)


@pytest.mark.parametrize("solve_type", ["barrier", "alm"])
def test_batched_solve_matches_jax(solve_type):
    """First tick of scenario_two_straight, a batch of perturbed starts; row
    0 is the nominal start (the oracle-parity case of tests/test_cilqr.py)."""
    jgc, jst, _, st = load_both("scenario_two_straight")
    jcfg = JaxConfig.from_global_config(jgc, solve_type=solve_type)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    B = 4
    x0 = np.stack([jst.ego_x0, jst.ego_x0 + [0.5, 0.1, -0.2, 0.0],
                   jst.ego_x0 + [-1.0, 0.0, 0.3, 0.01], jst.ego_x0 + [0.2, -0.3, 0.6, -0.02]])
    jsc = jax.tree.map(lambda a: jnp.stack([a] * B), jst.device_scenario(tick=0,
                                                                         dtype=jnp.float64))
    ju, jx, jstats, jcarry = jax.jit(jax.vmap(jax_solve, in_axes=(None, None, 0, 0, None)),
                                     static_argnums=0)(jcfg, jw, jnp.asarray(x0), jsc, None)
    sc = st.device_scenario(tick=0, dtype=torch.float64, batch=B)
    u, x, stats, carry = solve(port_config(jcfg), port_weights(jw), t64(x0), sc)
    _check_batch(stats, u, x, jstats, ju, jx)
    np.testing.assert_allclose(carry.alm_rho.numpy(), np.asarray(jcarry.alm_rho), rtol=TOL)
    np.testing.assert_allclose(carry.alm_mu.numpy(), np.asarray(jcarry.alm_mu), atol=TOL)


@pytest.mark.parametrize("name,ticks", [
    ("scenario_two_straight", 3),    # cold ticks, barrier, rear center
    ("scenario_three_straight", 2),  # use_last_solution: shifted u carried; gravity center
])
def test_solver_ticks_match_jax(name, ticks):
    """The OO wrappers over a few receding-horizon ticks (the warm-start
    carry lives in the solver between calls)."""
    jgc, jst, gc, st = load_both(name)
    jsolver = JaxSolver(jgc, dtype=jnp.float64)
    solver = CILQRSolver(gc, dtype=torch.float64, device="cpu")
    assert solver.cfg.use_last_solution == jsolver.cfg.use_last_solution
    obs = st.obs_preds_array()
    ego_j = ego = st.ego_x0.copy()
    for tick in range(ticks):
        window = obs[:, tick: tick + solver.cfg.N + 1]
        args = (st.center_lines[0].as_array(), gc["vehicle/target_velocity"], window,
                st.road_borders)
        ju, jx = jsolver.solve(ego_j, *args)
        u, x = solver.solve(ego, *args)
        np.testing.assert_allclose(u, ju, rtol=0, atol=TOL)
        np.testing.assert_allclose(x, jx, rtol=0, atol=TOL)
        assert int(solver.last_stats.iters) == int(jsolver.last_stats.iters)
        assert int(solver.last_stats.status) == int(jsolver.last_stats.status)
        ego_j, ego = jx[1], x[1]


@pytest.mark.parametrize("name", SCENARIOS)
def test_five_tick_trajectory_matches_golden(name):
    """tests/goldens/*.npz were recorded from the float64 JAX solver."""
    _, _, gc, st = load_both(name)
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float64)
    h = run_mpc(cfg, w, st, ticks=5)
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    np.testing.assert_allclose(h["ego"], g["ego"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(h["u"][:, 0, :], g["u0"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(np.array([int(s.iters) for s in h["stats"]]), g["iters"])


@pytest.mark.parametrize("override", [{"riccati_impl": "pscan"}, {"projection": "hier"}])
def test_unported_options_raise(override):
    """Both options are ported now (held to the JAX package by
    tests/test_torch_riccati_pscan.py and tests/test_torch_projection_hier.py):
    the solve runs with each, and an unknown value of either raises."""
    _, _, gc, st = load_both("scenario_two_straight")
    w = CILQRWeights.from_global_config(gc, dtype=torch.float64)
    x0, sc = t64(st.ego_x0[None]), st.device_scenario(dtype=torch.float64)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=3), **override)
    _, x, stats, _ = solve(cfg, w, x0, sc)
    assert bool(torch.isfinite(x).all()) and int(stats.iters[0]) == 3
    with pytest.raises(ValueError):
        solve(dataclasses.replace(cfg, **{k: "unknown" for k in override}), w, x0, sc)
