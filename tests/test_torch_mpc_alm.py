"""ALM episodes of ``run_mpc_kernel`` against ``ilqr_tpu``'s ``run_mpc_scan``.

On CPU tensors ``run_mpc_kernel`` runs the plain version of the fused
solve, so this holds the port's carry of the ALM duals (mu, rho) across
ticks to the JAX scan's carry in float64 -- the port's counterpart of
``test_kernel_mpc_alm_warm_start_matches_scan``, at its sizes (N = 6,
max_iter 6, 2 rows, 3 ticks). Bars: per-tick iteration counts and statuses
exact, ego states and controls within 1e-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.sim.mpc import run_mpc_scan
from ilqr_tpu.sim.scenario import perturbed_initial_states
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel

from tests.torch_parity import TOL, W_BACK, WINDOW, load_both, port_config, port_weights, t64


@pytest.mark.parametrize("name", ["scenario_two_borrow", "scenario_three_straight"])
def test_alm_warm_episode_matches_jax_scan(name):
    """``run_mpc_kernel`` in ALM mode with ``use_last_solution``: the duals
    ride across ticks as the JAX scan's carry does. two_borrow has rho_init
    20; three_straight has rho_init 0, where mu / rho = NaN switches every
    penalty off in both packages."""
    jgc, jst, _, st = load_both(name)
    jcfg = dataclasses.replace(JaxConfig.from_global_config(jgc, max_iter=6), N=6,
                               solve_type="alm", use_last_solution=True)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    B, ticks = 2, 3
    x0 = perturbed_initial_states(jst.ego_x0, B, seed=3)
    obs = st.obs_preds_array()
    sc = st.device_scenario(tick=0, dtype=torch.float64, batch=B)
    jsc = jst.device_scenario(tick=0, dtype=jnp.float64)
    scan_b = jax.vmap(lambda x: run_mpc_scan(jcfg, jw, x, jsc.ref_line, jsc.ref_velo,
                                             jnp.asarray(obs), jsc.road_borders, ticks))
    ego_r, us_r, st_r = scan_b(jnp.asarray(x0))
    ego, us, stats, (mu, rho) = run_mpc_kernel(
        port_config(jcfg), port_weights(jw), t64(x0), sc.ref_line, sc.ref_velo,
        t64(obs).expand(B, -1, -1, -1), sc.road_borders, ticks, window=WINDOW,
        w_back=W_BACK, return_alm=True)
    np.testing.assert_array_equal(stats.iters.numpy(), np.asarray(st_r.iters).T)
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(st_r.status).T)
    np.testing.assert_allclose(ego.numpy(), np.moveaxis(np.asarray(ego_r), 0, 1), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(us.numpy(), np.moveaxis(np.asarray(us_r), 0, 1), rtol=0,
                               atol=TOL)
    assert bool(torch.isfinite(mu).all())
    if float(jw.alm_rho_init) == 0:
        assert not bool(rho.any()) and not bool(mu.any())
