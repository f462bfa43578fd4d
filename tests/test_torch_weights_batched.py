"""Per-row weights in the port's eager solver, against the JAX package's
``vmap`` over a batch of weights (the "initial states x yaml params" sweep
axis), in float64; ``solve_batch``; the kernel path's refusal of per-row
weights; and the smaller public names (``alm_item``, ``cost_derivatives``,
the padded ``ReferenceLine.as_array``) against their JAX counterparts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops import constraints as jC
from ilqr_tpu.ops.cost import cost_derivatives as jax_cost_derivatives
from ilqr_tpu.solvers.cilqr import solve_batch as jax_solve_batch
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.models.bicycle import rollout
from ilqr_tpu_torch.ops import constraints as C
from ilqr_tpu_torch.ops.cost import cost_and_derivatives, cost_derivatives
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_scan
from ilqr_tpu_torch.solvers.cilqr import solve, solve_batch
from ilqr_tpu_torch.utils.refline import PAD_COORD
from ilqr_tpu_torch.utils.tree import tree_map

from tests.torch_parity import (
    check_solution,
    load_both,
    port_config,
    port_weights,
    small_problem,
    t64,
)

F64 = torch.float64
ROW_TOL = 1e-9  # a batched row against a single solve with its weights
# the JAX test's sweep (tests/test_cilqr.py:135-162)
W_YAW, STL_LIM = (20.0, 5.0, 80.0), (0.12, 0.3, 0.05)


def _jax_batched(jw, B, **rows):
    """JAX weights with every field stacked B times, ``rows`` replaced."""
    jw_b = jax.tree.map(lambda a: jnp.stack([a] * B), jw)
    return jw_b.replace(**{k: jnp.asarray(v, jnp.float64) for k, v in rows.items()})


def _jax_solve_batch(jcfg, jw, x0, jsc, weights_batched):
    fn = jax.jit(jax_solve_batch, static_argnums=(0, 5))
    return fn(jcfg, jw, jnp.asarray(x0), jsc, None, weights_batched)


def _row(w, i):
    return tree_map(lambda a: a[i] if a.dim() else a, w)


def _check_rows(cfg, w_b, x0, sc, u, x, stats):
    """Each row equals a single solve with that row's weights."""
    for i in range(x0.shape[0]):
        row_sc = tree_map(lambda a: a[i:i + 1], sc)
        u_i, x_i, s_i, _ = solve(cfg, _row(w_b, i), x0[i:i + 1], row_sc)
        np.testing.assert_allclose(u[i].numpy(), u_i[0].numpy(), rtol=0, atol=ROW_TOL)
        np.testing.assert_allclose(x[i].numpy(), x_i[0].numpy(), rtol=0, atol=ROW_TOL)
        assert int(s_i.iters[0]) == int(stats.iters[i])
        assert int(s_i.status[0]) == int(stats.status[i])


@pytest.fixture(scope="module")
def yaml_sweep():
    """The JAX test's case: scenario_two_straight at tick 0, max_iter 15,
    three rows of w_yaw and stl_lim; JAX's ``solve_batch(weights_batched=
    True)`` and the port's config, weights, starts and scenario."""
    jgc, jst, _, st = load_both("scenario_two_straight")
    B = 3
    jcfg = JaxConfig.from_global_config(jgc, max_iter=15)
    jw_b = _jax_batched(JaxWeights.from_global_config(jgc, dtype=jnp.float64), B,
                        w_yaw=W_YAW, stl_lim=STL_LIM)
    jsc = jax.tree.map(lambda a: jnp.stack([a] * B), jst.device_scenario(tick=0,
                                                                         dtype=jnp.float64))
    x0 = np.stack([jst.ego_x0] * B)
    ju, jx, jstats, _ = _jax_solve_batch(jcfg, jw_b, x0, jsc, True)
    sc = st.device_scenario(tick=0, dtype=F64, batch=B)
    return (ju, jx, jstats), (port_config(jcfg), port_weights(jw_b), t64(x0), sc)


def test_yaml_param_sweep_matches_jax(yaml_sweep):
    (ju, jx, jstats), (cfg, w_b, x0, sc) = yaml_sweep
    assert w_b.w_yaw.shape == (3,) and w_b.dt.shape == (3,)
    u, x, stats, _ = solve(cfg, w_b, x0, sc)
    check_solution(u, x, stats, ju, jx, jstats)
    got = solve_batch(cfg, w_b, x0, sc, weights_batched=True)
    assert all(torch.equal(a, b) for a, b in zip((u, x, stats.iters, stats.status),
                                                  (got[0], got[1], got[2].iters, got[2].status)))
    _check_rows(cfg, w_b, x0, sc, u, x, stats)
    # the tighter steering limit steers less (tests/test_cilqr.py:161)
    assert float(u[2, :, 1].abs().max()) <= float(u[1, :, 1].abs().max()) + 1e-9


def test_only_some_weights_per_row(yaml_sweep):
    """Only w_yaw and stl_lim as (3,) tensors, every other weight 0-d (the
    weights of ``state_weight_diag`` mixed): the JAX rows; ``solve_batch`` takes
    such mixed weights in neither mode."""
    (ju, jx, jstats), (cfg, w_b, x0, sc) = yaml_sweep
    w = dataclasses.replace(_row(w_b, 0), w_yaw=w_b.w_yaw, stl_lim=w_b.stl_lim)
    assert w.row_shapes == {(), (3,)}
    u, x, stats, _ = solve(cfg, w, x0, sc)
    check_solution(u, x, stats, ju, jx, jstats)
    with pytest.raises(ValueError, match="weights_batched"):
        solve_batch(cfg, w, x0, sc, weights_batched=True)
    with pytest.raises(ValueError, match="weights_batched"):
        solve_batch(cfg, w, x0, sc)


@pytest.mark.parametrize("case", ["dt_wheelbase_gravity", "alm_gravity"])
def test_per_row_weights_small(case):
    """Every field per row on scenario_two_borrow (gravity center, N = 6):
    dt and wheelbase (the dynamics and the Jacobians), and an ALM case
    (rho_init, gamma and max_mu per row), against JAX's vmap and against
    single solves; one row keeps the yaml's weights."""
    over = dict(solve_type="alm") if case.startswith("alm") else {}
    jcfg, jw, x0, jsc, cfg, _, sc = small_problem("scenario_two_borrow", 3, seed=5,
                                                  max_iter=8, **over)
    if case.startswith("alm"):
        rows = dict(alm_rho_init=(float(jw.alm_rho_init), 5.0, 40.0),
                    alm_gamma=(float(jw.alm_gamma), 0.3, 0.6),
                    max_mu=(float(jw.max_mu), 50.0, 200.0))
    else:
        rows = dict(dt=(float(jw.dt), 0.08, 0.12), wheelbase=(float(jw.wheelbase), 2.5, 3.2))
    jw_b = _jax_batched(jw, 3, **rows)
    ju, jx, jstats, jcarry = _jax_solve_batch(jcfg, jw_b, x0, jsc, True)
    w_b = port_weights(jw_b)
    u, x, stats, carry = solve_batch(cfg, w_b, t64(x0), sc, weights_batched=True)
    check_solution(u, x, stats, ju, jx, jstats)
    if case.startswith("alm"):
        np.testing.assert_allclose(carry.alm_mu.numpy(), np.asarray(jcarry.alm_mu), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(carry.alm_rho.numpy(), np.asarray(jcarry.alm_rho), rtol=1e-12)
    _check_rows(cfg, w_b, t64(x0), sc, u, x, stats)


def test_solve_batch_scalar_weights_matches_jax():
    jcfg, jw, x0, jsc, cfg, w, sc = small_problem("scenario_three_bend", 4, seed=3)
    ju, jx, jstats, _ = _jax_solve_batch(jcfg, jw, x0, jsc, False)
    u, x, stats, _ = solve_batch(cfg, w, t64(x0), sc)
    check_solution(u, x, stats, ju, jx, jstats)
    with pytest.raises(ValueError, match="weights_batched"):
        solve_batch(cfg, w, t64(x0), sc, weights_batched=True)


@pytest.mark.parametrize("solve_type", ["barrier", "alm"])
def test_equal_rows_bitwise_scalar_weights(solve_type):
    """(B,) weights whose rows all hold the 0-d values solve bitwise as the
    0-d weights do."""
    _, _, x0, _, cfg, w, sc = small_problem("scenario_three_straight", 4, seed=2,
                                            solve_type=solve_type)
    one = solve(cfg, w, t64(x0), sc)
    rows = solve_batch(cfg, tree_map(lambda a: a.expand(4).clone(), w), t64(x0), sc,
                       weights_batched=True)
    for a, b in zip((one[0], one[1], *dataclasses.astuple(one[2]), one[3].alm_mu),
                    (rows[0], rows[1], *dataclasses.astuple(rows[2]), rows[3].alm_mu)):
        assert torch.equal(a, b)


def test_kernel_path_refuses_per_row_weights(yaml_sweep):
    _, (cfg, w_b, x0, sc) = yaml_sweep
    p = ck.pack_problem(cfg, x0, sc, 256, w_back=24)
    with pytest.raises(ValueError, match="one set of weights a launch"):
        ck.cilqr_solve_ref(cfg, w_b, p)
    with pytest.raises(ValueError, match="one set of weights a launch"):
        ck.cilqr_solve_cuda(cfg, w_b, x0, sc, window=256, w_back=24)
    with pytest.raises(ValueError, match="one set of weights a launch"):
        ck.host_weights(w_b, F64)
    obs = sc.obs_preds.new_zeros((3, 0, cfg.N + 3, 3))
    with pytest.raises(ValueError, match="one set of weights a launch"):
        run_mpc_kernel_scan(cfg, w_b, x0, sc.ref_line, sc.ref_velo, obs, sc.road_borders, 2,
                            window=256)


def test_alm_item_matches_jax(rng):
    c = rng.normal(size=(5, 7, 12))
    mu = np.abs(rng.normal(size=(5, 7, 12))) * rng.integers(0, 2, size=(5, 7, 12))
    rho = np.abs(rng.normal(size=(5, 1, 1))) + 0.1
    got = C.alm_item(t64(c), t64(rho), t64(mu)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jC.alm_item(jnp.asarray(c), jnp.asarray(rho),
                                                              jnp.asarray(mu))))
    value, _, _ = C.alm_coeffs(t64(c), t64(rho), t64(mu))
    np.testing.assert_allclose(got, value.numpy(), rtol=1e-15, atol=0)


@pytest.mark.parametrize("solve_type", ["barrier", "alm"])
def test_cost_derivatives_matches_jax(solve_type, rng):
    jcfg, jw, x0, jsc, cfg, w, sc = small_problem("scenario_two_borrow", 2, seed=4,
                                                  solve_type=solve_type)
    u = rng.normal(size=(2, cfg.N, 2)) * 0.1
    x = rollout(t64(x0), t64(u), w.dt, w.wheelbase, cfg.reference_point)
    rho = np.asarray([20.0, 30.0])
    mu = np.abs(rng.normal(size=(2, cfg.N, cfg.num_constraints)))
    args = (t64(rho), t64(mu)) if solve_type == "alm" else ()
    der = cost_derivatives(cfg, w, t64(u), x, sc, *args)
    assert all(torch.equal(a, b) for a, b in zip(der, cost_and_derivatives(
        cfg, w, t64(u), x, sc, *args)[1]))
    for i in range(2):
        jargs = (jnp.asarray(rho[i]), jnp.asarray(mu[i])) if solve_type == "alm" else ()
        jder = jax_cost_derivatives(jcfg, jw, jnp.asarray(u[i]), jnp.asarray(x[i].numpy()),
                                    jax.tree.map(lambda a: a[i], jsc), *jargs)
        for name, a, b in zip(der._fields, der, jder):
            # sum order differs (einsum against per-step loops): rounding only
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), rtol=1e-12, atol=1e-12,
                                       err_msg=name)


def test_padded_as_array_matches_jax():
    _, jst, _, st = load_both("scenario_two_straight")
    line, jline = st.center_lines[0], jst.center_lines[0]
    n = len(line)
    for pad_to in (None, n - 5, n, n + 37):
        for dtype in (np.float64, np.float32):
            got = line.as_array(pad_to, dtype=dtype)
            want = jline.as_array(pad_to=pad_to, dtype=dtype)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    padded = line.as_array(pad_to=n + 3)
    np.testing.assert_array_equal(padded[n:], [[PAD_COORD, PAD_COORD, 0.0, 0.0]] * 3)
