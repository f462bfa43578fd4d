"""The fused solve's host side and plain version, against ``ilqr_tpu``.

On CPU tensors ``cilqr_solve_cuda`` runs its plain version
(``cilqr_solve_ref``). Held to the JAX solver in float64 on the main path's
setup -- scenario_two_straight, N=30, window 384, w_back 24 and the
derived per-step search bound: exact iteration counts and statuses, u and x
within 1e-8 (sum-order drift only). The window covers everything these
trajectories reach, so the windowed projection equals the global argmin,
as ``tests/test_pallas_kernel.py`` pins the TPU kernel to the same solver.

The CUDA kernel itself runs only on a GPU: see
``tests/test_torch_kernel_gpu.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops.pallas.cilqr_kernel import _PROJ_SLACK as JAX_PROJ_SLACK
from ilqr_tpu.ops.pallas.cilqr_kernel import derive_proj_rows as jax_derive_proj_rows
from ilqr_tpu.sim.scenario import perturbed_initial_states
from ilqr_tpu.solvers.cilqr import solve as jax_solve
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.torch_parity import load_both, port_config, port_weights, t64

TOL = 1e-8


@pytest.fixture(scope="module")
def main_path_problem():
    jgc, jst, _, st = load_both("scenario_two_straight")
    jcfg = JaxConfig.from_global_config(jgc)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    B = 16
    x0 = perturbed_initial_states(jst.ego_x0, B, seed=0)
    rows = ck.derive_proj_rows(jgc["vehicle/target_velocity"], jgc["delta_t"])
    return jcfg, jw, jst, st, x0, rows


def test_plain_path_matches_jax_solver(main_path_problem):
    jcfg, jw, jst, st, x0, rows = main_path_problem
    B = x0.shape[0]
    jsc = jax.tree.map(lambda a: jnp.stack([a] * B), jst.device_scenario(tick=0,
                                                                         dtype=jnp.float64))
    ju, jx, jstats, _ = jax.jit(jax.vmap(jax_solve, in_axes=(None, None, 0, 0, None)),
                                static_argnums=0)(jcfg, jw, jnp.asarray(x0), jsc, None)
    launches = sum(ck.launches.values())
    u, x, stats = ck.cilqr_solve_cuda(port_config(jcfg), port_weights(jw), t64(x0),
                                      st.device_scenario(tick=0, dtype=torch.float64,
                                                         batch=B),
                                      window=384, proj_rows_per_step=rows, w_back=24)
    assert sum(ck.launches.values()) == launches  # CPU tensors never launch the kernel
    np.testing.assert_array_equal(stats.iters.numpy(), np.asarray(jstats.iters))
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(jstats.status))
    np.testing.assert_array_equal(stats.converged.numpy(), np.asarray(jstats.converged))
    np.testing.assert_array_equal(stats.lamb_overflow.numpy(),
                                  np.asarray(jstats.lamb_overflow))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=TOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    np.testing.assert_allclose(stats.final_cost.numpy(), np.asarray(jstats.final_cost),
                               rtol=TOL)
    np.testing.assert_array_equal(stats.final_lamb.numpy(), np.asarray(jstats.final_lamb))


def test_search_bounds_match_the_tpu_kernel():
    """Rows per step and the rounded per-step limits are the TPU kernel's."""
    assert ck.derive_proj_rows(8, 0.1) == jax_derive_proj_rows(8, 0.1) == 9
    assert ck._PROJ_SLACK == JAX_PROJ_SLACK
    limits = ck.row_limits(30, 384, 24, 9)
    # the formula of ilqr_tpu/ops/pallas/cilqr_kernel.py:1539-1541
    assert limits == tuple(min(384, -(-(24 + 16 + k * 9) // 8) * 8) for k in range(31))
    assert limits[0] == 40 and limits[-1] == 312
    assert ck.row_limits(30, 384, 24, 0) == (384,) * 31


def test_pack_problem_window_and_layout():
    """The line packed once for the batch, the window derived around the
    initial nearest row (start not clamped to P - W, indices clamped to
    P - 1), the x0 packing, scenario-fastest layout, the obstacle pad
    (M = 1 at 1e6), a line per row, and the ALM seeds (mu zero-padded to
    8 + 2M rows, rho expanded over the batch)."""
    _, _, gc, st = load_both("scenario_two_straight")
    cfg = CILQRConfig.from_global_config(gc)
    ref = st.center_lines[0].as_array()
    P = ref.shape[0]
    x0 = t64([[12.0, 0.3, 8.0, 0.01], [ref[P - 5, 0], 0.0, 7.0, 0.0]])
    sc = st.device_scenario(tick=0, dtype=torch.float64, batch=2)
    p = ck.pack_problem(cfg, x0, sc, window=64, w_back=24)
    np.testing.assert_array_equal(p.line.numpy(), ref[:, :3].T)  # (3, P), once
    assert (p.window, p.w_back) == (64, 24)
    rx, _, ryaw = ck.window_rows(p)
    start0 = int(np.argmin((ref[:, 0] - 12.0) ** 2 + (ref[:, 1] - 0.3) ** 2)) - 24
    np.testing.assert_array_equal(rx[:, 0].numpy(), ref[start0:start0 + 64, 0])
    tail = np.minimum(np.arange(P - 5 - 24, P - 5 - 24 + 64), P - 1)
    np.testing.assert_array_equal(ryaw[:, 1].numpy(), ref[tail, 2])
    assert ck.window_start(p.line, p.x0, 24).tolist() == [start0, P - 5 - 24]
    np.testing.assert_array_equal(p.x0[:, 0].numpy(), [12.0, 0.3, 8.0, 0.01, 5.4, -1.8, 8.0, 0.0])
    obs = st.obs_preds_array()[:, :cfg.N + 1]
    np.testing.assert_array_equal(p.ox[:, :, 1].numpy(), obs[..., 0])
    assert p.uinit.shape == (2, cfg.N, 2) and not p.uinit.any()
    empty = ck.pack_problem(dataclasses.replace(cfg, num_obstacles=0), x0, sc, window=64)
    assert empty.ox.shape == (1, cfg.N + 1, 2)
    assert all(bool((a == 1e6).all()) for a in (empty.ox, empty.oy, empty.oyaw))
    # a line per row, (3, P, B): row 1's line 0.5 m to the side of row 0's
    lines = sc.ref_line + t64([[[0.0, 0.0, 0.0, 0.0]], [[0.0, 0.5, 0.0, 0.0]]])
    rowwise = ck.pack_problem(cfg, x0, dataclasses.replace(sc, ref_line=lines), 64, w_back=24)
    np.testing.assert_array_equal(rowwise.line.numpy(), lines[..., :3].permute(2, 1, 0).numpy())
    assert ck.window_start(rowwise.line, rowwise.x0, 24).tolist() == [start0, P - 5 - 24]
    _, ry, _ = ck.window_rows(rowwise)
    np.testing.assert_array_equal(ry[:, 0].numpy(), ref[start0:start0 + 64, 1])
    np.testing.assert_array_equal(ry[:, 1].numpy(), lines[1, tail, 1].numpy())
    # the ALM seeds: the duals' C0 = 8 + 2 * num_obstacles columns, zero-padded
    # to the kernel's 8 + 2M rows (M = 1 for the pad), rho over the batch
    for m in (cfg.num_obstacles, 0):
        alm = dataclasses.replace(cfg, solve_type="alm", num_obstacles=m)
        mu0 = t64(np.arange(2 * cfg.N * alm.num_constraints).reshape(2, cfg.N, -1) + 1.0)
        seeded = ck.pack_problem(alm, x0, sc, 64, alm_mu0=mu0, alm_rho0=t64(20.0))
        rows = 8 + 2 * max(m, 1)
        assert seeded.mu.shape == (rows, cfg.N, 2) and seeded.mu.is_contiguous()
        np.testing.assert_array_equal(seeded.mu[:alm.num_constraints].numpy(),
                                      mu0.permute(2, 1, 0).numpy())
        assert not seeded.mu[alm.num_constraints:].any()
        assert seeded.rho.tolist() == [20.0, 20.0]
        assert ck.pack_problem(alm, x0, sc, 64).mu is None


def test_kernel_launch_refuses_cpu_tensors_and_missing_variants():
    """No fallback: the kernel entry point raises instead of computing, on
    CPU tensors, on what no instantiation covers (an unknown reference
    point or penalty family, a horizon past the kernel's bound) and on
    inputs of the wrong shape."""
    _, _, gc, st = load_both("scenario_two_borrow")
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float32)
    x0 = torch.as_tensor(st.ego_x0[None], dtype=torch.float32)
    p = ck.pack_problem(cfg, x0, st.device_scenario(dtype=torch.float32), window=64)
    launches = sum(ck.launches.values())
    assert ck.variant(cfg, torch.float32) == "cilqr_solve_f32_gravity_barrier"
    assert ck.variant(dataclasses.replace(cfg, reference_point="rear_center", solve_type="alm"),
                      torch.float64) == "cilqr_solve_f64_rear_alm"
    for bad in ({"reference_point": "front_axle"}, {"solve_type": "penalty"}):
        with pytest.raises(ValueError):
            ck.cilqr_solve_kernel(dataclasses.replace(cfg, **bad), w, p)
    with pytest.raises(TypeError):
        ck.cilqr_solve_kernel(cfg, w, dataclasses.replace(p, x0=p.x0.half()))
    with pytest.raises(ValueError, match="CUDA"):  # every variant, on CPU tensors
        ck.cilqr_solve_kernel(dataclasses.replace(cfg, solve_type="alm"), w, p)
    # the launch's input checks, held against the tensors' own device
    long = dataclasses.replace(cfg, N=ck.MAX_STEPS)
    with pytest.raises(ValueError, match="horizon"):
        ck.check_packed(long, p)
    with pytest.raises(ValueError, match="uinit"):
        ck.check_packed(cfg, dataclasses.replace(p, uinit=p.uinit[:, :-1]))
    with pytest.raises(ValueError, match="line"):
        ck.check_packed(cfg, dataclasses.replace(p, line=p.line.T.contiguous()))
    with pytest.raises(ValueError, match="line"):
        ck.check_packed(cfg, dataclasses.replace(p, line=p.line[:, :, None].expand(3, -1, 2)))
    with pytest.raises(ValueError, match="w_back"):
        ck.check_packed(cfg, dataclasses.replace(p, w_back=-1))
    with pytest.raises(ValueError, match="row_limits"):
        ck.check_packed(cfg, dataclasses.replace(p, row_limits=p.row_limits[:-1]))
    alm = dataclasses.replace(cfg, solve_type="alm")
    with pytest.raises(ValueError, match="mu"):
        ck.check_packed(alm, dataclasses.replace(p, mu=torch.zeros(8, cfg.N, 1)))
    assert sum(ck.launches.values()) == launches
