"""The port's eager solver held directly to the numpy oracle of the
reference C++ semantics (``tests/oracle_cilqr.py``), in float64: the cases
of ``tests/test_cilqr.py:40-110`` at their tolerances.

This file imports the port, numpy and the oracle only (no ``jax``, no
``ilqr_tpu``). Each ``check_*`` function takes the device to solve on, so
``chip_smoke.py`` runs the same checks on the card; each raises
``AssertionError`` on a miss and returns what it compared.
"""

import os

import numpy as np
import torch

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.sim.scenario import build_scenario_setup
from ilqr_tpu_torch.solvers.cilqr import CILQRSolver, solve
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.oracle_cilqr import OracleCILQR

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
F64 = torch.float64
TICK_ATOL = 1e-8  # the first tick and ALM mode
MPC_ATOL = 1e-7  # receding-horizon ticks and the warm start


def _load(name):
    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR, f"{name}.yaml"))
    return gc, build_scenario_setup(gc)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a) - b).max())


def _first_tick(solve_type, device):
    """The port's cold solve and the oracle's on scenario_two_straight's
    first tick: (u, x, stats, oracle u, oracle x, oracle)."""
    gc, st = _load("scenario_two_straight")
    cfg = CILQRConfig.from_global_config(gc, solve_type=solve_type)
    w = CILQRWeights.from_global_config(gc, F64, device)
    sc = st.device_scenario(tick=0, dtype=F64, device=device)
    x0 = torch.as_tensor(st.ego_x0, dtype=F64, device=device)[None]
    u, x, stats, _ = solve(cfg, w, x0, sc)
    oracle = OracleCILQR(gc, st.num_obstacles)
    oracle.solve_type = solve_type
    obs = st.obs_preds_array()[:, :oracle.N + 1]
    u_o, x_o = oracle.solve(st.ego_x0, st.center_lines[0].as_array(),
                            gc["vehicle/target_velocity"], obs, st.road_borders)
    return u[0].cpu().numpy(), x[0].cpu().numpy(), stats, u_o, x_o, oracle


def check_first_tick(device="cpu") -> dict:
    """Barrier mode, first tick: u and x within 1e-8, the same convergence,
    and one more iteration than the oracle's 0-based index at its break."""
    u, x, stats, u_o, x_o, oracle = _first_tick("barrier", device)
    np.testing.assert_allclose(u, u_o, atol=TICK_ATOL)
    np.testing.assert_allclose(x, x_o, atol=TICK_ATOL)
    assert bool(stats.converged[0]) == (oracle.status == oracle.CONVERGED)
    assert int(stats.iters[0]) == oracle.iters + 1
    return dict(u_err=_err(u, u_o), x_err=_err(x, x_o), iters=int(stats.iters[0]),
                oracle_iters=oracle.iters)


def check_alm_mode(device="cpu") -> dict:
    """ALM mode, first tick: u and x within 1e-8."""
    u, x, stats, u_o, x_o, _ = _first_tick("alm", device)
    np.testing.assert_allclose(u, u_o, atol=TICK_ATOL)
    np.testing.assert_allclose(x, x_o, atol=TICK_ATOL)
    return dict(u_err=_err(u, u_o), x_err=_err(x, x_o), iters=int(stats.iters[0]))


def _episode(name, ticks, device, compare_x):
    """``ticks`` receding-horizon ticks through ``CILQRSolver`` and the
    oracle, each applying its own x[1]; the largest u (and x) differences."""
    gc, st = _load(name)
    solver = CILQRSolver(gc, dtype=F64, device=device)
    oracle = OracleCILQR(gc, st.num_obstacles)
    ref_arr = st.center_lines[0].as_array()
    obs_full = st.obs_preds_array()
    ego, ego_o = st.ego_x0.copy(), st.ego_x0.copy()
    u_err, x_err = [], []
    for tick in range(ticks):
        window = obs_full[:, tick: tick + oracle.N + 1]
        u, x = solver.solve(ego, st.center_lines[0], gc["vehicle/target_velocity"], window,
                            st.road_borders)
        u_o, x_o = oracle.solve(ego_o, ref_arr, gc["vehicle/target_velocity"], window,
                                st.road_borders)
        np.testing.assert_allclose(u, u_o, atol=MPC_ATOL)
        if compare_x:
            np.testing.assert_allclose(x, x_o, atol=MPC_ATOL)
        u_err.append(_err(u, u_o))
        x_err.append(_err(x, x_o))
        ego, ego_o = x[1], x_o[1]
    return solver, dict(ticks=ticks, u_err=max(u_err), x_err=max(x_err))


def check_mpc_ticks(device="cpu") -> dict:
    """Three ticks of scenario_two_straight: u and x within 1e-7."""
    return _episode("scenario_two_straight", 3, device, compare_x=True)[1]


def check_warm_start(device="cpu") -> dict:
    """scenario_three_straight (use_last_solution: the shifted previous
    solution and the ALM duals carry across solves), two ticks: u within
    1e-7."""
    solver, rec = _episode("scenario_three_straight", 2, device, compare_x=False)
    assert solver.cfg.use_last_solution
    return rec


CHECKS = {"first_tick": check_first_tick, "alm_mode": check_alm_mode,
          "mpc_ticks": check_mpc_ticks, "warm_start": check_warm_start}


def test_first_tick_matches_oracle():
    check_first_tick()


def test_alm_mode_matches_oracle():
    check_alm_mode()


def test_mpc_ticks_match_oracle():
    check_mpc_ticks()


def test_warm_start_matches_oracle():
    check_warm_start()


def test_imports_neither_jax_nor_the_jax_package():
    import ast

    tree = ast.parse(open(__file__).read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"jax", "ilqr_tpu", "flax"}
