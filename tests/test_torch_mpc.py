"""The port's MPC drivers against ``ilqr_tpu.sim.mpc.run_mpc`` in float64.

Five receding-horizon ticks of scenario_two_straight, cold and with the
shifted-u warm start. ``run_mpc_kernel`` runs its plain path here (CPU
tensors) at batch 2, each row an episode from its own start, on the main
path's window (384 rows, w_back 24, derived search bound). Bars: exact
iteration counts, ego states and controls within 1e-8 (sum-order drift
only; ``tests/test_cilqr.py``'s tick-level bar).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.sim.mpc import run_mpc as jax_run_mpc
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim.mpc import run_mpc, run_mpc_kernel

from tests.conftest import CONFIG_DIR
from tests.torch_parity import load_both, port_config, port_weights, t64

TICKS = 5
TOL = 1e-8


@pytest.fixture(scope="module", params=[False, True], ids=["cold", "warm"])
def episodes(request):
    """JAX host-loop episodes from two starts, and the port's config/weights."""
    jgc, jst, _, st = load_both("scenario_two_straight")
    jcfg = JaxConfig.from_global_config(jgc, use_last_solution=request.param)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    starts = np.stack([jst.ego_x0, jst.ego_x0 + [0.4, -0.2, 0.5, 0.01]])
    hist = [jax_run_mpc(jcfg, jw, dataclasses.replace(jst, ego_x0=s), dtype=jnp.float64,
                        ticks=TICKS) for s in starts]
    return jcfg, port_config(jcfg), port_weights(jw), st, starts, hist


def test_run_mpc_matches_jax(episodes):
    _, cfg, w, st, starts, hist = episodes
    for start, jh in zip(starts, hist):
        h = run_mpc(cfg, w, dataclasses.replace(st, ego_x0=start), ticks=TICKS)
        np.testing.assert_allclose(h["ego"], jh["ego"], rtol=0, atol=TOL)
        np.testing.assert_allclose(h["u"], jh["u"], rtol=0, atol=TOL)
        np.testing.assert_allclose(h["x"], jh["x"], rtol=0, atol=TOL)
        assert [int(s.iters) for s in h["stats"]] == [int(s.iters) for s in jh["stats"]]
        assert [int(s.status) for s in h["stats"]] == [int(s.status) for s in jh["stats"]]


def test_run_mpc_kernel_plain_path_matches_jax(episodes):
    jcfg, cfg, w, st, starts, hist = episodes
    B = len(starts)
    sc = st.device_scenario(tick=0, dtype=torch.float64, batch=B)
    obs = t64(st.obs_preds_array()).expand(B, -1, -1, -1)
    launches = sum(ck.launches.values())
    ego, us, stats = run_mpc_kernel(cfg, w, t64(starts), sc.ref_line, sc.ref_velo, obs,
                                    sc.road_borders, TICKS, window=384,
                                    proj_rows_per_step=ck.derive_proj_rows(8, 0.1),
                                    w_back=24)
    assert sum(ck.launches.values()) == launches
    assert ego.shape == (TICKS + 1, B, 4) and us.shape == (TICKS, B, cfg.N, 2)
    for b, jh in enumerate(hist):
        np.testing.assert_allclose(ego[:, b].numpy(), jh["ego"], rtol=0, atol=TOL)
        np.testing.assert_allclose(us[:, b].numpy(), jh["u"], rtol=0, atol=TOL)
        np.testing.assert_array_equal(stats.iters[:, b].numpy(),
                                      [int(s.iters) for s in jh["stats"]])
        np.testing.assert_array_equal(stats.status[:, b].numpy(),
                                      [int(s.status) for s in jh["stats"]])


def test_motion_planning_app_headless(caplog, tmp_path):
    """Headless runs: with --no-viz, and rendering to a file (Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    from ilqr_tpu_torch.apps import motion_planning

    config = os.path.join(CONFIG_DIR, "scenario_two_straight.yaml")
    out = tmp_path / "episode.gif"
    assert motion_planning.main(["-c", config, "--ticks", "1", "--device", "cpu",
                                 "--save", str(out)]) == 0
    assert out.stat().st_size > 0
    caplog.set_level("INFO")
    assert motion_planning.main(["-c", config, "--no-viz", "--ticks", "2", "--device",
                                 "cpu"]) == 0
    assert "episode done: 2 ticks" in caplog.text
