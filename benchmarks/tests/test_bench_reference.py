"""The plain reference against the port's plain CPU path, at a tiny size
(the comparison is the test's: the reference itself imports nothing of the
port), and its bfloat16 control against it."""

from __future__ import annotations

import json

import pytest
import torch

from benchmarks import harness
from benchmarks.reference.cilqr import Params, Reference, proj_rows, row_limits, window
from benchmarks.scenario import build_scene, starts

W, W_BACK, S = 384, 24, 6


def _inputs(name, tick, seed=11):
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())["scenario"]
    scene, p = build_scene(cfg), Params.of(cfg)
    x0 = torch.tensor(starts(scene.ego_x0, S, seed, 0))
    obs = torch.tensor(scene.obs[:, tick:tick + p.N + 1])[None].expand(S, -1, -1, -1)
    return cfg, scene, p, x0, torch.tensor(scene.line), obs


@pytest.mark.parametrize("name,tick", [("two_straight", 0), ("three_bend", 40)])
def test_reference_matches_port_plain_path(name, tick):
    from ilqr_tpu_torch.config import GlobalConfig
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, Scenario

    cfg, scene, p, x0, line, obs = _inputs(name, tick)
    rows = proj_rows(p.v_ref, p.dt)
    u0 = 0.01 * torch.ones(S, p.N, 2, dtype=torch.float64)
    sol = Reference(p).solve(x0, u0, window(line, x0, W, W_BACK),
                             row_limits(p.N, W, W_BACK, rows), obs)
    gc = GlobalConfig.from_dict(cfg)
    scen = Scenario(ref_line=line[None].expand(S, -1, -1),
                    ref_velo=torch.tensor(p.v_ref, dtype=torch.float64).expand(S),
                    obs_preds=obs, road_borders=torch.tensor(scene.road_borders).expand(S, 2))
    u, x, st = ck.cilqr_solve_cuda(CILQRConfig.from_global_config(gc),
                                   CILQRWeights.from_global_config(gc, dtype=torch.float64),
                                   x0, scen, window=W, u_init=u0, proj_rows_per_step=rows,
                                   w_back=W_BACK)
    assert torch.equal(st.iters.long(), sol.iters) and torch.equal(st.status.long(), sol.status)
    assert (u - sol.u).abs().max() < 1e-12 and (x - sol.x).abs().max() < 1e-11
    assert ((st.final_cost - sol.cost).abs() / sol.cost.abs()).max() < 1e-12


def test_bfloat16_control_departs():
    cfg, scene, p, x0, line, obs = _inputs("two_straight", 0)
    args = (x0, torch.zeros(S, p.N, 2, dtype=torch.float64), window(line, x0, W, W_BACK),
            row_limits(p.N, W, W_BACK, proj_rows(p.v_ref, p.dt)), obs)
    ref, ctl = Reference(p).solve(*args), Reference(p, torch.bfloat16).solve(*args)
    assert (ctl.u.double() - ref.u).abs().amax((1, 2)).median() > 1e-2


@pytest.mark.parametrize("cell", ["two_straight.mpc", "two_straight.sweep"])
def test_control_run_is_not_correct(cell):
    """A whole run at a CPU size with the control in the program's place."""
    from benchmarks.tests.conftest import small_cell

    line = harness.run_cell(small_cell(cell), 2**31 + 7, 0.1, False, "cpu", control=True)
    assert line["correct"] is False
    assert line["checks"]["u_gap_p50"]["value"] > line["checks"]["u_gap_p50"]["limit"]
