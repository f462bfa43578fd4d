"""The demos and the eager solver's options on the card, at small batches:
``chip_smoke.py`` phase 10's gates. Plain PyTorch in float64, each path
held to the port's own CPU run. Marked ``gpu``; skips without a CUDA
device. Imports only the port:

    python -m pytest -m gpu tests/test_torch_demos_gpu.py -q
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ilqr_tpu_torch.apps import lqr_tracking as tracking_app
from ilqr_tpu_torch.apps.cilqr_demo import batch_starts
from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
from ilqr_tpu_torch.solvers import cilqr_demo as demo
from ilqr_tpu_torch.solvers import lqr_tracking as tracking
from ilqr_tpu_torch.solvers.cilqr import solve
from ilqr_tpu_torch.solvers.lqr import lqr_demo_batch_x0
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

pytestmark = pytest.mark.gpu

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
F64 = torch.float64
A0 = np.array([[1.95, -0.025, -1.6], [1.6, 1.1, -3.2], [0.425, 0.185, 0.3]])
B0 = np.array([[0.0, 1.0], [1.0, 1.0], [0.0, 1.0]])
J_RTOL, X_ATOL = 1e-3, 0.03  # tests/test_torch_cilqr_demo.py's full-solve bars


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card's runs to the CPU's")
    return torch.device("cuda")


def test_lqr_demo_on_card(cuda_device):
    system = [torch.as_tensor(a, dtype=F64) for a in (A0, B0, np.eye(3), np.eye(2))]
    x0 = torch.randn((64, 3), generator=torch.Generator().manual_seed(1), dtype=F64)
    got = lqr_demo_batch_x0(*(a.to(cuda_device) for a in system), x0.to(cuda_device), steps=50)
    want = lqr_demo_batch_x0(*system, x0[:16], steps=50)
    for g, w in zip([got[0], got[1], *got[2], *got[3]], [want[0], want[1], *want[2], *want[3]]):
        torch.testing.assert_close(g[:16].cpu(), w, rtol=1e-10, atol=1e-10)


def test_tracking_on_card(cuda_device):
    x0 = torch.zeros((8, 4), dtype=F64)
    x0[1:, :2] = 0.5 * torch.randn((7, 2), generator=torch.Generator().manual_seed(2), dtype=F64)
    course, goal = tracking.make_demo_course(device=cuda_device)
    p = tracking.default_params(device=cuda_device)
    states, controls, reached = tracking.simulate(p, course, goal, x0=x0.to(cuda_device))
    _, _, r0 = tracking.simulate(tracking.default_params(), tracking.make_demo_course()[0], goal)
    assert int(reached[0].int().argmax()) == int(r0.int().argmax()) == 254
    assert bool(reached[:, -1].all())
    assert float(controls[..., 1].abs().max()) <= float(p.max_steer) + 1e-9


def test_cilqr_demo_on_card(cuda_device):
    p, x0, *scene = demo.demo_scenario(F64, cuda_device)
    starts = batch_starts(x0, 8)
    starts[0] = starts[-1] = x0
    res = demo.solve(p, starts, *scene)
    cpu = demo.solve(*demo.demo_scenario(F64))
    assert int(res.iters[0]) == int(cpu.iters) and bool(res.converged[0]) == bool(cpu.converged)
    np.testing.assert_allclose(float(res.J[0]), float(cpu.J), rtol=J_RTOL)
    np.testing.assert_allclose(res.x[0].cpu().numpy(), cpu.x.numpy(), rtol=0, atol=X_ATOL)
    for t in res:
        assert torch.equal(t[0], t[-1])


def _two_straight(cuda_device, batch):
    gc = GlobalConfig.from_file(str(CONFIGS / "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, batch, seed=0), dtype=F64)
    x0[0] = torch.as_tensor(st.ego_x0)
    return gc, st, x0.to(cuda_device)


def test_pscan_matches_scan_on_card(cuda_device):
    """At lambda 0, N = 12, max_iter 20: row 0 (tests/test_riccati.py:112's
    start) equal in exit and path, every converged row on the same path."""
    gc, st, x0 = _two_straight(cuda_device, 64)
    w = CILQRWeights.from_global_config(gc, F64, cuda_device, init_lamb=0.0)
    sc = st.device_scenario(tick=0, horizon=12, dtype=F64, device=cuda_device, batch=64)
    out = {}
    for impl in ("scan", "pscan"):
        cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=20), N=12,
                                  use_last_solution=False, riccati_impl=impl)
        out[impl] = solve(cfg, w, x0, sc)
    (us, xs, ss, _), (up, xp, sp, _) = out["scan"], out["pscan"]
    assert int(ss.iters[0]) == int(sp.iters[0]) and int(ss.status[0]) == int(sp.status[0])
    conv = ss.converged | sp.converged
    conv[0] = True
    torch.testing.assert_close(up[conv], us[conv], rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(xp[conv], xs[conv], rtol=1e-6, atol=1e-8)


def test_hier_bitwise_exact_on_card(cuda_device):
    gc, st, x0 = _two_straight(cuda_device, 16)
    w = CILQRWeights.from_global_config(gc, F64, cuda_device)
    sc = st.device_scenario(tick=0, dtype=F64, device=cuda_device, batch=16)
    outs = []
    for proj in ("exact", "hier"):
        cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, projection=proj),
                                  use_last_solution=False)
        u, x, stats, _ = solve(cfg, w, x0, sc)
        outs.append([u, x, *(getattr(stats, f.name) for f in dataclasses.fields(stats))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_tracking_app_on_card(cuda_device, capsys):
    assert tracking_app.main(["--no-viz"]) == 0
    assert "goal reached after 255 ticks" in capsys.readouterr().out
