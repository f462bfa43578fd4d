"""The fused solve's gravity-center and ALM variants, against ``ilqr_tpu``.

On CPU tensors ``cilqr_solve_cuda`` and ``run_mpc_kernel`` run the plain
version, so these tests hold the host side of every new kernel variant
(packing, the dual I/O and its carry across ticks) and its plain version
to the JAX package's XLA solver in float64: ``ilqr_tpu.solvers.cilqr.solve``
and ``ilqr_tpu.sim.mpc.run_mpc_scan``, the reference the JAX package's own
kernel tests hold the Pallas kernel to. Sizes are those of
``tests/test_pallas_kernel.py`` (N = 6, max_iter 6-8, a few rows and
ticks). Bars: exact iteration counts and statuses, everything else within
1e-8 (sum-order drift only).

The ALM variants have their own file, ``tests/test_torch_kernel_alm.py``;
the CUDA instantiations themselves run only on a GPU:
``tests/test_torch_kernel_gpu.py``.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from ilqr_tpu_torch.apps import validate_kernel
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.solvers.cilqr import CILQRSolver

from tests.conftest import CONFIG_DIR
from tests.torch_parity import (SCENARIOS, check_solution, jax_batch, load_both, port_solve,
                                small_problem)


@pytest.mark.parametrize("name,max_iter,B", [
    ("scenario_two_borrow", 8, 4),      # 4 obstacles
    ("scenario_three_straight", 6, 4),  # 8 obstacles, C = 24 dual columns
    ("scenario_three_bend", 6, 4),      # curved reference line
])
def test_gravity_center_barrier_matches_jax(name, max_iter, B):
    jcfg, jw, x0, jsc, cfg, w, sc = small_problem(name, B, seed=2, max_iter=max_iter)
    assert cfg.reference_point == "gravity_center" and cfg.solve_type == "barrier"
    ju, jx, jstats, _ = jax_batch(jcfg, jw, x0, jsc)
    check_solution(*port_solve(cfg, w, x0, sc), ju, jx, jstats)


def test_entry_points_default_to_cuda(monkeypatch):
    """The app and ``CILQRSolver`` run on the GPU unless told otherwise,
    and raise, instead of falling back to the CPU, when there is none."""
    from ilqr_tpu_torch.apps import motion_planning

    assert inspect.signature(CILQRSolver).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, gc, _ = load_both("scenario_two_straight")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CILQRSolver(gc)
    config = os.path.join(CONFIG_DIR, "scenario_two_straight.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        motion_planning.main(["-c", config, "--no-viz", "--ticks", "1"])
    assert CILQRSolver(gc, device="cpu").device.type == "cpu"


def test_validate_kernel_inputs_and_gate():
    """The validation app's anchors cover every scenario at its batch and
    seed, it packs each one's cold solve for the kernel, its agreement
    measure reads zero for identical solutions, and without a card it
    raises instead of validating anything else."""
    anchors = json.loads(validate_kernel.ANCHORS.read_text())
    assert set(validate_kernel.SCENARIOS) == set(SCENARIOS) <= set(anchors)
    for name in validate_kernel.SCENARIOS:
        assert (int(anchors[name]["batch"]), int(anchors[name]["seed"])) == (1024, 0)
        assert len(anchors[name]["status_rows"]) == 1024
    cfg, w, p = validate_kernel.packed_cold("scenario_three_straight", 4, torch.float64, "cpu")
    ck.check_packed(cfg, p)
    assert p.ox.shape == (8, cfg.N + 1, 4) and p.window == validate_kernel.WINDOW
    assert p.line.dim() == 2 and ck.window_rows(p)[0].shape == (validate_kernel.WINDOW, 4)
    assert p.row_limits == ck.row_limits(cfg.N, 384, 24, 10)
    sol = ck.PackedSolution(p.uinit, torch.zeros(4, cfg.N + 1, 4, dtype=torch.float64),
                            torch.tensor([[5.0] * 4, [1.0] * 4, [1.0] * 4, [0.0] * 4,
                                          [7.0] * 4, [1.0] * 4], dtype=torch.float64),
                            None, None)
    conv_k, conv_r, cost_p90, pos_p90 = validate_kernel.agreement(sol, sol)
    assert conv_k.all() and conv_r.all() and cost_p90 == pos_p90 == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            validate_kernel.main(["--scenarios", "scenario_two_straight"])
