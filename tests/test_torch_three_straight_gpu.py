"""The benchmark's MPC cells' K1 plans on the card: the counter record that
``k1_resident.mpc`` reads against the card's occupancy query.

Marked ``gpu``; skips without a CUDA device. Imports only the port and the
benchmark, so it runs on a GPU machine without the JAX package:
python -m pytest -m gpu tests/test_torch_three_straight_gpu.py -q
"""

from types import SimpleNamespace

import pytest
import torch

from benchmarks import harness
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.utils import counters

BATCH = 256  # the plan's shared bytes and residency do not depend on it


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.timeout(240)
@pytest.mark.parametrize("cell", ["two_straight.mpc", "three_bend.mpc", "three_straight.mpc"])
def test_k1_resident_reads_the_cells_plan(cuda_device, cell):
    """The cell's runner, at a small batch, builds and captures its
    episode; ``k1_resident.mpc`` then reads the resident scenarios of the
    plan its K1 launches ran, which equal ``ck.resident_scenarios`` of
    that plan: the cell's agents, the largest row limit, its dtype and the
    card's modes."""
    c = harness.load_cell(cell)
    c = c._replace(traffic=dict(c.traffic, batch=BATCH, pool=1))
    runner = harness.runner_for(c, "cuda")
    runner.set_seed(2**31 + 3)
    counters.reset()
    runner.setup()
    plan = counters.snapshot()["plan"]
    cfg, _ = runner.program(runner.warm)
    M, R = runner.obs.shape[0], max(ck.row_limits(runner.N, runner.W, runner.w_back,
                                                  runner.rows))
    modes = ck.resolve_modes("cuda")
    expect = ck.resident_scenarios(cfg, runner.dtype,
                                   ck.launch_plan(BATCH, runner.N, M, R, runner.dtype, modes))
    got = harness.reader("k1_resident.mpc")(SimpleNamespace(kind="mpc_episodes"))
    assert plan["variant"] == ck.variant(cfg, runner.dtype, modes)
    assert (plan["agents"], plan["columns"], plan["rows"]) == (M, 8 + 2 * M, R)
    assert got == plan["resident"] == expect >= 1
