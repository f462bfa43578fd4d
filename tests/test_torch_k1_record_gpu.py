"""K1's record on the card, at each cell's shape: the benchmark's runner of
the cell, at a small batch, builds and warms up its program (the episode's
graph captures), then ``counters.reset()`` zeroes the record and one call
(graph replays, in the MPC cells) and one traced call add to it.

Marked ``gpu``; skips without a CUDA device. Imports only the port and the
benchmark, so it runs on a GPU machine without the JAX package:
python -m pytest -m gpu tests/test_torch_k1_record_gpu.py -q
"""

from types import SimpleNamespace

import pytest
import torch

from benchmarks import harness, tracing
from ilqr_tpu_torch.utils import counters

# not the batch of tests/test_torch_three_straight_gpu.py: its episodes
# must be captured by that test, not replayed from this one's
BATCH = 192
CELLS = ["two_straight.mpc", "three_bend.mpc", "three_straight.mpc", "two_straight.sweep"]
# the busiest lane's rows a projection at each cell's row limits
# (the .cu source's ``scan_lane``; w_back 24 or 64, 9 or 10 rows a step)
SCAN_ROWS = {"two_straight.mpc": 180, "three_bend.mpc": 180, "three_straight.mpc": 196,
             "two_straight.sweep": 220}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.timeout(240)
@pytest.mark.parametrize("cell", CELLS)
def test_k1_record_at_the_cells_shape(cuda_device, cell, monkeypatch):
    """After ``reset`` the record is zero; one call adds its launches
    (replays of the captured graphs in the MPC cells): a launch a tick or
    step, BATCH solves each, the iterations its stats sum to, its
    converged rows, statuses that sum to the iterations, and phases that
    sum to within 1% of the solves' clocks, and scan trips of the cell's
    busiest lane in every projection. A traced call then gives every new
    reader a number: shares in [0, 100], at least one trial an iteration,
    slot use in (0, 100], the busiest lane's rows."""
    c = harness.load_cell(cell)
    c = c._replace(traffic=dict(c.traffic, batch=BATCH, pool=1))
    runner = harness.runner_for(c, "cuda")
    runner.set_seed(2**31 + 17)
    runner.setup()
    plan = counters.plan
    counters.reset()
    assert set(counters.k1_totals().values()) == {0}
    monkeypatch.setattr(counters, "plan", plan)  # replays note no plan
    out = runner.call(1)
    runner.sync()
    rec = counters.k1_totals()
    mpc = runner.kind == "mpc_episodes"
    stats = out[2]
    launches = runner.ticks if mpc else 1
    assert rec["launches"] == launches and rec["solves"] == launches * BATCH
    if mpc:
        assert counters.counts["graph_replays"] >= 1
    assert rec["iters"] == int(stats.iters.sum())
    assert rec["converged"] == int(stats.converged.sum())
    assert sum(rec[s] for s in counters.K1_STATUSES) == rec["iters"]
    phases = sum(rec[p] for p in counters.K1_PHASES)
    assert abs(phases - rec["clocks"]) <= 0.01 * rec["clocks"]
    assert all(rec[p] >= 0 for p in counters.K1_PHASES) and rec["solve_ns"] > 0
    assert rec["scan_trips"] == SCAN_ROWS[cell] * (rec["solves"] + rec["trials"])

    trace = tracing.profile([lambda: runner.call(2)], "call", runner.sync)
    ctx = SimpleNamespace(kind=runner.kind, trace=trace)
    for m in c.per_layer:
        name = m["name"]
        if not name.startswith(("k1_backward", "k1_search", "k1_trials", "k1_slot", "k1_scan")):
            continue
        value = harness.reader(name)(ctx)
        if "scan_trips" in name:
            assert value == SCAN_ROWS[cell], name
        elif "trials" in name:
            assert value >= 1, name
        elif "slot_use" in name:
            assert 0 < value <= 100, name
        else:
            assert 0 <= value <= 100, name
