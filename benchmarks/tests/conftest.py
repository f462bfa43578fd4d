"""Fixtures of the benchmark's tests: cells cut to a size the CPU runs in
seconds (a batch of 4, 4 ticks, max_iter 12), and a card for the tests
marked ``gpu``, which skip without one."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmarks import harness

# one thread a test process: several workers share the machine's cores
torch.set_num_threads(1)


def small_cell(name: str, precision: str = "float64"):
    """Cell ``name`` at a CPU size (4 ticks), in ``precision``: float64 makes the
    program's plain CPU path agree with the reference to rounding, so a
    clean run passes every limit and a planted fault is what fails it."""
    cell = harness.load_cell(name)
    tr = dict(cell.traffic, batch=4, pool=2, keep_rows=2, sample=12, trace_calls=1)
    if tr["kind"] == "mpc_episodes":
        tr.update(chunk=2)
    cfg = copy.deepcopy(cell.config)
    cfg["precision"] = precision
    cfg["scenario"]["max_simulation_time"] = 0.4
    cfg["scenario"]["iteration"]["max_iter"] = 12
    return cell._replace(traffic=tr, config=cfg)


@pytest.fixture()
def card():
    """The first CUDA card; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
