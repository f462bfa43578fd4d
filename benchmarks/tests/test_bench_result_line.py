"""The result line holds exactly the contract's keys, with the compared
numbers last; without a card the command exits non-zero and prints no
result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmarks import harness
from benchmarks.tests.conftest import small_cell


@pytest.mark.parametrize("trace", [False, True])
def test_keys(trace):
    cell = small_cell("two_straight.sweep")
    line = harness.run_cell(cell, 2**33 + 5, 0.1, trace, "cpu")
    assert list(line)[-1] == "checks"
    keys = {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(line) == keys | ({"breakdown"} if trace else set())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:  # no card: no device span, so no per-layer value is read
        assert line["metrics"] == {} and {"busy_s", "window_s"} <= set(line["device"])
        assert 0 <= line["device"]["busy_s"] <= line["device"]["window_s"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits)
    json.dumps(line)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                           "two_straight.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
