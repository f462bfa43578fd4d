"""The roofline's floor from the frozen OPS, on a tiny shape worked out by
hand."""

from __future__ import annotations

import pytest

from benchmarks import roofline


def test_floor_tiny_rear():
    shape = dict(B=2, N=2, M=1, W=8, limits=(8, 8, 8), gravity=False, dtype="float32")
    o = roofline.OPS
    proj = 6 * 24
    cost = 3 * o["cost_track"] + 2 * (o["cost_ctrl"] + o["cost_state"] + o["cost_obs"])
    start = 2 * o["prop_rear"] + proj + cost
    deriv = 3 * o["deriv_base"] + 2 * (o["deriv_ctrl"] + o["deriv_state"] + o["deriv_obs"])
    per_iter = deriv + 2 * o["riccati_rear"] + 2 * (o["feedback"] + o["prop_rear"]) + proj + cost
    assert roofline.solve_ops(shape) == (start, per_iter)
    # inputs 8 + 4 + 24 + 9, outputs 4 + 12 + 6, a row, float32
    assert roofline.solve_bytes(shape) == 2 * 67 * 4
    f = roofline.floor([dict(shape, iters=7)])
    assert f["ops"] == 2 * start + 7 * per_iter
    assert f["seconds"] == pytest.approx(max(f["ops"] / 67e12, f["bytes"] / 3.35e12))


def test_floor_gravity_pads_no_agents():
    shape = dict(B=1, N=2, M=0, W=8, limits=(8, 8, 8), gravity=True, dtype="float64")
    rear = dict(shape, gravity=False)
    assert roofline.solve_ops(shape)[1] - roofline.solve_ops(rear)[1] == 2 * (
        roofline.OPS["riccati_gravity"] - roofline.OPS["riccati_rear"]
        + roofline.OPS["prop_gravity"] - roofline.OPS["prop_rear"])
    assert roofline.solve_bytes(shape) == roofline.solve_bytes(dict(shape, M=1))
