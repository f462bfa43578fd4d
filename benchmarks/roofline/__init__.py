"""The least time the card could take for a CILQR solve (K1,
``ilqr_tpu_torch/csrc/cilqr_kernel.cu:cilqr_solve_kernel``): the larger of
its operations over the float peak and its bytes over the memory rate.

``OPS`` is a frozen copy of ``chip_smoke.py:OPS``, operations per unit of
the solve's work counted from the kernel's source (an add, multiply,
divide, compare or transcendental is one operation, an FMA two; per
horizon step unless noted). The count is a floor that holds whatever
implements K1: per row the initial rollout, projection and cost, and per
iteration the solve returned one derivative pass, one Riccati pass, one
serial trial rollout and one projection-plus-cost evaluation, the least a
line search needs; projections at ``row`` operations a searched window row
in every mode. What one implementation chooses to do on top (a chunk's
extra rollouts, resumes, compaction) is not counted. Bytes: each input read
once and each output written once.
"""

from __future__ import annotations

# published peaks of one NVIDIA H100 SXM (dense, 700 W)
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
K1_NAME = "cilqr_solve_kernel"  # K1's device spans contain this

OPS = dict(
    prop_rear=15, prop_gravity=29,    # propagate
    feedback=24,                      # forward: u + K (x' - x) + alpha d
    row=6,                            # one window row of a projection scan, squared distance
    cost_track=15,                    # total_cost: tracking, steps 0..N
    cost_ctrl=30,                     # control cost and 4 penalties, 0..N-1
    cost_state=41,                    # velocity/border penalties, lateral, discs, 1..N
    cost_obs=44,                      # per obstacle: two ellipse penalties, 1..N
    deriv_base=16, deriv_ctrl=46, deriv_state=75, deriv_obs=126,  # step_derivs
    riccati_rear=432, riccati_gravity=502,                        # backward, per step
)
_SIZE = {"float32": 4, "float64": 8}


def solve_ops(shape: dict) -> tuple:
    """(operations of a row's start, operations of one iteration) of a
    solve of ``shape``: N, M (agents; 1 when none, the kernel's pad),
    limits (rows searched at steps 0..N), gravity."""
    o, N, M = OPS, shape["N"], max(shape["M"], 1)
    prop = o["prop_gravity"] if shape["gravity"] else o["prop_rear"]
    proj = o["row"] * sum(shape["limits"])
    cost = (N + 1) * o["cost_track"] + N * (o["cost_ctrl"] + o["cost_state"] + M * o["cost_obs"])
    deriv = (N + 1) * o["deriv_base"] + N * (o["deriv_ctrl"] + o["deriv_state"]
                                             + M * o["deriv_obs"])
    riccati = N * (o["riccati_gravity"] if shape["gravity"] else o["riccati_rear"])
    start = N * prop + proj + cost
    return start, deriv + riccati + N * (o["feedback"] + prop) + proj + cost


def solve_bytes(shape: dict) -> int:
    """Bytes a solve of B rows must move: the packed start, controls,
    window and agents in; controls, states and the stats slab out."""
    N, M, W = shape["N"], max(shape["M"], 1), shape["W"]
    elems = (8 + 2 * N + 3 * W + 3 * M * (N + 1)) + (2 * N + 4 * (N + 1) + 6)
    return shape["B"] * elems * _SIZE[shape["dtype"]]


def floor(solves) -> dict:
    """Summed floors of ``solves``, each a shape dict with B, N, M, W,
    limits, gravity, dtype and ``iters``, the iterations its B rows ran in
    all: {"ops", "bytes", "seconds"}, the seconds the larger of the two
    bounds per solve."""
    ops = nbytes = seconds = 0.0
    for s in solves:
        start, per_iter = solve_ops(s)
        o = s["B"] * start + s["iters"] * per_iter
        b = solve_bytes(s)
        ops, nbytes = ops + o, nbytes + b
        seconds += max(o / PEAK_FLOPS[s["dtype"]], b / PEAK_BYTES)
    return {"ops": ops, "bytes": nbytes, "seconds": seconds}
