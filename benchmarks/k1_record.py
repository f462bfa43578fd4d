"""K1's record as the per-layer readers take it: the port's own counters
of K1's phase clocks, line searches, statuses and solve nanoseconds
(``ilqr_tpu_torch/utils/counters.py``: ``k1_totals``, which every launch
adds to on the card), read after the traced run over the whole run since
the process started. The record holds no time on the host's clock, so
these readers give shares and ratios. Each returns None where the port
keeps no such record (a tree before it) or no launch made one."""

from __future__ import annotations

from typing import Optional

from benchmarks import roofline
from benchmarks.metrics import k1_seconds

# the phases of a line search: the trials' rollouts, projections, and
# costs with their verdicts
SEARCH = ("p4_forward", "p5_project", "p6_cost")


def _counters():
    try:
        from ilqr_tpu_torch.utils import counters
    except ImportError:
        return None
    return counters if hasattr(counters, "k1_totals") else None


def totals() -> Optional[dict]:
    """The port's K1 record, or None."""
    counters = _counters()
    return None if counters is None else counters.k1_totals()


def phase_share(phases) -> Optional[float]:
    """The solves' clocks in ``phases`` over their clocks, %."""
    rec = totals()
    if rec is None or rec["clocks"] <= 0:
        return None
    return 100.0 * sum(rec[p] for p in phases) / rec["clocks"]


def trials_per_iter() -> Optional[float]:
    """Line-search trials judged over the iterations run."""
    rec = totals()
    return None if rec is None or rec["iters"] <= 0 else rec["trials"] / rec["iters"]


def slot_use(ctx) -> Optional[float]:
    """The solves' wall nanoseconds a K1 launch (%globaltimer, summed over
    the launch's solves, over the record's launches) over what one launch
    holds of the card's slots: its traced device ns (K1's spans over their
    count) times the card's SMs times the scenarios resident on one SM
    (the plan's), %. What is missing of 100 is the ramp and the straggler
    tail, where slots stand empty."""
    counters = _counters()
    rec = None if counters is None else counters.k1_totals()
    plan = None if counters is None else counters.plan
    spans = sum(1 for name, _, _ in ctx.trace.spans if roofline.K1_NAME in name)
    if (rec is None or rec["launches"] <= 0 or not spans or plan is None
            or not plan.get("resident") or not plan.get("sms")):
        return None
    launch_ns = 1e9 * k1_seconds(ctx) / spans
    return 100.0 * rec["solve_ns"] / rec["launches"] / (launch_ns * plan["sms"] * plan["resident"])
