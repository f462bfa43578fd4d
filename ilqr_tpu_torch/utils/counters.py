"""Counters of the fused solve's launch plans, episode programs and inner work.

The port keeps these for whoever reads them after a run (a benchmark's
per-layer metrics, a test); nothing here adds a profiler span, and only
``k1_totals`` syncs with the device. Three records, all module state of
this process:

- ``plan``: the newest plan the fused kernel (K1) was given, as
  ``ops/cuda/cilqr_kernel.py:note_plan`` works it out once a plan: the
  variant's name (``variant``), M (agent columns, 1 for the pad of an
  obstacle-free config), the constraint columns 8 + 2M, R (window rows
  staged, the largest row limit), the shared bytes of one scenario
  (``region_bytes``), the scenarios resident on one SM
  (``resident_scenarios``) and the card's SMs (``sms``); the last two None
  for the plain version on the CPU, which stands for the kernel there.
  None before the first solve.
- ``counts``: ``plans_built`` (``launch_plan`` computing a launch shape it
  had not cached), ``graph_captures`` and ``graph_replays`` (the episode
  program's CUDA graphs, ``sim/mpc.py:_Episode``) and ``episode_ticks``
  (ticks run by ``run_mpc_kernel_scan`` and ``run_mpc_kernel_chunked``, a
  replay or an eager chunk at a time).
- ``k1_records``: K1's own record, one int64 tensor of ``K1_FIELDS`` a
  device, which every launch of the kernel adds to on the device
  (``csrc/cilqr_kernel.cu``, ``K1Field``), captured graphs' replays
  included. ``ops/cuda/cilqr_kernel.py:k1_record`` allocates it once a
  device and never again; ``k1_totals`` reads it.
"""

from __future__ import annotations

import collections
from typing import Optional

# K1's record, in the order of the kernel's ``K1Field``: the solves'
# clocks in each phase (P0 staging: the ALM dual copy, the nearest line
# row, the window, the obstacles, the initial controls; P1 the initial
# rollout, projection and cost; P2 ``derivatives``; P3 ``backward``, the
# Riccati pass; P4 ``forward_chunk``, the trials' rollouts; P5 the trials'
# ``project``; P6 the trials' ``total_cost``, verdict and ``adopt``; P7 the
# rest: the dual update, the lambda and status update, the stores), the
# solves' clocks from entry to last store (the eight phases sum to them),
# their wall nanoseconds (%globaltimer), the solves, the launches, the
# iterations run, the line-search chunks rolled out, the trials judged,
# and the iterations by the status they ended in: accepted at alpha 1,
# converged, backward pass failed, line search exhausted, accepted at a
# smaller alpha; last, the rows the busiest lane scores a projection, summed
# over the projections (``scan_trips``: the warp's trips through the window
# scan, the .cu source's ``scan_lane``; the initial projection and
# one a trial, so over ``solves`` + ``trials`` it is the trips a projection).
K1_PHASES = ("p0_stage", "p1_init", "p2_deriv", "p3_backward", "p4_forward", "p5_project",
             "p6_cost", "p7_rest")
K1_STATUSES = ("accepted_full", "converged", "backward_fail", "ls_exhausted", "accepted_small")
K1_FIELDS = K1_PHASES + ("clocks", "solve_ns", "solves", "launches", "iters", "chunks",
                         "trials") + K1_STATUSES + ("scan_trips",)

plan: Optional[dict] = None
counts: collections.Counter = collections.Counter()
k1_records: dict = {}  # device -> int64 tensor (len(K1_FIELDS),)
_plan_key: Optional[tuple] = None


def plan_is(key: tuple) -> bool:
    """Whether the newest plan was recorded under ``key``."""
    return _plan_key == key


def record_plan(key: tuple, **fields) -> None:
    """Make ``fields`` the newest plan, under ``key``."""
    global plan, _plan_key
    plan, _plan_key = dict(fields), key


def snapshot() -> dict:
    """A copy of the plan and the counts: {"plan": ..., **counts}."""
    return {"plan": None if plan is None else dict(plan), **counts}


def k1_totals() -> Optional[dict]:
    """K1's records since they were allocated or last reset, summed over
    the devices, as {field: int} in ``K1_FIELDS`` order; None where no
    launch has allocated one. Copies them to the host, so it waits for the
    launches queued before it."""
    if not k1_records:
        return None
    return dict(zip(K1_FIELDS, sum(t.cpu() for t in k1_records.values()).tolist()))


def reset() -> None:
    """Forget the plan, zero the counts and zero K1's records in place."""
    global plan, _plan_key
    plan = _plan_key = None
    counts.clear()
    for t in k1_records.values():
        t.zero_()
