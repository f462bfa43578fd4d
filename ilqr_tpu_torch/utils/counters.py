"""Host-side counters of the fused solve's launch plans and episode programs.

The port keeps these for whoever reads them after a run (a benchmark's
per-layer metrics, a test); nothing here touches the device, syncs with
it or adds a profiler span. Two records, both module state of this
process:

- ``plan``: the newest plan the fused kernel (K1) was given, as
  ``ops/cuda/cilqr_kernel.py:note_plan`` works it out once a plan: the
  variant's name (``variant``), M (agent columns, 1 for the pad of an
  obstacle-free config), the constraint columns 8 + 2M, R (window rows
  staged, the largest row limit), the shared bytes of one scenario
  (``region_bytes``) and the scenarios resident on one SM
  (``resident_scenarios``; None for the plain version on the CPU, which
  stands for the kernel there). None before the first solve.
- ``counts``: ``plans_built`` (``launch_plan`` computing a launch shape it
  had not cached), ``graph_captures`` and ``graph_replays`` (the episode
  program's CUDA graphs, ``sim/mpc.py:_Episode``) and ``episode_ticks``
  (ticks run by ``run_mpc_kernel_scan`` and ``run_mpc_kernel_chunked``, a
  replay or an eager chunk at a time).
"""

from __future__ import annotations

import collections
from typing import Optional

plan: Optional[dict] = None
counts: collections.Counter = collections.Counter()
_plan_key: Optional[tuple] = None


def plan_is(key: tuple) -> bool:
    """Whether the newest plan was recorded under ``key``."""
    return _plan_key == key


def record_plan(key: tuple, **fields) -> None:
    """Make ``fields`` the newest plan, under ``key``."""
    global plan, _plan_key
    plan, _plan_key = dict(fields), key


def snapshot() -> dict:
    """A copy of both records: {"plan": ..., **counts}."""
    return {"plan": None if plan is None else dict(plan), **counts}


def reset() -> None:
    """Forget the plan and zero the counts."""
    global plan, _plan_key
    plan = _plan_key = None
    counts.clear()
