"""The comparison that decides ``correct``: the program's answers against the
plain reference's, on a sample of the solves the window produced.

Each sampled solve is a task: a start x0 (4,), initial controls u0 (N, 2)
and the agents' rows (M, N+1, 3), all as the program was handed them, on
the configuration's line and window. The program's answer is its controls
u (N, 2), the states it returned (the first K of x, from x0), its
iterations and its status. The reference solves every task again in
float64 (``cilqr.Reference``) and each number below is taken over the
sample:

- ``u_gap_p50``: the median over solves of the largest |u - u_ref|;
- ``status_mismatch_share``: the share of solves whose status differs
  (how the solve ended: converged, or a failed pass ending in lambda
  overflow);
- ``iters_mismatch_share``: among the solves the reference converges, the
  share whose iterations differ (rows that end in lambda overflow stop at
  an iteration that rounding decides);
- ``rollout_gap``: the largest |x - rollout(x0, u)| over the returned
  states, the rollout in float64 from the program's own controls.

The control (``control_answers``) is the same reference in bfloat16 put in
the program's place. Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmarks.reference.cilqr import CONVERGED, Reference, row_limits, window

BLOCK = 256  # rows the reference solves at once


class Tasks(NamedTuple):
    x0: torch.Tensor  # (S, 4)
    u0: torch.Tensor  # (S, N, 2)
    obs: torch.Tensor  # (S, M, N+1, 3)


class Answers(NamedTuple):
    u: torch.Tensor  # (S, N, 2)
    x: torch.Tensor  # (S, K, 4): states 0..K-1 of the solve
    iters: torch.Tensor  # (S,)
    status: torch.Tensor  # (S,)


class Setting(NamedTuple):
    """What the window's solves share: the line (P, 4) and its window."""

    line: torch.Tensor
    W: int
    w_back: int
    rows: int  # window rows searched per horizon step


def solve(ref: Reference, setting: Setting, tasks: Tasks, device) -> Answers:
    """Every task solved by ``ref``, in blocks of BLOCK rows on ``device``."""
    p = ref.p
    limits = row_limits(p.N, setting.W, setting.w_back, setting.rows)
    line = setting.line.to(device, torch.float64)
    outs = []
    for i in range(0, tasks.x0.shape[0], BLOCK):
        x0, u0, obs = (t[i:i + BLOCK].to(device, torch.float64) for t in tasks)
        win = window(line, x0, setting.W, setting.w_back)
        outs.append(ref.solve(x0, u0, win, limits, obs))
    return Answers(*(torch.cat([getattr(o, f).to("cpu", torch.float64 if f in ("u", "x")
                                                 else torch.int64) for o in outs])
                     for f in ("u", "x", "iters", "status")))


def control_answers(params, setting: Setting, tasks: Tasks, device) -> Answers:
    """The control: the reference in bfloat16 in the program's place."""
    return solve(Reference(params, torch.bfloat16), setting, tasks, device)


def compare(params, setting: Setting, tasks: Tasks, answers: Answers, device) -> dict:
    """The numbers of the program's ``answers`` against the float64
    reference."""
    ref = Reference(params, torch.float64)
    truth = solve(ref, setting, tasks, device)
    u = answers.u.to(torch.float64)
    gap = (u - truth.u).abs().amax((1, 2))
    conv = truth.status == CONVERGED
    iters = answers.iters.to(torch.int64)
    K = answers.x.shape[1]
    rolled = ref.rollout(tasks.x0.to(torch.float64), u)[:, :K]
    return {
        "u_gap_p50": float(gap.median()) if gap.numel() else float("nan"),
        "status_mismatch_share": float((answers.status.to(torch.int64) != truth.status)
                                       .double().mean()),
        "iters_mismatch_share": float((iters != truth.iters)[conv].double().mean())
        if bool(conv.any()) else 0.0,
        "rollout_gap": float((answers.x.to(torch.float64) - rolled).abs().max()),
    }
