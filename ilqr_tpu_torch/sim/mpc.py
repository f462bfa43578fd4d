"""Receding-horizon MPC drivers (PyTorch port).

Counterpart of ``ilqr_tpu/sim/mpc.py``. Reference loop:
src/motion_planning.cpp:180-270 -- each tick solves CILQR on the obstacle
prediction window starting at that tick and applies the second planned
state (``new_x.row(1)``, :197) as the next ego state.

- :func:`run_mpc` -- one scenario, host loop over the eager solver; used by
  the parity tests and the demo app.
- :func:`run_mpc_kernel` -- a batch of episodes, host loop over
  :func:`~ilqr_tpu_torch.ops.cuda.cilqr_kernel.cilqr_solve_cuda`: one
  kernel launch per tick (one per compaction phase with a straggler
  schedule) on CUDA tensors, the plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ilqr_tpu_torch.ops.cuda.cilqr_kernel import W_BACK, cilqr_solve_cuda, resolve_modes
from ilqr_tpu_torch.solvers.cilqr import solve
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, Scenario, SolveStats


def _stack_stats(stats_hist) -> SolveStats:
    return SolveStats(*(torch.stack([getattr(s, f) for s in stats_hist])
                        for f in ("iters", "status", "converged", "lamb_overflow",
                                  "final_cost", "final_lamb")))


def run_mpc(cfg: CILQRConfig, w: CILQRWeights, setup, ticks: Optional[int] = None,
            on_tick: Optional[Callable] = None):
    """Host-driven episode of one scenario in the weights' dtype and device.

    Returns a dict of stacked numpy histories: ego (ticks+1, 4), u (ticks,
    N, 2), x (ticks, N+1, 4) and a list of per-tick ``SolveStats`` of
    numpy scalars.
    """
    ticks = ticks if ticks is not None else setup.num_ticks
    dtype, dev = w.dtype, w.dt.device
    ego = torch.as_tensor(setup.ego_x0, dtype=dtype, device=dev)[None]
    carry = None
    ego_hist, u_hist, x_hist, stats_hist = [ego[0].cpu().numpy()], [], [], []
    for t in range(ticks):
        scenario = setup.device_scenario(tick=t, horizon=cfg.N, dtype=dtype, device=dev)
        u, x, stats, carry = solve(cfg, w, ego, scenario, carry)
        ego = x[:, 1]
        st = SolveStats(*(getattr(stats, f)[0].cpu().numpy() for f in (
            "iters", "status", "converged", "lamb_overflow", "final_cost", "final_lamb")))
        ego_hist.append(ego[0].cpu().numpy())
        u_hist.append(u[0].cpu().numpy())
        x_hist.append(x[0].cpu().numpy())
        stats_hist.append(st)
        if on_tick is not None:
            on_tick(t, u_hist[-1], x_hist[-1], st)
    return {
        "ego": np.stack(ego_hist),
        "u": np.stack(u_hist),
        "x": np.stack(x_hist),
        "stats": stats_hist,
    }


def run_mpc_kernel(cfg: CILQRConfig, w: CILQRWeights, x0_b, ref_line_b, ref_velo_b,
                   obs_full_b, road_borders_b, ticks: int, window: int = 512,
                   proj_rows_per_step: int = 0, w_back: int = W_BACK,
                   return_alm: bool = False, straggler_cap=0, straggler_cap_warm=None,
                   proj_dot=None, ls_chunk=None, proj_fold=None):
    """Batched receding-horizon episodes on the fused solve.

    Stands for the JAX package's fused-kernel episode functions,
    ``ilqr_tpu.sim.mpc.run_mpc_kernel_scan`` and ``run_mpc_kernel_chunked``,
    tick for tick; their ``lax.scan`` unroll and 10-tick chunks exist for
    TPU compiler reasons and have no counterpart here.

    x0_b (B, 4); ref_line_b (B, P, 4); ref_velo_b (B,); obs_full_b
    (B, M, T, 3) with T >= ticks + N + 1; road_borders_b (B, 2). The
    reference's shifted-previous-u warm start (src/cilqr_solver.cpp:163-180)
    is applied when ``cfg.use_last_solution``; the first tick is cold. In
    ALM mode the duals (mu, rho) persist across ticks under
    ``use_last_solution``, like the reference's members (:88-102) and
    ``ilqr_tpu.sim.mpc.run_mpc_kernel``; otherwise every tick starts from
    the cold reset.

    ``straggler_cap`` is the straggler schedule of the first tick
    (``cilqr_solve_cuda``); ``straggler_cap_warm``, when given, that of
    every later tick (ilqr_tpu/sim/mpc.py:197-202, :266-272). Compaction
    changes no result, only how the ticks' solves are launched.

    ``proj_dot``, ``ls_chunk`` and ``proj_fold`` are every tick's modes,
    resolved once, as ``cilqr_solve_cuda`` resolves them (None: the
    ``ILQR_*`` variables, else the device's default -- on the card the dot
    form with chunks of 4, as the JAX package runs on its chip).

    Returns (ego (ticks+1, B, 4), u_hist (ticks, B, N, 2), SolveStats with a
    leading ticks axis), plus the last tick's duals (alm_mu (B, N, C0),
    alm_rho (B,)) when ``return_alm`` (ALM mode only).
    """
    if return_alm and cfg.solve_type != "alm":
        raise ValueError("return_alm needs solve_type='alm'")
    alm = cfg.solve_type == "alm"
    modes = resolve_modes(x0_b.device, proj_dot, ls_chunk, proj_fold)
    ego = x0_b
    u_prev = None
    duals = (None, None)
    egos, us, stats_hist = [ego], [], []
    for t in range(ticks):
        scenario = Scenario(ref_line=ref_line_b, ref_velo=ref_velo_b,
                            obs_preds=obs_full_b[:, :, t: t + cfg.N + 1],
                            road_borders=road_borders_b)
        u_init = None
        if cfg.use_last_solution and u_prev is not None:
            u_init = torch.cat([u_prev[:, 1:], u_prev[:, -1:]], dim=1)
        cap = straggler_cap if t == 0 or straggler_cap_warm is None else straggler_cap_warm
        kw = dict(window=window, u_init=u_init, proj_rows_per_step=proj_rows_per_step,
                  w_back=w_back, straggler_cap=cap, **modes._asdict())
        if alm:
            mu0, rho0 = duals if cfg.use_last_solution else (None, None)
            u, x, st, duals = cilqr_solve_cuda(cfg, w, ego, scenario, alm_mu0=mu0,
                                               alm_rho0=rho0, return_alm=True, **kw)
        else:
            u, x, st = cilqr_solve_cuda(cfg, w, ego, scenario, **kw)
        ego = x[:, 1]
        u_prev = u
        egos.append(ego)
        us.append(u)
        stats_hist.append(st)
    out = (torch.stack(egos), torch.stack(us), _stack_stats(stats_hist))
    return out + (duals,) if return_alm else out
