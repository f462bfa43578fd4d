"""Constrained iLQR solver (CILQR), eager and batched -- the port's reference
solver.

Counterpart of ``ilqr_tpu/solvers/cilqr.py``, matching ``CILQRSolver::solve``
(reference src/cilqr_solver.cpp:85-153) in both constraint modes (exponential
barrier / augmented Lagrangian), with the lambda schedule, the backtracking
line search and its acceptance rule, warm starting and the
``LQRSolveStatus`` state machine, including the reference's quirks:

- a CONVERGED line-search trial is *not* adopted (src/cilqr_solver.cpp:
  352-361 + :113-116);
- ALM duals update only on line-search exhaustion (:377-379);
- lambda reacts only to {BACKWARD,FORWARD}_PASS_FAIL and RUNNING;
  SMALL_STEP and CONVERGED leave it unchanged (:118-125).

Every tensor carries a leading scenario axis B, and any weight may be a (B,)
tensor of per-row values (``solve_batch(weights_batched=True)``). Per-row control flow is
masked: an iteration runs while any row is active, and a row's state only
changes while it is. The line search walks the alphas serially, stopping
each row at its first hit and the loop when every row has stopped -- the
same results as the JAX package's breadth-first search at any width. It
can roll its trials out in chunks of alphas (``ls_chunk``, the fused
solve's chunked line search) with the same results, bit for bit.

``cfg.riccati_impl="pscan"`` runs the backward pass as a log-depth scan
(``ops/riccati_pscan.py``, regularizing the gains only) in place of the
sequential recursion.

This solver is the port's CPU path and the float64 comparator of the CUDA
kernel (``ops/cuda/cilqr_kernel.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.models.bicycle import kinematic_jacobians, rollout
from ilqr_tpu_torch.ops.cost import cost_and_derivatives, total_cost
from ilqr_tpu_torch.ops.projection import Modes
from ilqr_tpu_torch.ops.riccati import backward_pass, forward_pass
from ilqr_tpu_torch.ops.riccati_pscan import parallel_lqr_backward
from ilqr_tpu_torch.types import (
    CILQRCarry,
    CILQRConfig,
    CILQRWeights,
    Scenario,
    SolveStats,
    SolveStatus,
    entry_device,
    numpy_dtype,
    per_row,
)
from ilqr_tpu_torch.utils.counters import K1_STATUSES
from ilqr_tpu_torch.utils.refline import ReferenceLine, RoutingLine

__all__ = [
    "CILQRConfig",
    "CILQRWeights",
    "CILQRCarry",
    "CILQRSolver",
    "ResumeState",
    "SolveStatus",
    "solve",
    "solve_batch",
    "solve_from_controls",
]


def alpha_schedule(min_alpha: float):
    """alpha = 1, 0.5, ... while alpha > min_alpha
    (reference src/cilqr_solver.cpp:354): 20 trials at the default 1e-6."""
    alphas = []
    a = 1.0
    while a > min_alpha:
        alphas.append(a)
        a *= 0.5
    return tuple(alphas)


class _LineSearchResult(NamedTuple):
    accepted: torch.Tensor
    converged: torch.Tensor
    small_step: torch.Tensor
    new_u: torch.Tensor
    new_x: torch.Tensor


def _forward_chunk(cfg, w, u, x, d, K, alphas):
    """The trial rollouts of a chunk of alphas as one batched chain, the
    chunk's axis leading: (new_u (CW, B, N, 2), new_x (CW, B, N+1, 4)).
    Every operation is elementwise or a per-row product, and the alphas are
    exact powers of two, so trial a is bitwise the serial rollout at
    alphas[a]; its slice stays contiguous, so the horizon sums of its cost
    run in the serial order too."""
    cw, B = len(alphas), u.shape[0]
    al = torch.tensor(alphas, dtype=u.dtype, device=u.device).repeat_interleave(B)[:, None]

    def rep(t):
        return t.repeat(cw, *(1,) * (t.dim() - 1))

    dt, wheelbase = (t if t.dim() == 0 else rep(t) for t in (w.dt, w.wheelbase))
    nu, nx = forward_pass(rep(u), rep(x), rep(d), rep(K), al, dt, wheelbase,
                          cfg.reference_point)
    return nu.view(cw, *u.shape), nx.view(cw, *x.shape)


def _line_search(cfg, w, u, x, d, K, ori_cost, dV1, dV2, scenario, alm_rho,
                 alm_mu, searching, row_limits, work=None,
                 modes: Modes = Modes()) -> _LineSearchResult:
    """Backtracking line search (reference src/cilqr_solver.cpp:354-372) for
    the rows in ``searching``; each row stops at its first hit.

    ``modes.ls_chunk`` > 0 rolls the trials out that many alphas at a time
    (``_forward_chunk``; alphas past the last are not rolled out) and then
    judges them one alpha at a time in order, as the serial search does.
    ``work["trials"]`` counts the rollouts, ``work["evals"]`` the trials
    projected and costed and ``work["chunks"]`` the chunks rolled out (a
    trial each when serial), all over the rows still searching."""
    done = ~searching
    acc = torch.zeros_like(done)
    conv = torch.zeros_like(done)
    small = torch.zeros_like(done)
    best_u, best_x = u, x
    alphas = alpha_schedule(cfg.min_alpha)
    ls_chunk = modes.ls_chunk
    width = ls_chunk or 1
    for t0 in range(0, len(alphas), width):
        if bool(done.all()):
            break
        chunk = alphas[t0:t0 + width]
        if work is not None:
            work["chunks"] += int((~done).sum())
            work["trials"] += len(chunk) * int((~done).sum())
        if ls_chunk:
            chunk_u, chunk_x = _forward_chunk(cfg, w, u, x, d, K, chunk)
        for a, alpha in enumerate(chunk):
            if a and bool(done.all()):
                break
            t = t0 + a
            if work is not None:
                work["evals"] += int((~done).sum())
            if ls_chunk:
                nu, nx = chunk_u[a], chunk_x[a]
            else:
                nu, nx = forward_pass(u, x, d, K, alpha, w.dt, w.wheelbase, cfg.reference_point)
            nJ = total_cost(cfg, w, nu, nx, scenario, alm_rho, alm_mu, row_limits, modes)
            decay = ori_cost - nJ
            # the convergence check precedes the acceptance check at alpha == 1
            # (src/cilqr_solver.cpp:358-365)
            conv_now = ~done & (torch.abs(decay) < w.convergence_threshold)
            if t > 0:
                conv_now = torch.zeros_like(done)
            approx = -(alpha * alpha * dV1 + alpha * dV2)
            # the reference divides unguarded; accept-at-inf without NaN
            ratio = torch.where(approx != 0, decay / approx, torch.full_like(decay, float("inf")))
            acc_now = ~done & ~conv_now & (decay > 0) & (
                (approx < 0) | (ratio > w.accept_step_threshold))
            best_u = torch.where(acc_now[:, None, None], nu, best_u)
            best_x = torch.where(acc_now[:, None, None], nx, best_x)
            if t > 0:
                small = small | acc_now
            acc = acc | acc_now
            conv = conv | conv_now
            done = done | acc_now | conv_now
    return _LineSearchResult(acc, conv, small, best_u, best_x)


class ResumeState(NamedTuple):
    """Where a solve stopped, to restart it there (straggler compaction):
    the next iteration ``it0`` and each row's iterations, status, lambda
    and stop flags so far. The rows' controls and ALM duals come in as
    ``u0`` and ``alm_mu0``/``alm_rho0``. A row that stopped (converged or
    overflowed) passes through unchanged, as the kernel's resume entry
    passes it."""

    it0: int
    iters: torch.Tensor  # (B,) int32
    status: torch.Tensor  # (B,) int32
    lamb: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,) bool
    overflow: torch.Tensor  # (B,) bool


def solve_from_controls(cfg: CILQRConfig, w: CILQRWeights, x0, u0, scenario: Scenario,
                        alm_rho0=None, alm_mu0=None, row_limits=None, work=None,
                        max_iter: Optional[int] = None, resume: Optional[ResumeState] = None,
                        modes: Modes = Modes()):
    """The solve loop from initial controls u0 (B, N, 2).

    Returns (u (B,N,2), x (B,N+1,4), SolveStats, alm_rho (B,), alm_mu (B,N,C)).
    ``alm_rho0``/``alm_mu0`` default to the reference's cold reset
    (src/cilqr_solver.cpp:88-93). A ``work`` dict gets the counts of what
    each row needed, summed over rows: ``trials`` (line-search rollouts),
    ``evals`` (trials projected and costed; equal to ``trials`` unless the
    line search runs in chunks), ``chunks`` (the line search's chunks),
    ``dual_updates`` (ALM dual steps), ``iters`` (the iterations this call
    ran) and, under the names of ``utils/counters.py:K1_STATUSES``, the
    iterations that ended in each status: the tally K1 keeps in its record.
    ``modes`` are the fused solve's projection mode and line-search chunk
    width (``ops/projection.py``).

    The loop runs iterations [0, max_iter) (``cfg.max_iter`` when None),
    or [resume.it0, max_iter) from a ``resume`` state: u0 is then the
    controls the stopped solve had, and their rollout is the trajectory it
    had, bit for bit (``rollout`` and the line search's trial propagate the
    same values), so a capped solve resumed here equals one uncapped solve.
    """
    if work is not None:
        for key in ("trials", "evals", "chunks", "dual_updates", "iters", *K1_STATUSES):
            work.setdefault(key, 0)
    if cfg.riccati_impl not in ("scan", "pscan"):
        raise ValueError(f"unknown riccati_impl {cfg.riccati_impl!r}")
    Bn = x0.shape[0]
    dev = x0.device
    alm = cfg.solve_type == "alm"
    rho = w.alm_rho_init.expand(Bn).clone() if alm_rho0 is None else alm_rho0
    # contiguous from the start, as every later iterate is: the horizon sums
    # of the cost run in another order over a strided view, so a solve
    # resumed from packed (permuted) inputs would part from the uncapped one
    mu = (x0.new_zeros((Bn, cfg.N, cfg.num_constraints)) if alm_mu0 is None
          else alm_mu0.contiguous())
    u = u0.contiguous()
    x = rollout(x0, u0, w.dt, w.wheelbase, cfg.reference_point)
    if resume is None:
        it0 = 0
        lamb = w.init_lamb.expand(Bn).clone()
        status = torch.zeros(Bn, dtype=torch.int32, device=dev)
        itr = torch.zeros(Bn, dtype=torch.int32, device=dev)
        converged = torch.zeros(Bn, dtype=torch.bool, device=dev)
        overflow = torch.zeros_like(converged)
    else:
        it0, itr, status, lamb, converged, overflow = resume
    done = converged | overflow

    def code(s):
        return torch.tensor(s, dtype=torch.int32, device=dev)

    for _ in range(it0, cfg.max_iter if max_iter is None else max_iter):
        active = ~done
        if not bool(active.any()):
            break
        # the iteration's cost (== ori_cost of src/cilqr_solver.cpp:342) and
        # its derivatives from one pass
        ori_cost, der = cost_and_derivatives(cfg, w, u, x, scenario, rho, mu, row_limits, modes)
        A, Bm = kinematic_jacobians(x[:, :-1], u, per_row(w.dt, 2), per_row(w.wheelbase, 2),
                                    cfg.reference_point)
        if cfg.riccati_impl == "pscan":
            bw = parallel_lqr_backward(A, Bm, der.l_x, der.l_u, der.l_xx, der.l_uu, lamb=lamb)
        else:
            bw = backward_pass(A, Bm, der.l_x, der.l_u, der.l_xx, der.l_uu, lamb)
        ls = _line_search(cfg, w, u, x, bw.d, bw.K, ori_cost, bw.dV1, bw.dV2, scenario,
                          rho, mu, active & ~bw.fail, row_limits, work, modes)

        bp_failed = active & bw.fail
        accepted = active & ~bw.fail & ls.accepted
        converged_now = active & ~bw.fail & ls.converged
        exhausted = active & ~bw.fail & ~ls.accepted & ~ls.converged

        u = torch.where(accepted[:, None, None], ls.new_u, u)
        x = torch.where(accepted[:, None, None], ls.new_x, x)
        new_status = torch.where(
            bp_failed, code(SolveStatus.BACKWARD_PASS_FAIL),
            torch.where(converged_now, code(SolveStatus.CONVERGED),
                        torch.where(exhausted, code(SolveStatus.FORWARD_PASS_FAIL),
                                    torch.where(ls.small_step & accepted,
                                                code(SolveStatus.FORWARD_PASS_SMALL_STEP),
                                                code(SolveStatus.RUNNING)))))
        status = torch.where(active, new_status, status)
        if work is not None:
            work["iters"] += int(active.sum())
            for value, name in enumerate(K1_STATUSES):
                work[name] += int((active & (new_status == value)).sum())

        if alm:
            if work is not None:
                work["dual_updates"] += int(exhausted.sum())
            mu = torch.where(exhausted[:, None, None], der.alm_mu_next, mu)
            rho = torch.where(exhausted,
                              torch.minimum((1.0 + w.alm_gamma) * rho, w.max_rho), rho)

        is_fail = bp_failed | exhausted
        lamb = torch.where(
            is_fail, torch.maximum(w.lamb_amplify, lamb * w.lamb_amplify),
            torch.where(active & (status == SolveStatus.RUNNING), lamb * w.lamb_decay, lamb))
        overflow_now = active & (lamb > w.max_lamb)
        converged = converged | converged_now
        overflow = overflow | overflow_now
        done = done | overflow_now | converged_now
        itr = itr + active.to(torch.int32)

    stats = SolveStats(
        iters=itr,
        status=status,
        converged=converged,
        lamb_overflow=overflow,
        final_cost=total_cost(cfg, w, u, x, scenario, rho, mu, row_limits, modes),
        final_lamb=lamb,
    )
    return u, x, stats, rho, mu


def solve(cfg: CILQRConfig, w: CILQRWeights, x0, scenario: Scenario,
          carry: Optional[CILQRCarry] = None, row_limits=None):
    """One full CILQR solve per scenario row.

    Args:
      x0: (B, 4) initial ego states.
      scenario: batched ``Scenario``; ``obs_preds`` is the (B, M, N+1, 3)
        prediction window starting at the current tick.
      carry: warm-start + ALM state from the previous solve (or None).

    Returns: (u (B,N,2), x (B,N+1,4), SolveStats, CILQRCarry).
    """
    Bn = x0.shape[0]
    if carry is None:
        carry = CILQRCarry.init(cfg, w, Bn)
    first = carry.is_first
    # ALM state reset policy (reference src/cilqr_solver.cpp:88-93)
    if cfg.solve_type == "alm" and cfg.use_last_solution:
        alm_rho0 = torch.where(first, w.alm_rho_init, carry.alm_rho)
        alm_mu0 = torch.where(first[:, None, None], torch.zeros_like(carry.alm_mu),
                              carry.alm_mu)
    else:
        alm_rho0 = alm_mu0 = None
    # zero controls, or the one-step-shifted previous solution when warm
    # starting (reference src/cilqr_solver.cpp:155-180)
    u0 = x0.new_zeros((Bn, cfg.N, cfg.nu))
    if cfg.use_last_solution:
        shifted = torch.cat([carry.last_u[:, 1:], carry.last_u[:, -1:]], dim=1)
        u0 = torch.where(first[:, None, None], u0, shifted)
    u, x, stats, rho, mu = solve_from_controls(cfg, w, x0, u0, scenario, alm_rho0,
                                               alm_mu0, row_limits)
    new_carry = CILQRCarry(last_u=u, is_first=torch.zeros_like(first), alm_rho=rho,
                           alm_mu=mu)
    return u, x, stats, new_carry


def solve_batch(cfg: CILQRConfig, w: CILQRWeights, x0, scenario: Scenario,
                carry: Optional[CILQRCarry] = None, weights_batched: bool = False):
    """:func:`solve` over the leading batch axis of x0 / scenario / carry,
    as ``ilqr_tpu.solvers.cilqr.solve_batch`` vmaps it, with every weight a
    scalar, or with ``weights_batched`` every weight a (B,) tensor of
    per-row values (yaml-parameter sweeps). Per-row weights run on this
    eager solver only: the fused kernel reads one set of weights a launch
    and refuses them."""
    shapes = w.row_shapes
    want = {(x0.shape[0],)} if weights_batched else {()}
    if shapes != want:
        raise ValueError(f"weights_batched={weights_batched} needs every weight of shape "
                         f"{next(iter(want))}; got shapes {sorted(shapes)}")
    return solve(cfg, w, x0, scenario, carry)


class CILQRSolver:
    """Reference-style OO wrapper (include/cilqr_solver.hpp:31-41): construct
    from a config, call ``solve(x0, ref_line, ref_velo, obs_preds,
    road_borders)`` repeatedly for one scenario; warm start and ALM duals
    are carried across calls. Runs on the GPU unless ``device="cpu"``; with
    no GPU the default raises."""

    def __init__(self, config: GlobalConfig, dtype=torch.float64, device="cuda",
                 num_obstacles: Optional[int] = None, **cfg_overrides):
        self.gc = config
        self.dtype = dtype
        self.device = entry_device(device)
        self.cfg = CILQRConfig.from_global_config(config, num_obstacles, **cfg_overrides)
        self.weights = CILQRWeights.from_global_config(config, dtype, self.device)
        self.reset()

    def reset(self):
        self.carry = CILQRCarry.init(self.cfg, self.weights, 1)

    def solve(self, x0, ref_line, ref_velo, obs_preds, road_borders):
        """Host arrays / ReferenceLine / RoutingLines in, numpy out."""
        scenario = self.make_scenario(ref_line, ref_velo, obs_preds, road_borders)
        x0 = torch.as_tensor(np.asarray(x0), dtype=self.dtype, device=self.device)[None]
        u, x, stats, self.carry = solve(self.cfg, self.weights, x0, scenario, self.carry)
        self.last_stats = SolveStats(*(v[0].cpu().numpy() for v in (
            stats.iters, stats.status, stats.converged, stats.lamb_overflow,
            stats.final_cost, stats.final_lamb)))
        return u[0].cpu().numpy(), x[0].cpu().numpy()

    def make_scenario(self, ref_line, ref_velo, obs_preds, road_borders) -> Scenario:
        npd = numpy_dtype(self.dtype)
        N = self.cfg.N
        if isinstance(ref_line, ReferenceLine):
            ref_arr = ref_line.as_array(dtype=npd)
        else:
            ref_arr = np.asarray(ref_line, dtype=npd)
        if isinstance(obs_preds, (list, tuple)):
            window = np.stack([
                (rl.as_array(npd) if isinstance(rl, RoutingLine)
                 else np.asarray(rl, dtype=npd))[: N + 1]
                for rl in obs_preds
            ], axis=0) if len(obs_preds) else np.zeros((0, N + 1, 3), npd)
        else:
            window = np.asarray(obs_preds, dtype=npd)[:, : N + 1]

        def t(a):
            return torch.as_tensor(np.asarray(a, npd), device=self.device)[None]

        return Scenario(ref_line=t(ref_arr), ref_velo=t(ref_velo), obs_preds=t(window),
                        road_borders=t(road_borders))
