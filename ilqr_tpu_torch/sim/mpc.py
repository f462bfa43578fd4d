"""Receding-horizon MPC drivers (PyTorch port).

Counterpart of ``ilqr_tpu/sim/mpc.py``. Reference loop:
src/motion_planning.cpp:180-270 -- each tick solves CILQR on the obstacle
prediction window starting at that tick and applies the second planned
state (``new_x.row(1)``, :197) as the next ego state.

- :func:`run_mpc` -- one scenario, host loop over the eager solver; used by
  the parity tests and the demo app.
- :func:`run_mpc_scan` -- one scenario, the same loop written as the JAX
  package's whole-episode scan: a plain loop over the eager solver on one
  tensor of predictions, sliced by the tick.
- :func:`run_mpc_kernel` -- a batch of episodes, host loop over
  :func:`~ilqr_tpu_torch.ops.cuda.cilqr_kernel.cilqr_solve_cuda`: one
  kernel launch per tick (one per compaction phase with a straggler
  schedule) on CUDA tensors, the plain version on CPU tensors.
- :func:`run_mpc_kernel_scan` / :func:`run_mpc_kernel_chunked` -- the
  same episodes as one device program: the ticks, packed once and built
  in the kernel's layout, with the carry (ego, shifted-u warm start, ALM
  duals) on the device, captured as a CUDA graph and replayed; on CPU
  tensors the same tick code runs eagerly over the plain version. Tick
  for tick bitwise ``run_mpc_kernel``'s.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import numpy as np
import torch

from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
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


def run_mpc_scan(cfg: CILQRConfig, w: CILQRWeights, x0, ref_line, ref_velo,
                 obs_preds_full, road_borders, ticks: int):
    """One scenario's episode in the weights' dtype and device, as
    ``ilqr_tpu.sim.mpc.run_mpc_scan`` takes it: x0 (4,); obs_preds_full
    (M, T, 3) with T >= ticks + N + 1; the rest as in ``Scenario``. Each
    tick solves on the predictions from row t with the carry of the tick
    before, as :func:`run_mpc` does.

    Returns (ego (ticks+1, 4), u_hist (ticks, N, 2), SolveStats with a
    leading ticks axis).
    """
    dtype, dev = w.dtype, w.dt.device
    ego = torch.as_tensor(x0, dtype=dtype, device=dev)[None]
    obs = torch.as_tensor(obs_preds_full, dtype=dtype, device=dev)
    carry = None
    egos, us, stats_hist = [ego[0]], [], []
    for t in range(ticks):
        scenario = Scenario(
            ref_line=torch.as_tensor(ref_line, dtype=dtype, device=dev)[None],
            ref_velo=torch.as_tensor(ref_velo, dtype=dtype, device=dev)[None],
            obs_preds=obs[None, :, t: t + cfg.N + 1],
            road_borders=torch.as_tensor(road_borders, dtype=dtype, device=dev)[None])
        u, x, st, carry = solve(cfg, w, ego, scenario, carry)
        ego = x[:, 1]
        egos.append(ego[0])
        us.append(u[0])
        stats_hist.append(SolveStats(*(getattr(st, f)[0] for f in (
            "iters", "status", "converged", "lamb_overflow", "final_cost", "final_lamb"))))
    return torch.stack(egos), torch.stack(us), _stack_stats(stats_hist)


def run_mpc_kernel(cfg: CILQRConfig, w: CILQRWeights, x0_b, ref_line_b, ref_velo_b,
                   obs_full_b, road_borders_b, ticks: int, window: int = 512,
                   proj_rows_per_step: int = 0, w_back: int = W_BACK,
                   return_alm: bool = False, straggler_cap=0, straggler_cap_warm=None,
                   proj_dot=None, ls_chunk=None, proj_fold=None):
    """Batched receding-horizon episodes on the fused solve, one host
    loop iteration per tick (``ilqr_tpu.sim.mpc.run_mpc_kernel``); the
    yardstick of :func:`run_mpc_kernel_scan`.

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


def _tick_caps(cfg: CILQRConfig, ticks: int, straggler_cap, straggler_cap_warm,
               cold_first_tick: bool) -> tuple:
    """Each tick's straggler schedule (``ck.straggler_schedule``'s phase
    bounds): ``straggler_cap`` on the first tick when ``cold_first_tick``,
    ``straggler_cap_warm`` (when given) on the others
    (ilqr_tpu/sim/mpc.py:266-272)."""
    first = ck.straggler_schedule(straggler_cap, cfg.max_iter)
    warm = (first if straggler_cap_warm is None
            else ck.straggler_schedule(straggler_cap_warm, cfg.max_iter))
    return tuple(first if k == 0 and cold_first_tick else warm for k in range(ticks))


def episode_ticks(cfg: CILQRConfig, w: CILQRWeights, ep: ck.PackedEpisode, ego, t0, carry,
                  caps: tuple, solve=None):
    """The tick chain of :func:`run_mpc_kernel_scan` in the kernel's
    layout, with no host sync (so a CUDA graph can capture it): tick k
    solves on the predictions from row ``t0 + k`` from ego states ``ego``
    (4, B), warm-started from the shifted controls of the tick before
    (``carry`` = (u (2, N, B), mu (8 + 2M, N, B), rho (B,)) before the
    first; mu and rho None outside ALM), each with its schedule ``caps[k]``
    (``ck.solve_packed_sorted``; ``solve`` its phase solver).

    Returns (ego (ticks, B, 4), u (ticks, B, N, 2), stats (ticks, 6, B),
    carry after the last tick)."""
    warm, alm = cfg.use_last_solution, cfg.solve_type == "alm"
    carry_duals = alm and warm
    C0 = cfg.num_constraints
    u_prev, mu, rho = carry
    egos, us, stats = [], [], []
    for k, cap in enumerate(caps):
        uinit = (torch.cat([u_prev[:, 1:], u_prev[:, -1:]], dim=1) if warm
                 else torch.zeros_like(u_prev))
        p = ck.tick_problem(ep, ego, t0 + k, uinit, mu if carry_duals else None,
                            rho if carry_duals else None)
        out = ck.solve_packed_sorted(cfg, w, p, cap, solve=solve)
        ego, u_prev = out.x[:, 1], out.u
        if alm:
            mu, rho = out.mu, out.rho
            mu[C0:] = 0  # the padded obstacle's columns restart inert every tick
        egos.append(ego.T)
        us.append(out.u.permute(2, 1, 0))
        stats.append(out.stats)
    return torch.stack(egos), torch.stack(us), torch.stack(stats), (u_prev, mu, rho)


class _Episode:
    """The static inputs of one episode program on the card: the packed
    episode, the ego states, the tick offset and the carry; and its captured
    tick chains, one CUDA graph per (ticks, schedules). Inputs that change
    between replays are copied in (``load``); a graph's outputs are its own
    static buffers, read before it replays again."""

    def __init__(self, cfg, w, ep: ck.PackedEpisode, B: int):
        dtype, dev = ep.x0_rest.dtype, ep.x0_rest.device
        self.cfg, self.w, self.ep = cfg, w, ep
        self.ego = torch.empty((4, B), dtype=dtype, device=dev)
        self.t0 = torch.zeros((), dtype=torch.int64, device=dev)
        alm = cfg.solve_type == "alm"
        C = 8 + 2 * ep.ox.shape[0]
        self.carry = (torch.empty((2, cfg.N, B), dtype=dtype, device=dev),
                      torch.empty((C, cfg.N, B), dtype=dtype, device=dev) if alm else None,
                      torch.empty((B,), dtype=dtype, device=dev) if alm else None)
        self.graphs = {}

    def load(self, ep: Optional[ck.PackedEpisode], ego, t0, carry) -> None:
        """Copy the inputs of the next replay into the static buffers; the
        packed episode only when given."""
        if ep is not None:
            for f in ("x0_rest", "line", "ox", "oy", "oyaw"):
                getattr(self.ep, f).copy_(getattr(ep, f))
        self.ego.copy_(ego)
        if isinstance(t0, torch.Tensor):
            self.t0.copy_(t0)
        else:
            self.t0.fill_(t0)
        for static, value in zip(self.carry, carry):
            if static is not None:
                static.copy_(value)

    def run(self, caps: tuple):
        """Replay the tick chain of ``caps`` (capturing it on first use) on
        the loaded inputs; returns its static outputs (``episode_ticks``'s).
        The kernel launches the capture recorded are counted in
        ``ck.launches`` at every replay; the capture itself counts none."""
        if caps not in self.graphs:
            self.graphs[caps] = self._capture(caps)
        graph, outs, launched = self.graphs[caps]
        graph.replay()
        ck.launches.update(launched)
        return outs

    def _chain(self, caps):
        return episode_ticks(self.cfg, self.w, self.ep, self.ego, self.t0, self.carry, caps,
                             solve=ck.cilqr_solve_kernel)

    def _capture(self, caps):
        # a warm-up tick on a side stream builds and loads the kernel
        # library and sets its shared-memory attribute before the capture
        side = torch.cuda.Stream(self.ego.device)
        side.wait_stream(torch.cuda.current_stream(self.ego.device))
        with torch.cuda.stream(side):
            self._chain(caps[:1])
        torch.cuda.current_stream(self.ego.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = collections.Counter(ck.launches)
        try:
            with torch.cuda.graph(graph):
                outs = self._chain(caps)
        finally:
            launched = ck.launches - before
            ck.launches.clear()
            ck.launches.update(before)
        return graph, outs, launched


# captured episode programs, by everything a capture depends on; newest last
_EPISODES_KEPT = 8
_episodes: "collections.OrderedDict[tuple, _Episode]" = collections.OrderedDict()


def _episode_key(cfg, w, ep: ck.PackedEpisode, B: int) -> tuple:
    dtype = ep.x0_rest.dtype
    return (cfg, dtype, ep.x0_rest.device, B, tuple(ep.line.shape), tuple(ep.ox.shape),
            ep.sliding, ep.window, ep.w_back, ep.row_limits, ep.modes,
            tuple(sorted(ck.host_weights(w, dtype)[1].items())))


def _episode(cfg, w, ep: ck.PackedEpisode, B: int) -> _Episode:
    """The cached episode program of this shape, inputs not loaded."""
    key = _episode_key(cfg, w, ep, B)
    prog = _episodes.get(key)
    if prog is None:
        prog = _Episode(cfg, w, ep, B)
        _episodes[key] = prog
        while len(_episodes) > _EPISODES_KEPT:
            _episodes.popitem(last=False)
    _episodes.move_to_end(key)
    return prog


def _start(cfg, w, x0_b, ref_line_b, ref_velo_b, obs_full_b, road_borders_b, window,
           proj_rows_per_step, w_back, proj_dot, ls_chunk, proj_fold, carry_in):
    """The packed episode and the carry in the kernel's layout (the
    episode start's when ``carry_in`` is None: zero controls, the cold
    duals)."""
    if x0_b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0_b.device}")
    dtype, dev = x0_b.dtype, x0_b.device
    modes = resolve_modes(dev, proj_dot, ls_chunk, proj_fold)
    ep = ck.pack_episode(cfg, x0_b, ref_line_b, ref_velo_b, obs_full_b, road_borders_b, window,
                         w_back, proj_rows_per_step, modes)
    B, N, C0 = x0_b.shape[0], cfg.N, cfg.num_constraints
    alm = cfg.solve_type == "alm"
    C = 8 + 2 * ep.ox.shape[0]
    if carry_in is None:
        u = torch.zeros((2, N, B), dtype=dtype, device=dev)
        mu = torch.zeros((C, N, B), dtype=dtype, device=dev) if alm else None
        rho = w.alm_rho_init.to(dtype).expand(B).contiguous() if alm else None
    else:
        u_in, mu_in, rho_in = carry_in
        u = u_in.to(dtype).permute(2, 1, 0).contiguous()
        mu = rho = None
        if alm:
            mu = torch.zeros((C, N, B), dtype=dtype, device=dev)
            mu[:C0] = mu_in.to(dtype).permute(2, 1, 0)
            rho = torch.as_tensor(rho_in, dtype=dtype, device=dev).expand(B).contiguous()
    return ep, (u, mu, rho)


def _check_ticks(cfg, obs_full_b, t0, ticks) -> None:
    if ticks < 1:
        raise ValueError(f"ticks={ticks}: an episode needs at least one tick")
    if cfg.num_obstacles and isinstance(t0, int):
        need = t0 + ticks + cfg.N + 1
        if obs_full_b.shape[2] < need:
            raise ValueError(f"obstacle predictions hold {obs_full_b.shape[2]} rows; "
                             f"ticks [{t0}, {t0 + ticks}) need {need}")


def _carry_out(cfg, carry) -> tuple:
    """The carry in the JAX layout: u (B, N, 2), mu (B, N, C0), rho (B,)."""
    u, mu, rho = carry
    if mu is None:
        return (u.permute(2, 1, 0).clone(), None, None)
    return (u.permute(2, 1, 0).clone(), mu[:cfg.num_constraints].permute(2, 1, 0).clone(),
            rho.clone())


def run_mpc_kernel_scan(cfg: CILQRConfig, w: CILQRWeights, x0_b, ref_line_b, ref_velo_b,
                        obs_full_b, road_borders_b, ticks: int, window: int = 512,
                        straggler_cap=0, proj_rows_per_step: int = 0, t0=0, carry_in=None,
                        with_carry: bool = False, straggler_cap_warm=None,
                        cold_first_tick: bool = True, w_back: int = W_BACK, proj_dot=None,
                        ls_chunk=None, proj_fold=None):
    """Batched receding-horizon episodes as one device program
    (``ilqr_tpu.sim.mpc.run_mpc_kernel_scan``), tick for tick bitwise
    :func:`run_mpc_kernel`'s.

    The episode is packed once (``ck.pack_episode``); each tick builds its
    window and obstacle rows in the kernel's layout and solves with
    ``ck.solve_packed_sorted``; the carry (ego, the shifted-u warm start,
    ALM duals) stays on the device in the kernel's layout. On CUDA tensors
    the ``ticks`` ticks are captured once as a CUDA graph (cached by
    configuration, dtype, batch, shapes, modes, weights and schedules) and
    replayed; a capture, build or launch failure raises. On CPU tensors the
    same tick code runs eagerly over the plain version.

    ``t0`` (an int or a 0-d integer tensor, which the graph reads at
    replay) offsets the prediction window: tick k uses predictions from row
    ``t0 + k``. ``carry_in`` = (u_prev (B, N, 2), alm_mu (B, N, C0),
    alm_rho (B,)) seeds the cross-tick state (mu and rho are read in ALM
    mode only); None is the episode start. ``with_carry`` also returns the
    final carry in that layout. ``straggler_cap`` is the first tick's
    schedule when ``cold_first_tick``, ``straggler_cap_warm`` (when given)
    every other tick's; each schedule runs every phase over the whole
    sorted batch, as the JAX package ran it. The other arguments as
    :func:`run_mpc_kernel`.

    Returns (ego (ticks+1, B, 4), u_hist (ticks, B, N, 2), SolveStats with
    a leading ticks axis[, carry_out]).
    """
    _check_ticks(cfg, obs_full_b, t0, ticks)
    ep, carry = _start(cfg, w, x0_b, ref_line_b, ref_velo_b, obs_full_b, road_borders_b,
                       window, proj_rows_per_step, w_back, proj_dot, ls_chunk, proj_fold,
                       carry_in)
    caps = _tick_caps(cfg, ticks, straggler_cap, straggler_cap_warm, cold_first_tick)
    if x0_b.device.type == "cpu":
        egos, us, slabs, carry = episode_ticks(cfg, w, ep, x0_b.T, t0, carry, caps)
    else:
        prog = _episode(cfg, w, ep, x0_b.shape[0])
        prog.load(ep, x0_b.T, t0, carry)
        egos, us, slabs, carry = prog.run(caps)
    out = (torch.cat([x0_b[None], egos]), us.clone(), ck.unpack_stats(slabs.clone()))
    return out + (_carry_out(cfg, carry),) if with_carry else out


def run_mpc_kernel_chunked(cfg: CILQRConfig, w: CILQRWeights, x0_b, ref_line_b, ref_velo_b,
                           obs_full_b, road_borders_b, ticks: int, chunk: int = 10,
                           window: int = 512, straggler_cap=0, proj_rows_per_step: int = 0,
                           straggler_cap_warm=None, w_back: int = W_BACK, proj_dot=None,
                           ls_chunk=None, proj_fold=None):
    """:func:`run_mpc_kernel_scan` in ``ticks // chunk`` chunks of
    ``chunk`` ticks (``ilqr_tpu.sim.mpc.run_mpc_kernel_chunked``): the
    episode is packed and loaded once, and each chunk replays one graph
    with the carry kept on the device -- at most two graphs, the first
    chunk's and the continuations' (whose first tick is warm). ``ticks``
    must be a multiple of ``chunk``. Returns what ``run_mpc_kernel_scan``
    returns without the carry."""
    if chunk < 1 or ticks % chunk:
        raise ValueError(f"ticks={ticks} must be a multiple of chunk={chunk}")
    _check_ticks(cfg, obs_full_b, 0, ticks)
    ep, carry = _start(cfg, w, x0_b, ref_line_b, ref_velo_b, obs_full_b, road_borders_b,
                       window, proj_rows_per_step, w_back, proj_dot, ls_chunk, proj_fold, None)
    B = x0_b.shape[0]
    egos = torch.empty((ticks + 1, B, 4), dtype=x0_b.dtype, device=x0_b.device)
    us = torch.empty((ticks, B, cfg.N, 2), dtype=x0_b.dtype, device=x0_b.device)
    slabs = torch.empty((ticks, 6, B), dtype=x0_b.dtype, device=x0_b.device)
    egos[0] = x0_b
    cuda = x0_b.device.type == "cuda"
    prog = _episode(cfg, w, ep, B) if cuda else None
    ego = x0_b.T
    for c in range(ticks // chunk):
        caps = _tick_caps(cfg, chunk, straggler_cap, straggler_cap_warm,
                          c == 0 or straggler_cap_warm is None)
        if cuda:
            prog.load(ep if c == 0 else None, ego, c * chunk, carry)
            e, u, s, carry = prog.run(caps)
        else:
            e, u, s, carry = episode_ticks(cfg, w, ep, ego, c * chunk, carry, caps)
        rows = slice(c * chunk, (c + 1) * chunk)
        egos[c * chunk + 1: (c + 1) * chunk + 1] = e
        us[rows] = u
        slabs[rows] = s
        ego = e[-1].T
    return egos, us, ck.unpack_stats(slabs)
