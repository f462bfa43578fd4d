"""Single-device entry and multi-device dry run of the batched solver.

Counterpart of the JAX package's entry points in ``__graft_entry__.py``:

- :func:`entry` -- the single-device batched solve: 8 perturbed starts of
  ``configs/scenario_two_straight.yaml`` (seed 0), float32, max_iter 100,
  through ``solve_batch``; returns ``(fn, args)`` with ``fn(*args) -> (u,
  x, iters, converged)``;
- :func:`dryrun_multichip` -- four legs on tiny shapes over an
  ``n_devices`` mesh (``parallel.make_mesh``), the batch (2 rows a device)
  row-partitioned over it:

  (a) the sharded eager solve (``sharded_solve_fn``, N = 30, max_iter 3);
  (b) the sharded fused kernel (``sharded_kernel_solve_fn``, N = 6, window
      64, straggler_cap 2);
  (c) a 2-tick ALM warm-start episode through ``run_mpc_kernel_scan`` on
      each shard (window 64);
  (d) ``run_mpc_chunked_sharded``: 4 ticks in chunks of 2, cap 2.

  On a card, legs (b)-(d) launch the fused CUDA kernel (``csrc/
  cilqr_kernel.cu``; (b) its barrier instantiation, (c) and (d) the ALM
  one, warm, with the duals carried); on the CPU they run its plain
  version. :func:`single_device_legs` runs the same legs over the whole
  batch with no mesh (``solve_batch``, ``cilqr_solve_cuda``,
  ``run_mpc_kernel_scan``, ``run_mpc_kernel_chunked``); each leg's rows
  are bitwise equal to it.

Usage:
    python -m ilqr_tpu_torch.apps.dryrun [--devices N] [--device cuda|cpu]

The entry points run on the card unless the caller asks for the CPU, and
raise without one. On the CPU the mesh is N copies of the CPU; on the card
it holds the first N cards, and asking for more cards than there are
raises. Under a ``torch.distributed`` process group each rank solves its
own block of the batch (``2 * N`` rows a rank) and the summaries cover
every rank's rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.ops.cuda.cilqr_kernel import cilqr_solve_cuda
from ilqr_tpu_torch.parallel import make_mesh, run_mpc_chunked_sharded, sharded_kernel_solve_fn
from ilqr_tpu_torch.parallel.sharding import (
    replicate,
    shard_batch,
    shard_batch_multihost,
    sharded_solve_fn,
)
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_chunked, run_mpc_kernel_scan
from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
from ilqr_tpu_torch.solvers.cilqr import solve_batch
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, entry_device
from ilqr_tpu_torch.utils.tree import tree_map

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "scenario_two_straight.yaml"
ROWS_PER_DEVICE = 2
MAX_ITER = 3  # the dry run's solves (legs a-d)
KERNEL_N = 6  # legs (b)-(d): the horizon cut from 30
WINDOW = 64
STRAGGLER_CAP = 2
EPISODE_TICKS = 2  # leg (c)
CHUNKED_TICKS, CHUNK = 4, 2  # leg (d)


def build_problem(dtype, batch: int, max_iter: int, device="cpu", horizon=None):
    """(setup, cfg, w, x0 (batch, 4), scenario of batch rows): ``batch``
    perturbed starts (seed 0) of the flagship scenario at tick 0, cold."""
    gc = GlobalConfig.from_file(str(CONFIG))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, max_iter=max_iter)
    if horizon is not None:
        cfg = dataclasses.replace(cfg, N=horizon)
    w = CILQRWeights.from_global_config(gc, dtype, device)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, batch, seed=0), dtype=dtype,
                         device=device)
    sc = st.device_scenario(tick=0, horizon=cfg.N, dtype=dtype, device=device, batch=batch)
    return st, cfg, w, x0, sc


def entry(device="cuda"):
    """(fn, example_args): the batched CILQR solve of the flagship scenario
    on one device, ``fn(w, x0_b, scen_b) -> (u, x, iters, converged)``."""
    dev = entry_device(device)
    _, cfg, w, x0, sc = build_problem(torch.float32, batch=8, max_iter=100, device=dev)

    def fn(w, x0_b, scen_b):
        u, x, stats, _ = solve_batch(cfg, w, x0_b, scen_b)
        return u, x, stats.iters, stats.converged

    return fn, (w, x0, sc)


def _problems(batch: int, device):
    """The legs' inputs over ``batch`` rows: the eager leg's problem, the
    kernel legs' (N = 6), the ALM warm config and the obstacle tracks of
    legs (c) and (d)."""
    st, cfg, w, x0, sc = build_problem(torch.float32, batch, MAX_ITER, device)
    _, cfg_k, w_k, x0_k, sc_k = build_problem(torch.float32, batch, MAX_ITER, device,
                                              horizon=KERNEL_N)
    cfg_e = dataclasses.replace(cfg_k, solve_type="alm", use_last_solution=True)
    obs_full = torch.as_tensor(st.obs_preds_array(np.float32), device=device)

    def obs(ticks):
        return obs_full[:, :ticks + cfg_e.N + 1].expand(batch, -1, -1, -1)

    return dict(a=(cfg, w, x0, sc), b=(cfg_k, w_k, x0_k, sc_k),
                c=(cfg_e, w_k, x0_k, sc_k, obs(EPISODE_TICKS)),
                d=(cfg_e, w_k, x0_k, sc_k, obs(CHUNKED_TICKS)))


def _mesh(n_devices: int, dev: torch.device):
    if dev.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return make_mesh(n_devices, devices=cards)
    return make_mesh(n_devices, devices=[dev])


def _episode_rows(sc, obs_b):
    return (sc.ref_line, sc.ref_velo, obs_b, sc.road_borders)


def dryrun_multichip(n_devices: int, device="cuda", on_leg=None) -> dict:
    """The four legs over an ``n_devices`` mesh (module docstring); asserts
    what the JAX dry run asserts and prints a line a leg. Returns {"a": (u,
    x, stats, summary), "b": (u, x, stats, summary), "c": (ego, u_hist,
    stats), "d": (ego, u_hist, stats)}, this process's rows in order on the
    mesh's first device. ``on_leg(name)``, when given, is called as each
    leg ends, the card synchronized."""
    dev = entry_device(device)
    mesh = _mesh(n_devices, dev)
    local = ROWS_PER_DEVICE * mesh.size
    P = _problems(local * mesh.world_size, dev)
    rows = slice(mesh.rank * local, (mesh.rank + 1) * local)

    def shards(tree):
        tree = tree_map(lambda a: a[rows], tree)
        return shard_batch(mesh, tree) if mesh.group is None else shard_batch_multihost(mesh, tree)

    def say(leg, text):
        if dev.type == "cuda":
            for card in mesh.devices:
                torch.cuda.synchronize(card)
        if on_leg is not None:
            on_leg(leg)
        print(f"dryrun_multichip({n_devices}): {text}", flush=True)

    out = {}
    cfg, w, x0, sc = P["a"]
    u, x, stats, summary = sharded_solve_fn(mesh, cfg)(replicate(mesh, w), shards(x0),
                                                       shards(sc))
    assert u.shape == (local, cfg.N, 2)
    assert bool(torch.isfinite(summary["mean_cost"]))
    out["a"] = (u, x, stats, summary)
    say("a", f"OK -- batch {local} sharded over {mesh.size} devices, "
        f"mean_iters={float(summary['mean_iters']):.2f}")

    cfg_k, w_k, x0_k, sc_k = P["b"]
    fn = sharded_kernel_solve_fn(mesh, cfg_k, window=WINDOW, straggler_cap=STRAGGLER_CAP)
    u, x, stats, summary = fn(replicate(mesh, w_k), shards(x0_k), shards(sc_k))
    assert u.shape == (local, cfg_k.N, 2)
    assert bool(torch.isfinite(summary["mean_cost"]))
    out["b"] = (u, x, stats, summary)
    say("b", f"kernel path OK -- the fused kernel sharded over {mesh.size} devices "
        f"({dev.type}), mean_iters={float(summary['mean_iters']):.2f}")

    cfg_e, w_k, x0_k, sc_k, obs_b = P["c"]
    ws = replicate(mesh, w_k)
    parts = [shards(t) for t in (x0_k, *_episode_rows(sc_k, obs_b))]
    episodes = [run_mpc_kernel_scan(cfg_e, ws[i], *(p[i] for p in parts), EPISODE_TICKS,
                                    window=WINDOW) for i in range(mesh.size)]
    first = mesh.devices[0]
    ego, us, stats = tree_map(lambda *xs: torch.cat([x.to(first) for x in xs], 1), *episodes)
    assert ego.shape == (EPISODE_TICKS + 1, local, 4)
    out["c"] = (ego, us, stats)
    say("c", f"episode-scan path OK -- {EPISODE_TICKS}-tick ALM warm-start MPC episodes, "
        f"one program a shard, sharded over {mesh.size} devices")

    cfg_e, w_k, x0_k, sc_k, obs_c = P["d"]
    ego, us, stats = run_mpc_chunked_sharded(
        mesh, cfg_e, replicate(mesh, w_k), *(shards(t) for t in (x0_k, *_episode_rows(
            sc_k, obs_c))), ticks=CHUNKED_TICKS, chunk=CHUNK, window=WINDOW,
        straggler_cap=STRAGGLER_CAP)
    assert ego.shape == (CHUNKED_TICKS + 1, local, 4)
    assert us.shape == (CHUNKED_TICKS, local, cfg_e.N, 2)
    assert bool(torch.isfinite(ego).all())
    out["d"] = (ego, us, stats)
    say("d", f"chunked episode path OK -- {CHUNKED_TICKS}-tick episodes as "
        f"{CHUNKED_TICKS // CHUNK} chunks of {CHUNK} ticks, carries on the device, "
        f"sharded over {mesh.size} devices")
    return out


def single_device_legs(batch: int, device="cuda") -> dict:
    """The dry run's legs over ``batch`` rows on one device with no mesh:
    ``solve_batch``, ``cilqr_solve_cuda``, ``run_mpc_kernel_scan`` and
    ``run_mpc_kernel_chunked``; the outputs of :func:`dryrun_multichip`
    without the summaries."""
    P = _problems(batch, entry_device(device))
    cfg, w, x0, sc = P["a"]
    out = {"a": solve_batch(cfg, w, x0, sc)[:3]}
    cfg_k, w_k, x0_k, sc_k = P["b"]
    out["b"] = cilqr_solve_cuda(cfg_k, w_k, x0_k, sc_k, window=WINDOW,
                                straggler_cap=STRAGGLER_CAP)
    cfg_e, w_k, x0_k, sc_k, obs_b = P["c"]
    out["c"] = run_mpc_kernel_scan(cfg_e, w_k, x0_k, *_episode_rows(sc_k, obs_b),
                                   EPISODE_TICKS, window=WINDOW)
    cfg_e, w_k, x0_k, sc_k, obs_c = P["d"]
    out["d"] = run_mpc_kernel_chunked(cfg_e, w_k, x0_k, *_episode_rows(sc_k, obs_c),
                                      CHUNKED_TICKS, chunk=CHUNK, window=WINDOW,
                                      straggler_cap=STRAGGLER_CAP)
    return out


def leg_tensors(leg) -> list:
    """The tensors of one leg's outputs (u/ego, x/u_hist and every stats
    field), summaries left out, in a fixed order."""
    first, second, stats = leg[:3]
    return [first, second, *(getattr(stats, f.name) for f in dataclasses.fields(stats))]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="single-device entry and multi-device "
                                     "dry run of the batched CILQR solver")
    parser.add_argument("--devices", type=int, default=None,
                        help="mesh size (default: every card; 4 copies of the CPU)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on the card (default; raises without one) or the CPU")
    args = parser.parse_args(argv)
    dev = entry_device(args.device)
    fn, ex = entry(dev)
    u, _, iters, converged = fn(*ex)
    print(f"entry(): OK {tuple(u.shape)}, mean_iters={float(iters.double().mean()):.2f}, "
          f"converged {int(converged.sum())}/{u.shape[0]}", flush=True)
    n = args.devices
    if n is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 4
    dryrun_multichip(n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
