"""Batched scenario sweep driver (the framework's "training job").

Counterpart of ``ilqr_tpu/apps/sweep.py``: runs thousands of perturbed
initial states of one scenario through the batched CILQR solver, cold,
sharded over the mesh's devices (``parallel.make_mesh``; every card of
this process, or under ``--multihost`` every rank's card), with the
convergence stats all-reduced, one log line a step, and an optional
checkpoint of the sweep cursor -- the equivalent of running the
reference binary thousands of times.

Usage:
    python -m ilqr_tpu_torch.apps.sweep -c configs/scenario_two_straight.yaml \\
        [--batch 8192] [--steps 4] [--engine kernel|eager|auto] \\
        [--checkpoint-dir DIR] [--multihost] [--device cuda|cpu] [--devices N]

Step ``s`` solves ``perturbed_initial_states(seed=1000 + s)``
(``step_starts``), float32. The last line of stdout is one JSON object: ``total_solves``,
``solves_per_sec`` (over the steps this run solved, each timed from the
call to the summary on the host), ``converged_frac``, ``mean_iters`` and
``devices`` (over every rank). The entry point runs on the card unless
``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import torch

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.ops.cuda.cilqr_kernel import derive_proj_rows
from ilqr_tpu_torch.parallel import make_mesh, shard_batch, sharded_solve_fn
from ilqr_tpu_torch.parallel.mesh import initialize_distributed
from ilqr_tpu_torch.parallel.sharding import replicate, sharded_kernel_solve_fn
from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, entry_device
from ilqr_tpu_torch.utils.checkpoint import restore_state, save_state

log = logging.getLogger("ilqr_tpu_torch.sweep")

# one launch a solve: on the H100, compaction lost to one launch at the
# sweep's shape (chip_smoke.py, the sweep phase's ABBA pairs)
DEFAULT_STRAGGLER_CAP = "0"
STEP_SEED = 1000  # step s solves the starts of seed STEP_SEED + s


def step_starts(ego_x0, batch: int, step: int):
    """(batch, 4) float64 numpy starts of sweep step ``step``, over every
    rank."""
    return perturbed_initial_states(ego_x0, batch, seed=STEP_SEED + step)


def parse_caps(text: str):
    """A straggler schedule from its flag: "8,16,32" a tuple, "24" one cap
    (0 is one launch)."""
    text = str(text)
    return tuple(int(c) for c in text.split(",") if c) if "," in text else int(text)


def main(argv=None, on_step=None) -> int:
    """Run the sweep. ``on_step(step, stats, summary, seconds)``, when given,
    is called after each step with its ``SolveStats`` (this rank's rows,
    on the mesh's first device), its summary dict and its wall seconds."""
    parser = argparse.ArgumentParser(description="batched CILQR scenario sweep")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--batch", type=int, default=8192,
                        help="scenarios per solver step, over every device")
    parser.add_argument("--steps", type=int, default=4,
                        help="number of batched solve steps")
    parser.add_argument("--engine", choices=("kernel", "eager", "auto"), default="auto",
                        help="kernel: the fused CUDA kernel (its plain version on the "
                        "CPU); eager: the eager PyTorch solver; auto: kernel on a card, "
                        "eager on the CPU")
    parser.add_argument("--window", type=int, default=384,
                        help="kernel engine: per-scenario refline window")
    parser.add_argument("--proj-rows", type=int, default=-1,
                        help="kernel engine: per-step projection search bound; -1 derives "
                        "1.1x the yaml's target velocity (cilqr_kernel.derive_proj_rows, "
                        "the bench default), 0 disables")
    parser.add_argument("--straggler-cap", default=DEFAULT_STRAGGLER_CAP,
                        help="kernel engine: straggler-compaction iteration cap or "
                        "comma-separated multi-phase schedule; results identical either "
                        "way. Default 0 (one launch), which beat 8,16,32 at batch 8192 "
                        "on the H100 (PERF.md)")
    parser.add_argument("--noise-seed", type=int, default=0,
                        help="unused, as in the JAX sweep: step s's starts are seeded "
                        "1000 + s")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="keep the sweep cursor there and resume from it (shared by "
                        "the ranks; rank 0 writes it)")
    parser.add_argument("--multihost", action="store_true",
                        help="call parallel.mesh.initialize_distributed() first (rank, "
                        "world size and rendezvous from the environment)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--devices", type=int, default=None,
                        help="mesh devices of this process: default every card, or one "
                        "CPU; on the CPU, that many copies of it")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")

    device = entry_device(args.device)
    if args.multihost:
        initialize_distributed(backend="nccl" if device.type == "cuda" else "gloo")
    engine = args.engine
    if engine == "auto":
        engine = "kernel" if device.type == "cuda" else "eager"

    gc = GlobalConfig.from_file(args.config)
    st = build_scenario_setup(gc)
    proj_rows = args.proj_rows
    if proj_rows < 0:
        proj_rows = derive_proj_rows(gc["vehicle/target_velocity"], gc["delta_t"])
    cfg = CILQRConfig.from_global_config(gc)
    dtype = torch.float32
    mesh = make_mesh(args.devices, None if device.type == "cuda"
                     else [device] * (args.devices or 1))
    n_dev = mesh.global_size
    B = args.batch - args.batch % n_dev or n_dev
    B_local = B // mesh.world_size
    rows = slice(mesh.rank * B_local, (mesh.rank + 1) * B_local)
    log.info("devices=%d engine=%s batch=%d steps=%d", n_dev, engine, B, args.steps)

    if engine == "kernel":
        solve_fn = sharded_kernel_solve_fn(mesh, cfg, window=args.window,
                                           straggler_cap=parse_caps(args.straggler_cap),
                                           proj_rows_per_step=proj_rows)
    else:
        solve_fn = sharded_solve_fn(mesh, cfg)
    w_d = replicate(mesh, CILQRWeights.from_global_config(gc, dtype=dtype))
    # the scenario is the same every step (the starts vary): placed once,
    # as views of one copy on the first device
    scen_d = shard_batch(mesh, st.device_scenario(tick=0, dtype=dtype, device=mesh.devices[0],
                                                  batch=B_local))

    start_step = 0
    cursor_path = None
    if args.checkpoint_dir:
        cursor_path = os.path.join(args.checkpoint_dir, "cursor")
        if os.path.exists(cursor_path):
            start_step = int(restore_state(cursor_path)["step"])
            log.info("resuming from step %d", start_step)

    totals = {"solves": 0, "converged": 0.0, "iters": 0.0, "wall": 0.0}
    for step in range(start_step, args.steps):
        x0 = step_starts(st.ego_x0, B, step)[rows]
        x0_d = shard_batch(mesh, torch.as_tensor(x0, dtype=dtype))
        t0 = time.perf_counter()
        _, _, stats, summary = solve_fn(w_d, x0_d, scen_d)
        # one copy to the host for the whole summary
        summary = dict(zip(summary, torch.stack(list(summary.values())).tolist()))
        dt = time.perf_counter() - t0
        totals["solves"] += B
        totals["converged"] += summary["converged"]
        totals["iters"] += summary["total_iters"]
        totals["wall"] += dt
        log.info(
            "step %d: %d solves in %.3f s (%.0f/s) converged %.1f%% mean_iters %.1f",
            step, B, dt, B / dt, 100 * summary["converged_frac"], summary["mean_iters"])
        if on_step is not None:
            on_step(step, stats, summary, dt)
        if cursor_path and mesh.rank == 0:
            save_state(cursor_path, {"step": step + 1})

    result = {
        "total_solves": totals["solves"],
        "solves_per_sec": totals["solves"] / max(totals["wall"], 1e-9),
        "converged_frac": totals["converged"] / max(totals["solves"], 1),
        "mean_iters": totals["iters"] / max(totals["solves"], 1),
        "devices": n_dev,
    }
    print(json.dumps(result))
    if args.multihost:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
