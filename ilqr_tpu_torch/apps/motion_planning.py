"""Closed-loop motion-planning app (CLI), headless.

Counterpart of ``ilqr_tpu/apps/motion_planning.py`` and of the reference
executable ``motion_planning -c <yaml>`` (src/motion_planning.cpp:29-276):
load a scenario config, build lane geometry + agent routings and run the
receding-horizon CILQR loop on the eager solver. Rendering is not ported
yet, so ``--no-viz`` is required.

Usage:
    python -m ilqr_tpu_torch.apps.motion_planning -c configs/scenario_two_straight.yaml \
        --no-viz [--ticks N] [--noise] [--seed S] [--f32] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np

log = logging.getLogger("ilqr_tpu_torch.motion_planning")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="CILQR motion planning demo (PyTorch)")
    parser.add_argument("-c", "--config", required=True, help="scenario yaml path")
    parser.add_argument("--ticks", type=int, default=None,
                        help="simulation ticks (default: max_simulation_time/dt)")
    parser.add_argument("--noise", action="store_true",
                        help="enable agent position noise (reference behavior)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-viz", action="store_true", help="run headless, no rendering")
    parser.add_argument("--f32", action="store_true", help="solve in float32")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; raises without a GPU)")
    args = parser.parse_args(argv)
    if not args.no_viz:
        raise NotImplementedError("rendering is not ported yet; pass --no-viz")

    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")

    import torch

    from ilqr_tpu_torch.config import GlobalConfig
    from ilqr_tpu_torch.sim.mpc import run_mpc
    from ilqr_tpu_torch.sim.scenario import build_scenario_setup
    from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, entry_device

    device = entry_device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64
    log.info("config path: %s", args.config)
    gc = GlobalConfig.from_file(args.config)
    setup = build_scenario_setup(gc, noise=args.noise, seed=args.seed)
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=dtype, device=device)

    def on_tick(t, u, x, stats):
        log.info("tick %3d: iters=%3d status=%d converged=%s cost=%.3f",
                 t, int(stats.iters), int(stats.status), bool(stats.converged),
                 float(stats.final_cost))

    t0 = time.perf_counter()
    history = run_mpc(cfg, w, setup, ticks=args.ticks, on_tick=on_tick)
    log.info("episode done: %d ticks in %.2f s", len(history["u"]),
             time.perf_counter() - t0)
    ego = history["ego"]
    log.info("ego travelled %.1f m, final v=%.2f m/s",
             float(np.hypot(ego[-1, 0] - ego[0, 0], ego[-1, 1] - ego[0, 1])),
             float(ego[-1, 2]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
