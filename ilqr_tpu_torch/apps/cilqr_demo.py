"""Demo-2 CILQR motion-planning CLI (one-shot solve + animation replay).

Counterpart of ``ilqr_tpu/apps/cilqr_demo.py``, the equivalent of running
the reference's pedagogical planner ``python
scripts/2-cilqr-motionplanning.py`` (:453-503): build the shipped demo
scenario (a straight 1000-point reference line, two constant-velocity
obstacles), solve it once with the demo solver's semantics
(``ilqr_tpu_torch.solvers.cilqr_demo``), then replay the solved trajectory
frame by frame and finish with the every-second-step footprint plot. Runs
on the GPU unless ``--device cpu``; the replay needs matplotlib.

Usage:
    python -m ilqr_tpu_torch.apps.cilqr_demo [--save out.gif] [--no-viz] [--f32]
        [--max-iter 50] [--batch B] [--device cpu]

``--batch B`` solves B copies of the demo problem in one batched call,
their starts moved in x and y by 0.5 m times standard normals drawn from a
``torch.Generator`` seeded with 0, and replays the first. The JAX app draws
its offsets from ``jax.random``, so the two batches differ.
"""

from __future__ import annotations

import argparse
import logging
import sys

log = logging.getLogger("ilqr_tpu_torch.cilqr_demo")

DEMO_LENGTH = 4.5  # vehicle footprint (reference scripts/utils/kinematic.py)
DEMO_WIDTH = 2.0


def batch_starts(x0, batch: int):
    """``batch`` copies of x0 (4,) with x and y moved by 0.5 N(0, 1) each,
    drawn on the host from a ``torch.Generator`` seeded with 0."""
    import torch

    gen = torch.Generator().manual_seed(0)
    dx = 0.5 * torch.randn((batch, 2), generator=gen, dtype=torch.float64)
    starts = x0.expand(batch, 4).clone()
    starts[:, :2] += dx.to(x0.device, x0.dtype)
    return starts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="pedagogical CILQR planner (demo-2 semantics)")
    parser.add_argument("--max-iter", type=int, default=50)
    parser.add_argument("--batch", type=int, default=0,
                        help="solve B perturbed copies in one batched call")
    parser.add_argument("--save", default=None, help="save animation (gif/mp4)")
    parser.add_argument("--no-viz", action="store_true")
    parser.add_argument("--f32", action="store_true", help="solve in float32")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; raises without a GPU)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")

    import torch

    from ilqr_tpu_torch.solvers import cilqr_demo as demo
    from ilqr_tpu_torch.types import entry_device
    from ilqr_tpu_torch.utils.timing import TicToc

    device = entry_device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64
    p, x0, ref, ref_velo, obs_attrs, obs_preds = demo.demo_scenario(dtype, device)

    timer = TicToc()
    if args.batch:
        res = demo.solve(p, batch_starts(x0, args.batch), ref, ref_velo,
                         obs_attrs, obs_preds, args.max_iter)
        converged, iters = res.converged.double().mean().item(), res.iters.double().mean().item()
        log.info("batch of %d demo solves in %.2f s; converged %.1f%%, mean iters %.1f",
                 args.batch, timer.toc(), 100 * converged, iters)
        u, x = res.u[0].cpu().numpy(), res.x[0].cpu().numpy()
    else:
        res = demo.solve(p, x0, ref, ref_velo, obs_attrs, obs_preds, args.max_iter)
        u, x = res.u.cpu().numpy(), res.x.cpu().numpy()
        # the reference prints the solve's wall time (:470-477)
        log.info("----CILQR Solution Time: %.3f seconds----", timer.toc())
        log.info("iters=%d converged=%s J=%.4f", int(res.iters), bool(res.converged),
                 float(res.J))

    if not args.no_viz:
        from ilqr_tpu_torch.viz.render import animate_demo_replay

        animate_demo_replay(u, x, obs_preds.cpu().numpy(), length=DEMO_LENGTH,
                            width=DEMO_WIDTH, acc_max=float(p.acc_max), out_path=args.save,
                            show=args.save is None)
        if args.save:
            log.info("animation saved to %s", args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
