"""Linear LQR closed-loop demo (CLI; capability of reference demo 0).

Counterpart of ``ilqr_tpu/apps/lqr_demo.py``: solves the DARE for the
reference's unstable 3-state system, prints P* and K*, and plots open-
against closed-loop responses (scripts/0-lqr-demo.py). Runs on the GPU
unless ``--device cpu``; plotting needs matplotlib.

Usage: python -m ilqr_tpu_torch.apps.lqr_demo [--save out.png] [--no-viz] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="closed-loop LQR demo")
    parser.add_argument("--save", default=None)
    parser.add_argument("--no-viz", action="store_true")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; raises without a GPU)")
    args = parser.parse_args(argv)

    import torch

    from ilqr_tpu_torch.solvers.lqr import lqr_demo
    from ilqr_tpu_torch.types import entry_device

    device = entry_device(args.device)

    def t(a):
        return torch.tensor(a, dtype=torch.float64, device=device)

    # the reference's system (scripts/0-lqr-demo.py:24-27)
    A = t([[1.95, -0.025, -1.6], [1.6, 1.1, -3.2], [0.425, 0.185, 0.3]])
    B = t([[0.0, 1.0], [1.0, 1.0], [0.0, 1.0]])
    P, K, ol, cl = lqr_demo(A, B, t(np.eye(3)), t(np.eye(2)), t([1.0, 2.0, 3.0]),
                            steps=args.steps)
    print(f"Pstar =\n{P.cpu().numpy()}")
    print(f"Kstar =\n{K.cpu().numpy()}")

    if args.no_viz:
        return 0
    import matplotlib
    if args.save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = np.arange(args.steps)
    for title, roll in (("Open Loop", ol), ("Closed Loop", cl)):
        x, u_norm = roll.x.cpu().numpy(), roll.u_norm.cpu().numpy()
        fig, ax = plt.subplots(2, 2)
        for i in range(3):
            ax[i // 2, i % 2].plot(steps, x[:, i])
            ax[i // 2, i % 2].set_xlabel("t")
            ax[i // 2, i % 2].set_ylabel(f"x_{i + 1}")
        ax[1, 1].plot(steps, u_norm)
        ax[1, 1].set_xlabel("t")
        ax[1, 1].set_ylabel("||u||")
        fig.suptitle(title)
        fig.subplots_adjust(wspace=0.4, hspace=0.4)
        if args.save:
            fig.savefig(args.save.replace(".", f"_{title.split()[0].lower()}.", 1))
    if not args.save:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
