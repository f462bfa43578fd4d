"""Runners, one per kind of traffic mix (a traffic file's ``kind``):

- ``mpc_episodes``: closed-loop receding-horizon episodes of a batch of
  starts through the port's CUDA-graph episodes (``sim/mpc.py:run_mpc_kernel_chunked``);
- ``cold_sweep``: steps of cold solves of a batch of starts through the
  parallel layer (``parallel/sharding.py:sharded_kernel_solve_fn``).

Shared here: what a configuration and a traffic mix fix for both kinds.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference.cilqr import Params, proj_rows, row_limits
from benchmarks.reference.judge import Setting
from benchmarks.scenario import build_scene, starts

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Base:
    """The inputs of a cell, rounded once to the configuration's type, and
    the program's configuration and weights built from the same file."""

    def __init__(self, cell, device):
        self.cell, self.tr = cell, cell.traffic
        self.device = torch.device(device)
        self.sc = cell.config["scenario"]
        self.precision = cell.config["precision"]
        self.dtype = DTYPES[self.precision]
        self.scene = build_scene(self.sc)
        self.params = Params.of(self.sc)
        self.N, self.B = self.params.N, int(self.tr["batch"])
        self.W, self.w_back = int(self.tr["window"]), int(self.tr["w_back"])
        self.rows = proj_rows(self.params.v_ref, self.params.dt)
        self.line = torch.tensor(self.scene.line, dtype=self.dtype)
        self.obs = torch.tensor(self.scene.obs, dtype=self.dtype)
        self.road = torch.tensor(self.scene.road_borders, dtype=self.dtype)
        self.ref_velo = torch.tensor(self.scene.ref_velo, dtype=self.dtype)
        self.attempted = 0

    def set_seed(self, seed: int) -> None:
        """The run's pool of distinct batches of starts."""
        self.seed = int(seed)
        self.pool = [torch.tensor(starts(self.scene.ego_x0, self.B, self.seed, j),
                                  dtype=self.dtype) for j in range(int(self.tr["pool"]))]

    def rng(self, *key):
        return np.random.default_rng([self.seed % 2**64, *key])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def program(self, warm: bool, device=None):
        """The port's (config, weights on ``device``, the run's by default)
        of the configuration's scenario."""
        import dataclasses

        from ilqr_tpu_torch.config import GlobalConfig
        from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

        gc = GlobalConfig.from_dict(self.sc)
        cfg = dataclasses.replace(CILQRConfig.from_global_config(gc), use_last_solution=warm)
        return cfg, CILQRWeights.from_global_config(gc, dtype=self.dtype,
                                                   device=device or self.device)

    def setting(self) -> Setting:
        return Setting(self.line, self.W, self.w_back, self.rows)

    def solve_shape(self, iters: float) -> dict:
        """A solve of the batch, for the roofline's floor."""
        return dict(B=self.B, N=self.N, M=self.obs.shape[0], W=self.W,
                    limits=row_limits(self.N, self.W, self.w_back, self.rows),
                    gravity=self.params.gravity, dtype=self.precision, iters=iters)
