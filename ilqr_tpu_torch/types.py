"""Core parameter / state containers for the CILQR solver (PyTorch port).

Counterpart of ``ilqr_tpu/types.py``. The JAX package keeps solver state in
flax pytrees and batches with ``vmap``; here every container is a plain
dataclass of tensors with an explicit leading batch axis where the state is
per scenario:

- ``CILQRConfig``: static hyperparameters (shapes, modes), hashable;
- ``CILQRWeights``: solver scalars as 0-d tensors of the working dtype, so
  ``x * w.dt`` is an op in that dtype on that device. Any of them may
  instead be a (B,) tensor, one value per scenario row (the JAX package's
  ``vmap`` over a batch of weights): the eager path reads each weight
  through ``per_row`` and ``stack_last``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ilqr_tpu_torch.config import GlobalConfig


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch floating dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def entry_device(device) -> torch.device:
    """The device an entry point runs on: the given one, with a clear error
    instead of a silent CPU run when it names CUDA and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def per_row(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A weight as a factor of a tensor of ``ndim`` dimensions whose leading
    axis is the scenario batch: a 0-d weight unchanged, a (B,) weight viewed
    as (B, 1, ..., 1)."""
    return t if t.dim() == 0 else t.reshape(t.shape[:1] + (1,) * (ndim - 1))


def stack_last(ts):
    """Scalars and (B,) tensors stacked on a new last axis: (K,) when all
    are 0-d, else (B, K)."""
    lead = torch.broadcast_shapes(*(t.shape for t in ts))
    return torch.stack([t.expand(lead) for t in ts], dim=-1)


class SolveStatus:
    """Reference enum LQRSolveStatus (include/cilqr_solver.hpp:23-29)."""

    RUNNING = 0
    CONVERGED = 1
    BACKWARD_PASS_FAIL = 2
    FORWARD_PASS_FAIL = 3
    FORWARD_PASS_SMALL_STEP = 4


@dataclasses.dataclass(frozen=True)
class CILQRConfig:
    """Static solver hyperparameters (field-for-field ``ilqr_tpu.types.CILQRConfig``)."""

    N: int = 30
    nx: int = 4
    nu: int = 2
    num_obstacles: int = 0
    solve_type: str = "barrier"  # "barrier" | "alm"
    reference_point: str = "gravity_center"  # | "rear_center"
    use_last_solution: bool = False
    max_iter: int = 100
    # line search: alpha = 1, 0.5, ... while alpha > min_alpha
    # (reference src/cilqr_solver.cpp:354) -> at most 20 trials
    min_alpha: float = 1e-6
    # only "exact" (global first-min argmin) is ported
    projection: str = "exact"
    # breadth of the line search in the JAX package; results do not depend
    # on it, and the port always walks the alphas serially
    line_search_width: int = 4
    # only "scan" (the sequential Riccati recursion) is ported
    riccati_impl: str = "scan"

    @property
    def num_constraints(self) -> int:
        return 8 + 2 * self.num_obstacles

    @classmethod
    def from_global_config(cls, gc: GlobalConfig, num_obstacles: int | None = None,
                           **overrides: Any) -> "CILQRConfig":
        kw = dict(
            N=int(gc["lqr/N"]),
            nx=int(gc["lqr/nx"]),
            nu=int(gc["lqr/nu"]),
            num_obstacles=(gc.num_obstacles if num_obstacles is None else num_obstacles),
            solve_type=gc.solve_type,
            reference_point=gc["vehicle/reference_point"],
            use_last_solution=bool(gc["lqr/use_last_solution"]),
            max_iter=int(gc["iteration/max_iter"]),
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_dict(cls, d: dict) -> "CILQRConfig":
        """From a field dict, e.g. ``dataclasses.asdict`` of the JAX config."""
        return cls(**d)


# yaml key of every weight (reference ctor, src/cilqr_solver.cpp:17-83)
_WEIGHT_KEYS = {
    "dt": "delta_t",
    "w_pos": "lqr/w_pos",
    "w_vel": "lqr/w_vel",
    "w_yaw": "lqr/w_yaw",
    "w_acc": "lqr/w_acc",
    "w_stl": "lqr/w_stl",
    "obstacle_exp_q1": "lqr/obstacle_exp_q1",
    "obstacle_exp_q2": "lqr/obstacle_exp_q2",
    "state_exp_q1": "lqr/state_exp_q1",
    "state_exp_q2": "lqr/state_exp_q2",
    "alm_rho_init": "lqr/alm_rho_init",
    "alm_gamma": "lqr/alm_gamma",
    "max_rho": "lqr/max_rho",
    "max_mu": "lqr/max_mu",
    "init_lamb": "iteration/init_lamb",
    "lamb_decay": "iteration/lamb_decay",
    "lamb_amplify": "iteration/lamb_amplify",
    "max_lamb": "iteration/max_lamb",
    "convergence_threshold": "iteration/convergence_threshold",
    "accept_step_threshold": "iteration/accept_step_threshold",
    "wheelbase": "vehicle/wheelbase",
    "width": "vehicle/width",
    "length": "vehicle/length",
    "velo_max": "vehicle/velo_max",
    "velo_min": "vehicle/velo_min",
    "yaw_lim": "vehicle/yaw_lim",
    "acc_max": "vehicle/acc_max",
    "acc_min": "vehicle/acc_min",
    "stl_lim": "vehicle/stl_lim",
    "d_safe": "vehicle/d_safe",
}


@dataclasses.dataclass
class CILQRWeights:
    """Solver scalars, each a 0-d tensor or a (B,) tensor of per-row values
    (field-for-field ``ilqr_tpu.types.CILQRWeights``)."""

    dt: torch.Tensor
    w_pos: torch.Tensor
    w_vel: torch.Tensor
    w_yaw: torch.Tensor
    w_acc: torch.Tensor
    w_stl: torch.Tensor
    obstacle_exp_q1: torch.Tensor
    obstacle_exp_q2: torch.Tensor
    state_exp_q1: torch.Tensor
    state_exp_q2: torch.Tensor
    alm_rho_init: torch.Tensor
    alm_gamma: torch.Tensor
    max_rho: torch.Tensor
    max_mu: torch.Tensor
    init_lamb: torch.Tensor
    lamb_decay: torch.Tensor
    lamb_amplify: torch.Tensor
    max_lamb: torch.Tensor
    convergence_threshold: torch.Tensor
    accept_step_threshold: torch.Tensor
    wheelbase: torch.Tensor
    width: torch.Tensor
    length: torch.Tensor
    velo_max: torch.Tensor
    velo_min: torch.Tensor
    yaw_lim: torch.Tensor
    acc_max: torch.Tensor
    acc_min: torch.Tensor
    stl_lim: torch.Tensor
    d_safe: torch.Tensor
    # float32 overflow guard for q1*exp(q2*c); inactive at float64
    exp_clip: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.dt.dtype

    @property
    def row_shapes(self) -> set:
        """The shapes of the fields: {()} when every weight is a scalar."""
        return {tuple(getattr(self, f.name).shape) for f in dataclasses.fields(self)}

    @property
    def state_weight_diag(self) -> torch.Tensor:
        """(4,), or (B, 4) when a state weight is per row."""
        return stack_last([self.w_pos, self.w_pos, self.w_vel, self.w_yaw])

    @property
    def ctrl_weight_diag(self) -> torch.Tensor:
        """(2,), or (B, 2) when a control weight is per row."""
        return stack_last([self.w_acc, self.w_stl])

    @classmethod
    def from_numpy(cls, d: dict, dtype=torch.float32, device="cpu") -> "CILQRWeights":
        """From ``{field: np.ndarray}`` (0-d, or (B,) for per-row weights);
        ``exp_clip`` defaults per dtype."""
        from ilqr_tpu_torch.ops.constraints import default_exp_clip

        def t(a):
            a = np.asarray(a)
            return torch.tensor(float(a) if a.ndim == 0 else a, dtype=dtype, device=device)

        kw = {f.name: t(d[f.name]) for f in dataclasses.fields(cls) if f.name in d}
        kw.setdefault("exp_clip", torch.tensor(default_exp_clip(dtype), dtype=dtype,
                                               device=device))
        return cls(**kw)

    @classmethod
    def from_global_config(cls, gc: GlobalConfig, dtype=torch.float32, device="cpu",
                           **overrides: Any) -> "CILQRWeights":
        d = {name: gc[key] for name, key in _WEIGHT_KEYS.items()}
        d.update(overrides)
        return cls.from_numpy(d, dtype=dtype, device=device)


@dataclasses.dataclass
class Scenario:
    """Batched scenario data, leading axis B.

    ref_line: (B, P, 4) [x, y, yaw, s] dense lane line; ref_velo: (B,)
    target speed; obs_preds: (B, M, N+1, 3) obstacle prediction window;
    road_borders: (B, 2) [upper, lower] lateral border offsets (reference
    src/motion_planning.cpp:101-103).
    """

    ref_line: torch.Tensor
    ref_velo: torch.Tensor
    obs_preds: torch.Tensor
    road_borders: torch.Tensor


@dataclasses.dataclass
class CILQRCarry:
    """Cross-solve MPC state per scenario: warm start + ALM duals
    (reference src/cilqr_solver.cpp:88-102, 144)."""

    last_u: torch.Tensor  # (B, N, 2)
    is_first: torch.Tensor  # (B,) bool
    alm_rho: torch.Tensor  # (B,)
    alm_mu: torch.Tensor  # (B, N, 8 + 2*M)

    @classmethod
    def init(cls, cfg: CILQRConfig, w: CILQRWeights, batch: int) -> "CILQRCarry":
        kw = dict(dtype=w.dtype, device=w.dt.device)
        return cls(
            last_u=torch.zeros((batch, cfg.N, cfg.nu), **kw),
            is_first=torch.ones((batch,), dtype=torch.bool, device=w.dt.device),
            alm_rho=w.alm_rho_init.expand(batch).clone(),
            alm_mu=torch.zeros((batch, cfg.N, cfg.num_constraints), **kw),
        )


@dataclasses.dataclass
class SolveStats:
    """Per-solve telemetry, one entry per scenario."""

    iters: Any  # int32: iterations executed
    status: Any  # int32: final LQRSolveStatus
    converged: Any  # bool
    lamb_overflow: Any  # bool: lambda > max_lamb exit
    final_cost: Any  # J of the returned trajectory
    final_lamb: Any
