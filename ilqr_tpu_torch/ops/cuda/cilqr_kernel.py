"""Fused CILQR solve on an NVIDIA Hopper GPU: host side.

Counterpart of ``ilqr_tpu/ops/pallas/cilqr_kernel.py`` (the TPU kernel
``kernel`` built by ``_build_kernel`` and launched by ``call_kernel``). The
kernel itself is CUDA C++ in ``ilqr_tpu_torch/csrc/cilqr_kernel.cu``: one
warp runs one scenario's whole solve (initial rollout and projection, up
to ``max_iter`` iterations of cost derivatives, Riccati backward pass and
line search, the lambda/status machine, and in ALM mode the dual
update), lane k owning horizon step k, a block of one warp a scenario,
the solve's state in the block's dynamic shared memory. ``launch_plan``
computes the launch shape and that memory on the host. The kernel is
instantiated per scalar type (float32, float64), bicycle reference point
(rear center, gravity center) and penalty family (barrier, ALM); the
projection mode and the line search's chunk width are runtime arguments.
``variant`` names what a solve runs.

The modes (``Modes`` of ``ops/projection.py``, carried by ``PackedProblem``
so the kernel, its plain version and a resumed phase read the same
settings) are the JAX kernel's:

- ``proj_dot``: score window rows with the dot form ``(p_cr + p_nx x') +
  p_ny y'`` in coordinates centred on each scenario's window row 0, the
  three window terms computed once per solve (``dot_terms``), instead of
  the squared distance; same argmin in exact arithmetic, other rounding;
- ``proj_fold``: reduce the scores with the pair-fold tournament instead
  of the first minimum; other tie-breaking;
- ``ls_chunk``: roll the line search's trials out ``ls_chunk`` alphas at a
  time; bitwise the serial line search.

``resolve_modes`` fills the ones not given the way ``cilqr_solve_pallas``
does (ilqr_tpu/ops/pallas/cilqr_kernel.py:1354-1383), from ``ILQR_PROJ_DOT``,
``ILQR_LS_CHUNK`` and ``ILQR_PROJ_FOLD``: on CUDA tensors the JAX package's
hardware defaults (dot form on, chunks of 4, fold off), on CPU tensors its
interpret-mode ones (all off), since the plain version plays interpret
mode's part.

Each scenario's reference-line window is the kernel's own work: it takes
the line whole -- (3, P) when the batch shares it, as
``ScenarioSetup.device_scenario`` expands it, else (3, P, B) -- and
derives the window from the scenario's start, the squared distance's
first minimum over all P rows (torch.argmin's, NaN first), ``start =
max(argmin - w_back, 0)`` not clamped to ``P - W``, row indices clamped to
``P - 1`` so the tail repeats the last sample and first-min ties pin the
initial projection at row <= w_back. ``window_rows`` is the same
derivation in plain torch, for the plain version and the thread kernel.

This module holds what the JAX package did outside its kernel, in plain
torch:

- the packing (``pack_problem``). An episode program packs what its ticks
  share once (``pack_episode``) and builds each tick's problem straight
  into the packed layout (``tick_problem``), bit for bit ``pack_problem``'s
  and without a host sync;
- the obstacle pad to 1e6 when there are no obstacles;
- the x0 packing ``[x, y, v, yaw, rb_hi, rb_lo, ref_velo, 0]``;
- the per-step search bounds ``row_limits[k] = min(W, round_up_8(w_back +
  slack + k * rows))``. The round-up to 8 was a TPU sublane artifact; it is
  kept because it decides which window rows are searched;
- in ALM mode, the dual state in and out: the (B, N, C0) carry layout of
  ``types.CILQRCarry`` (C0 = 8 + 2 * num_obstacles) to and from the
  kernel's (C, N, B), where C = 8 + 2 * M counts the padded obstacle of an
  obstacle-free config too (its columns stay inert and are dropped on the
  way out, as ilqr_tpu/ops/pallas/cilqr_kernel.py:1490-1510, :1664-1675
  drop them).

Packed layout (every array with a batch axis scenario-fastest,
``[row][B]``, as the Pallas host packed its lanes): x0 (8, B), uinit (2,
N, B), the line's x/y/yaw (3, P) or (3, P, B), ox/oy/oyaw (M, N+1, B), ALM
duals mu (C, N, B) and rho (B,); outputs u (2, N, B), x (4, N+1, B), stats
(6, B) = [iters, status, converged, lamb_overflow, final_cost, final_lamb]
and, in ALM mode, the final mu and rho in the input layout.

``cilqr_solve_ref`` is the plain version: the eager solver of
``solvers/cilqr.py`` on the same packed inputs, on the window
``window_rows`` derives, with the window-restricted first-min projection.
``cilqr_solve_cuda`` takes it for CPU tensors only; for a CUDA tensor it
launches the kernel or raises.

Straggler compaction (``solve_packed``, the host side of
ilqr_tpu/ops/pallas/cilqr_kernel.py:1596-1644): phase 1 runs every row up
to the first cap; each later phase gathers the rows still running into
dense arrays and resumes them where they stopped -- the kernel's resume
entry takes the stats slab of the phase before and the iteration ``it0``
it stopped at -- then scatters the results back. Exact: the resumed
rollout of the carried controls is the trajectory the solve had. What the
TPU needed and the card does not is left out: the lane interleave and the
pad to 128 lanes; only the stragglers are relaunched. That takes a host
sync per phase (their count), so a captured episode runs the JAX form
instead (``solve_packed_sorted``): every phase relaunches the whole batch,
sorted stragglers first, and rows that stopped pass through the resume
entry unchanged; bitwise the same result.

The weights (``host_weights``), the row-limit array and the launch plan
reach the host once, not per launch, so a launch makes no device-to-host
copy and a CUDA graph can capture it. Each solve notes its plan in
``utils/counters.py`` (``note_plan``: worked out on the host once a plan,
no device sync), and every launch adds its solves' phase clocks and
counts to K1's record there (``k1_record``: one int64 tensor a device,
allocated at the device's first launch and never again, so a captured
graph's launches add to the same tensor at every replay).
The kernel reads one set of weights a launch, as the Pallas kernel did:
per-row weights (the eager solver's ``solve_batch(weights_batched=True)``)
are refused with a ``ValueError`` (``check_scalar_weights``), by the plain
version too.

The kernel is built at first use with nvcc into ``ilqr_tpu_torch/_build/``
(a shared library with a plain C interface, loaded with ctypes), under a
file name keyed by a hash of the source and flags.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from ilqr_tpu_torch.models.bicycle import GRAVITY_CENTER, REAR_CENTER
from ilqr_tpu_torch.ops.projection import Modes
from ilqr_tpu_torch.solvers.cilqr import ResumeState, alpha_schedule, solve_from_controls
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, Scenario, SolveStats
from ilqr_tpu_torch.utils import counters

W_BACK = 64  # window rows behind the ego's initial projection
# Extra window rows above the per-step search bound (the JAX package's
# shipped value, ilqr_tpu/ops/pallas/cilqr_kernel.py:1235).
_PROJ_SLACK = 16
WARP = 32  # lanes of a warp: the lanes of one scenario
MAX_STEPS = WARP  # the kernel's horizon bound: N + 1 <= MAX_STEPS, a lane per step
MAX_LS_CHUNK = 8  # the widest line-search chunk (kMaxChunk in the .cu source)
MAX_SHARED_BYTES = 232448  # dynamic shared memory a block can use on the H100 (227 KB)
# Scalars of one warp's shared region per horizon step (`warp_floats` in the
# .cu source): the current trajectory (9), gains (10), cost derivatives
# (15), dynamics Jacobians (8); per chunk chain (6); per obstacle (4); and
# per searched window row, 2 (squared distance) or 3 (dot form).
_STEP_FIELDS = 9 + 10 + 15 + 8
_TRIAL_FIELDS = 6
_OBS_FIELDS = 4

# Kernel launches in this process, by instantiation and modes (``variant``;
# a launch of the resume entry counts under ``variant + "_resume"``); only
# ``cilqr_solve_kernel`` adds to them, once per launch.
launches: collections.Counter = collections.Counter()

_PKG = Path(__file__).resolve().parents[2]
_SOURCE = _PKG / "csrc" / "cilqr_kernel.cu"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The solve kernel rounds every product and sum on its own (no FMA
# contraction): the cost a trial was judged by and the cost the resume entry
# recomputes come from separately inlined copies of one function, which
# nvcc contracted differently (float64 ALM compaction was not bitwise).
KERNEL_FLAGS = NVCC_FLAGS + ("-fmad=false",)

# Order of the weights the kernel reads (struct Weights in the .cu source).
_WEIGHT_ORDER = (
    "dt", "wheelbase", "width", "length", "d_safe", "velo_max", "velo_min",
    "acc_max", "acc_min", "stl_lim", "w_pos", "w_vel", "w_yaw", "w_acc", "w_stl",
    "state_exp_q1", "state_exp_q2", "obstacle_exp_q1", "obstacle_exp_q2",
    "init_lamb", "lamb_decay", "lamb_amplify", "max_lamb",
    "convergence_threshold", "accept_step_threshold", "exp_clip",
    "alm_gamma", "max_rho", "max_mu",
)
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_CTYPES = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
# host copies of weights (``host_weights``), newest last, at most this many
_HOST_WEIGHTS_KEPT = 32
_host_weights: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_POINTS = {REAR_CENTER: "rear", GRAVITY_CENTER: "gravity"}
_PENALTIES = ("barrier", "alm")


_MODE_ENV = {"proj_dot": "ILQR_PROJ_DOT", "ls_chunk": "ILQR_LS_CHUNK",
             "proj_fold": "ILQR_PROJ_FOLD"}
# the defaults when neither the caller nor the environment sets a mode:
# the JAX package's on its chip, and in interpret mode for CPU tensors
_MODE_DEFAULTS = {"cuda": Modes(True, 4, False), "cpu": Modes()}


def check_modes(modes: Modes) -> None:
    """Raise unless ``modes`` is one the kernel runs."""
    for name in ("proj_dot", "proj_fold"):
        if getattr(modes, name) not in (False, True):
            raise ValueError(f"{name}={getattr(modes, name)!r}: expected a bool")
    chunk = modes.ls_chunk
    if isinstance(chunk, bool) or not isinstance(chunk, int) or not 0 <= chunk <= MAX_LS_CHUNK:
        raise ValueError(f"ls_chunk={chunk!r}: expected an int in [0, {MAX_LS_CHUNK}]")


def resolve_modes(device, proj_dot=None, ls_chunk=None, proj_fold=None,
                  env=None) -> Modes:
    """The modes of a solve on ``device``: each one given stands, each None
    comes from its ``ILQR_*`` variable in ``env`` (``os.environ`` when None)
    or else from the device's default (``_MODE_DEFAULTS``). Raises on an
    unknown value or a width outside [0, MAX_LS_CHUNK]."""
    env = os.environ if env is None else env
    kind = torch.device(device).type
    if kind not in _MODE_DEFAULTS:
        raise ValueError(f"unsupported device {device}")
    given = {"proj_dot": proj_dot, "ls_chunk": ls_chunk, "proj_fold": proj_fold}
    out = {}
    for name, value in given.items():
        if value is None and _MODE_ENV[name] in env:
            text = env[_MODE_ENV[name]]
            if name == "ls_chunk":
                try:
                    value = int(text)
                except ValueError:
                    raise ValueError(f"{_MODE_ENV[name]}={text!r}: expected an int") from None
            elif text in ("0", "1"):
                value = text == "1"
            else:
                raise ValueError(f"{_MODE_ENV[name]}={text!r}: expected 0 or 1")
        out[name] = getattr(_MODE_DEFAULTS[kind], name) if value is None else value
    modes = Modes(**out)
    check_modes(modes)
    return modes


def instantiation(cfg: CILQRConfig, dtype: torch.dtype, modes: Modes = Modes()) -> tuple:
    """(``"f32"`` or ``"f64"``, gravity center?, ALM?): the kernel
    instantiation that solves ``cfg`` in ``dtype``; raises on what the
    kernel lacks, ``modes`` included."""
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}")
    if cfg.reference_point not in _POINTS:
        raise ValueError(f"unknown reference_point {cfg.reference_point!r}")
    if cfg.solve_type not in _PENALTIES:
        raise ValueError(f"unknown solve_type {cfg.solve_type!r}")
    check_modes(modes)
    return _DTYPES[dtype], cfg.reference_point == GRAVITY_CENTER, cfg.solve_type == "alm"


def variant(cfg: CILQRConfig, dtype: torch.dtype, modes: Modes = Modes()) -> str:
    """Name of what solves ``cfg`` in ``dtype`` under ``modes``: the
    kernel instantiation, e.g. ``cilqr_solve_f32_gravity_alm``, and a
    suffix per mode on (``_dot``, ``_fold``, ``_ls``); raises on what the
    kernel lacks."""
    dt, gravity, alm = instantiation(cfg, dtype, modes)
    suffix = "".join(tag for tag, on in (("_dot", modes.proj_dot), ("_fold", modes.proj_fold),
                                         ("_ls", modes.ls_chunk > 0)) if on)
    return f"cilqr_solve_{dt}_{('rear', 'gravity')[gravity]}_{_PENALTIES[alm]}{suffix}"


def check_scalar_weights(w: CILQRWeights) -> None:
    """Raise unless every weight is 0-d: the kernel reads one set of weights
    a launch (struct Weights), as the Pallas kernel does, so per-row
    weights run on the eager solver only."""
    shapes = w.row_shapes
    if shapes != {()}:
        raise ValueError(f"the fused kernel takes one set of weights a launch (0-d tensors); "
                         f"got weight shapes {sorted(shapes)}: solve per-row weights with "
                         f"solvers.cilqr.solve_batch(weights_batched=True)")


def host_weights(w: CILQRWeights, dtype: torch.dtype):
    """The weights the kernel reads (``_WEIGHT_ORDER``, struct Weights in
    the .cu source) as a ctypes array of ``dtype``, and every field of
    ``w`` as a Python float (a dict).

    The values are copied to the host once per set of weight tensors,
    keyed by each tensor's identity and version (an in-place change bumps
    the version), and kept with a reference to the tensors, so a launch
    makes no device-to-host copy."""
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}")
    names = [f.name for f in dataclasses.fields(w)]
    tensors = tuple(getattr(w, name) for name in names)
    key = tuple((id(t), t._version) for t in tensors)
    entry = _host_weights.get(key)
    if entry is None:
        check_scalar_weights(w)
        values = dict(zip(names, torch.stack(tensors).tolist()))
        entry = (tensors, values, {})
        _host_weights[key] = entry
        while len(_host_weights) > _HOST_WEIGHTS_KEPT:
            _host_weights.popitem(last=False)
    _host_weights.move_to_end(key)
    _, values, arrays = entry
    if dtype not in arrays:
        kernel = torch.tensor([values[f] for f in _WEIGHT_ORDER], dtype=w.dtype).to(dtype)
        arrays[dtype] = (_CTYPES[dtype] * len(_WEIGHT_ORDER))(*kernel.tolist())
    return arrays[dtype], values


@functools.lru_cache(maxsize=64)
def _limits_array(limits: tuple):
    """The row limits as the ctypes int array the C entry reads."""
    return (ctypes.c_int * len(limits))(*limits)


def derive_proj_rows(target_velocity, dt, factor: float = 1.1) -> int:
    """Per-step projection search bound in window rows: the 0.1 m-spaced
    line advances ``factor * v * dt / 0.1`` rows per horizon step."""
    return int(math.ceil(factor * float(target_velocity) * float(dt) / 0.1))


def row_limits(N: int, W: int, w_back: int, proj_rows_per_step: int,
               slack: int = _PROJ_SLACK) -> tuple:
    """Rows searched at each step 0..N; 0 rows per step = the full window."""
    if proj_rows_per_step <= 0:
        return (W,) * (N + 1)
    return tuple(min(W, -(-(w_back + slack + k * proj_rows_per_step) // 8) * 8)
                 for k in range(N + 1))


@dataclasses.dataclass
class PackedProblem:
    """A batch of solves in the kernel's scenario-fastest layout."""

    x0: torch.Tensor  # (8, B)
    uinit: torch.Tensor  # (2, N, B)
    # the reference line's x, y, yaw: (3, P) when every row has the same
    # line, else (3, P, B); each row's window is derived from it
    line: torch.Tensor
    ox: torch.Tensor  # (M, N+1, B)
    oy: torch.Tensor
    oyaw: torch.Tensor
    row_limits: tuple  # N+1 ints
    window: int  # W, the window's rows
    w_back: int  # window rows behind the start's nearest line row
    # ALM duals in; None is the reference's cold reset (zero mu, rho_init),
    # src/cilqr_solver.cpp:88-93
    mu: Optional[torch.Tensor] = None  # (8 + 2M, N, B)
    rho: Optional[torch.Tensor] = None  # (B,)
    # resume state: the stats slab (6, B) of a solve stopped before
    # iteration it0 (rows neither converged nor overflowed), whose controls
    # and duals are uinit, mu and rho; None starts at iteration 0
    stats: Optional[torch.Tensor] = None
    it0: int = 0
    modes: Modes = Modes()


class PackedSolution(NamedTuple):
    """Outputs of the kernel and of its plain version, packed."""

    u: torch.Tensor  # (2, N, B)
    x: torch.Tensor  # (4, N+1, B)
    stats: torch.Tensor  # (6, B)
    mu: Optional[torch.Tensor]  # (8 + 2M, N, B) final duals; None in barrier mode
    rho: Optional[torch.Tensor]  # (B,)


def line_lanes(ref_line_b, dtype) -> torch.Tensor:
    """The x, y, yaw of ``ref_line_b`` (B, P, 4) in ``dtype``: (3, P) once
    when the batch shares the line (stride 0 over it, as
    ``ScenarioSetup.device_scenario`` expands it, or B = 1), else (3, P,
    B)."""
    if ref_line_b.shape[0] == 1 or ref_line_b.stride(0) == 0:
        return ref_line_b[0, :, :3].to(dtype).T.contiguous()
    return ref_line_b[..., :3].to(dtype).permute(2, 1, 0).contiguous()


def pack_problem(cfg: CILQRConfig, x0_b, scenario_b: Scenario, window: int,
                 u_init=None, w_back: int = W_BACK,
                 proj_rows_per_step: int = 0, alm_mu0=None,
                 alm_rho0=None, modes: Modes = Modes()) -> PackedProblem:
    """Obstacle pad and packing, in the dtype and on the device of ``x0_b``
    (B, 4); the line goes whole (``line_lanes``), each row's window is
    derived from it (``window_rows``). ``alm_mu0`` (B, N, C0) and
    ``alm_rho0`` (B,) seed the duals in ALM mode (ignored otherwise)."""
    dtype, dev = x0_b.dtype, x0_b.device
    B, N, W = x0_b.shape[0], cfg.N, window
    if cfg.num_obstacles == 0:
        obs = torch.full((B, 1, N + 1, 3), 1e6, dtype=dtype, device=dev)
    else:
        obs = scenario_b.obs_preds.to(dtype)  # (B, M, N+1, 3)
    rb = scenario_b.road_borders.to(dtype).expand(B, 2)
    rv = scenario_b.ref_velo.to(dtype).reshape(-1).expand(B)
    x0_in = torch.stack([x0_b[:, 0], x0_b[:, 1], x0_b[:, 2], x0_b[:, 3],
                         rb[:, 0], rb[:, 1], rv, torch.zeros_like(rv)])
    if u_init is None:
        uinit = torch.zeros((2, N, B), dtype=dtype, device=dev)
    else:
        uinit = u_init.to(dtype).permute(2, 1, 0).contiguous()
    mu = rho = None
    if cfg.solve_type == "alm":
        if alm_mu0 is not None:
            mu = torch.zeros((8 + 2 * obs.shape[1], N, B), dtype=dtype, device=dev)
            mu[:alm_mu0.shape[-1]] = alm_mu0.to(dtype).permute(2, 1, 0)
        if alm_rho0 is not None:
            rho = torch.as_tensor(alm_rho0, dtype=dtype, device=dev).expand(B).contiguous()

    def lanes(a):
        return a.permute(*range(1, a.dim()), 0).contiguous()

    return PackedProblem(
        x0=x0_in.contiguous(), uinit=uinit, line=line_lanes(scenario_b.ref_line, dtype),
        ox=lanes(obs[..., 0]), oy=lanes(obs[..., 1]), oyaw=lanes(obs[..., 2]),
        row_limits=row_limits(N, W, w_back, proj_rows_per_step), window=W, w_back=w_back,
        mu=mu, rho=rho, modes=modes)


@dataclasses.dataclass
class PackedEpisode:
    """What every tick of a batch of episodes shares, packed once in the
    kernel's layout (``pack_episode``); ``tick_problem`` builds a tick's
    ``PackedProblem`` from it."""

    x0_rest: torch.Tensor  # (4, B): x0 rows 4-7, road borders hi / lo, ref velocity, 0
    # the reference line's x, y, yaw: (3, P) when every row has the same
    # line, else (3, P, B)
    line: torch.Tensor
    # obstacle predictions per component (M, T, B), sliced N + 1 rows a
    # tick; with no obstacles the constant 1e6 pad, (1, N + 1, B)
    ox: torch.Tensor
    oy: torch.Tensor
    oyaw: torch.Tensor
    sliding: bool  # whether the obstacle rows slide with the tick
    steps: torch.Tensor  # (N + 1,) prediction row offsets 0..N
    window: int
    w_back: int
    row_limits: tuple
    modes: Modes


def pack_episode(cfg: CILQRConfig, x0_b, ref_line_b, ref_velo_b, obs_full_b, road_borders_b,
                 window: int, w_back: int = W_BACK, proj_rows_per_step: int = 0,
                 modes: Modes = Modes()) -> PackedEpisode:
    """The tick-invariant part of ``pack_problem`` for episodes from
    ``x0_b`` (B, 4) over ``ref_line_b`` (B, P, 4) and ``obs_full_b`` (B, M,
    T, 3), in the dtype and on the device of ``x0_b``: the x0 slab's rows
    4-7, the line's columns and the obstacles per component. A line
    expanded over the batch (stride 0, as ``ScenarioSetup.device_scenario``
    makes it) is kept once."""
    dtype, dev = x0_b.dtype, x0_b.device
    B, N = x0_b.shape[0], cfg.N
    rb = road_borders_b.to(dtype).expand(B, 2)
    rv = ref_velo_b.to(dtype).reshape(-1).expand(B)
    if cfg.num_obstacles == 0:
        obs = torch.full((3, 1, N + 1, B), 1e6, dtype=dtype, device=dev)
    else:
        obs = obs_full_b.to(dtype).expand(B, -1, -1, -1).permute(3, 1, 2, 0).contiguous()
    return PackedEpisode(
        x0_rest=torch.stack([rb[:, 0], rb[:, 1], rv, torch.zeros_like(rv)]),
        line=line_lanes(ref_line_b, dtype), ox=obs[0], oy=obs[1], oyaw=obs[2],
        sliding=cfg.num_obstacles > 0, steps=torch.arange(N + 1, device=dev),
        window=window, w_back=w_back,
        row_limits=row_limits(N, window, w_back, proj_rows_per_step), modes=modes)


def window_start(line, x0, w_back: int):
    """The line row of each row's window row 0, (B,) int64: ``w_back`` rows
    behind the first minimum of the squared distance from the start
    ``x0[0]``, ``x0[1]`` (rows of x0 (>= 2, B)) over the line's P rows
    (``line`` (3, P) or (3, P, B)), clamped at 0 and not at P - W; the
    kernel derives the same start. No host sync."""
    if line.dim() == 2:
        d2 = ((line[0][None] - x0[0][:, None]) ** 2
              + (line[1][None] - x0[1][:, None]) ** 2)  # (B, P)
        nearest = torch.argmin(d2, dim=1)
    else:
        d2 = (line[0] - x0[0]) ** 2 + (line[1] - x0[1]) ** 2  # (P, B)
        nearest = torch.argmin(d2, dim=0)
    return torch.clamp_min(nearest - w_back, 0)


def window_rows(p: PackedProblem):
    """Each row's reference-line window of ``p``, the (W, B) x, y and yaw
    the kernel searches: window row r is line row min(start + r, P - 1)
    (``window_start``), so the tail repeats the last sample. A shared line
    is indexed by a (W, B) index; per-row lines are gathered per row. No
    host sync."""
    line = p.line
    start = window_start(line, p.x0, p.w_back)
    rows = torch.arange(p.window, device=line.device)[:, None]
    idx = torch.clamp_max(start + rows, line.shape[1] - 1)  # (W, B)
    if line.dim() == 2:
        win = line[:, idx]
    else:
        win = torch.gather(line, 1, idx.expand(3, -1, -1))
    return win[0], win[1], win[2]


def tick_problem(ep: PackedEpisode, ego, t, uinit, mu=None, rho=None) -> PackedProblem:
    """The packed problem of the tick whose obstacle predictions start at
    row ``t`` (an int or a 0-d integer tensor), from ego states ``ego``
    (4, B), controls ``uinit`` (2, N, B) and, in ALM mode, duals ``mu``
    (8 + 2M, N, B) and ``rho`` (B,) (None: the cold reset). Equal to
    ``pack_problem`` of the same tick bit for bit; makes no host sync."""
    if ep.sliding:
        at = ep.steps + t
        ox, oy, oyaw = (a.index_select(1, at) for a in (ep.ox, ep.oy, ep.oyaw))
    else:
        ox, oy, oyaw = ep.ox, ep.oy, ep.oyaw
    return PackedProblem(x0=torch.cat([ego, ep.x0_rest]), uinit=uinit, line=ep.line, ox=ox,
                         oy=oy, oyaw=oyaw, row_limits=ep.row_limits, window=ep.window,
                         w_back=ep.w_back, mu=mu, rho=rho, modes=ep.modes)


def cilqr_solve_ref(cfg: CILQRConfig, w: CILQRWeights, p: PackedProblem,
                    work: Optional[dict] = None,
                    max_iter: Optional[int] = None) -> PackedSolution:
    """Plain version of the kernel: same packed inputs, same outputs, any
    dtype on any device (the eager solver with the windowed projection on
    ``window_rows``' window, in the problem's modes). Runs iterations
    [p.it0, max_iter) (``cfg.max_iter`` when None), from ``p.stats`` when
    given. ``work`` receives the solver's rollout, trial and dual-update
    counts (see ``solve_from_controls``). The kernel runs the sequential
    Riccati pass and its own windowed projection whatever
    ``cfg.riccati_impl`` and ``cfg.projection`` say, as the Pallas kernel
    does, and so does this."""
    check_scalar_weights(w)
    note_plan(cfg, p)
    cfg = dataclasses.replace(cfg, riccati_impl="scan", projection="exact")
    B, N, M = p.x0.shape[1], cfg.N, cfg.num_obstacles
    rx, ry, ryaw = window_rows(p)
    win = torch.stack([rx, ry, ryaw, torch.zeros_like(rx)], dim=-1)  # (W,B,4)
    obs = torch.stack([p.ox, p.oy, p.oyaw], dim=-1)[:M]  # (M, N+1, B, 3)
    scenario = Scenario(
        ref_line=win.permute(1, 0, 2),
        ref_velo=p.x0[6],
        obs_preds=obs.permute(2, 0, 1, 3),
        road_borders=p.x0[4:6].T,
    )
    limits = torch.tensor(p.row_limits, device=p.x0.device)
    C0 = cfg.num_constraints
    mu0 = None if p.mu is None else p.mu[:C0].permute(2, 1, 0)
    resume = None
    if p.stats is not None:  # iterations and statuses are stored as floats
        resume = ResumeState(p.it0, p.stats[0].round().to(torch.int32),
                             p.stats[1].round().to(torch.int32), p.stats[5],
                             p.stats[2] > 0.5, p.stats[3] > 0.5)
    check_modes(p.modes)
    u, x, st, rho, mu = solve_from_controls(cfg, w, p.x0[:4].T, p.uinit.permute(2, 1, 0),
                                            scenario, p.rho, mu0, row_limits=limits,
                                            work=work, max_iter=max_iter, resume=resume,
                                            modes=p.modes)
    stats = torch.stack([st.iters.to(u.dtype), st.status.to(u.dtype),
                         st.converged.to(u.dtype), st.lamb_overflow.to(u.dtype),
                         st.final_cost, st.final_lamb])
    mu_out = rho_out = None
    if cfg.solve_type == "alm":
        mu_out = u.new_zeros((8 + 2 * p.ox.shape[0], N, B))
        mu_out[:C0] = mu.permute(2, 1, 0)
        rho_out = rho
    return PackedSolution(u.permute(2, 1, 0).contiguous(), x.permute(2, 1, 0).contiguous(),
                          stats, mu_out, rho_out)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build_library(source: Path, stem: str, flags: tuple = NVCC_FLAGS):
    """Build ``source`` with nvcc and ``flags`` into a shared library in
    ``_build/`` (once per hash of the source and flags) and load it with
    ctypes.

    Returns (ctypes library, the nvcc log of its build). Raises with nvcc's
    output when the build fails.
    """
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    so = _BUILD_DIR / f"{stem}_{key.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log_path.read_text() if log_path.exists() else ""


@functools.cache
def load_library():
    """Build the kernel library (once per source hash) and load it.

    Returns (ctypes library, the nvcc log of its build)."""
    lib, log = build_library(_SOURCE, "libcilqr", KERNEL_FLAGS)
    return bind_kernel(lib), log


def bind_kernel(lib):
    """Declare the argument and result types of the kernel library's C
    entry points on ``lib``; returns it."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("cilqr_solve_f32", "cilqr_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 20 + [ci] * 16 + [vp]
        fn.restype = ci
    for name in ("cilqr_occupancy_f32", "cilqr_occupancy_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ci] * 3 + [vp]
        fn.restype = ci
    return lib


class LaunchPlan(NamedTuple):
    """How the kernel runs a batch: a block of one warp per scenario, lane k
    owning step k."""

    lanes: int  # lanes per scenario
    step_lane: tuple  # the lane that owns each step 0..N
    grid: int  # blocks, one a scenario
    block: int  # threads a block
    shared_bytes: int  # dynamic shared memory a block: one scenario's


def region_bytes(N: int, M: int, R: int, dtype: torch.dtype, modes: Modes) -> int:
    """Shared bytes of one scenario's solve (the .cu source's
    ``warp_bytes``): N horizon steps, M obstacle columns (padded to 1 when
    none), R window rows searched (the largest row limit), in ``dtype``
    under ``modes``; a multiple of 16."""
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}")
    chains = max(modes.ls_chunk, 1)
    floats = ((N + 1) * (_STEP_FIELDS + _TRIAL_FIELDS * chains + _OBS_FIELDS * M)
              + (3 if modes.proj_dot else 2) * R)
    size = torch.empty((), dtype=dtype).element_size()
    return -(-floats * size // 16) * 16


@functools.lru_cache(maxsize=64)
def launch_plan(B: int, N: int, M: int, R: int, dtype: torch.dtype,
                modes: Modes) -> LaunchPlan:
    """The launch of a batch of B solves: a block of one warp per scenario
    (lane k owns horizon step k, so N + 1 <= WARP), each block
    ``region_bytes`` of dynamic shared memory. Raises when the horizon
    exceeds a warp or the block's shared memory exceeds MAX_SHARED_BYTES.
    Computed once per shape."""
    check_modes(modes)
    if N + 1 > MAX_STEPS:
        raise ValueError(f"N={N} exceeds the kernel's horizon bound {MAX_STEPS - 1}")
    region = region_bytes(N, M, R, dtype, modes)
    if region > MAX_SHARED_BYTES:
        raise ValueError(f"{region} shared bytes exceed the block's "
                         f"{MAX_SHARED_BYTES} (window rows {R}, obstacles {M})")
    counters.counts["plans_built"] += 1
    return LaunchPlan(lanes=WARP, step_lane=tuple(range(N + 1)), grid=B, block=WARP,
                      shared_bytes=region)


def resident_scenarios(cfg: CILQRConfig, dtype: torch.dtype, plan: LaunchPlan) -> int:
    """Scenarios (blocks) of ``plan`` resident on one SM of the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): what registers and
    shared bytes allow."""
    _, gravity, alm = instantiation(cfg, dtype)
    lib = load_library()[0]
    fn = lib.cilqr_occupancy_f32 if dtype == torch.float32 else lib.cilqr_occupancy_f64
    blocks = ctypes.c_int(0)
    err = fn(int(gravity), int(alm), plan.shared_bytes, ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError_t {err}")
    return blocks.value


def note_plan(cfg: CILQRConfig, p: PackedProblem) -> None:
    """Record in ``counters.plan`` what K1 runs ``p`` with: the variant,
    M, the constraint columns 8 + 2M, the rows staged R, the shared bytes
    of one scenario (``region_bytes``) and, on a CUDA device,
    ``resident_scenarios`` of its ``launch_plan`` and the card's SMs (None
    elsewhere). Worked out once a plan: a solve whose plan is the one
    recorded only compares a key. No device sync."""
    dtype, device = p.x0.dtype, p.x0.device
    N, M, R = cfg.N, p.ox.shape[0], max(p.row_limits)
    name = variant(cfg, dtype, p.modes)
    key = (name, device, N, M, R)
    if counters.plan_is(key):
        return
    resident = sms = None
    if device.type == "cuda":
        with torch.cuda.device(device):
            resident = resident_scenarios(
                cfg, dtype, launch_plan(p.x0.shape[1], N, M, R, dtype, p.modes))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    counters.record_plan(key, variant=name, agents=M, columns=8 + 2 * M, rows=R,
                         shared_bytes=region_bytes(N, M, R, dtype, p.modes), resident=resident,
                         sms=sms)


def k1_record(device) -> torch.Tensor:
    """K1's record on ``device`` (``counters.k1_records``), the int64
    tensor of ``counters.K1_FIELDS`` every launch there adds to: allocated
    zeroed at the device's first launch, which a graph capture must not
    be, and kept for the life of the process."""
    device = torch.device(device)
    record = counters.k1_records.get(device)
    if record is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K1's record must exist before a graph captures a launch")
        record = torch.zeros(len(counters.K1_FIELDS), dtype=torch.int64, device=device)
        counters.k1_records[device] = record
    return record


def check_packed(cfg: CILQRConfig, p: PackedProblem) -> None:
    """Raise unless ``p`` is what the kernel takes: contiguous arrays of one
    floating dtype on one device (those of ``p.x0``) in the packed shapes
    (the line (3, P) or (3, P, B), P >= 1), N + 1 row limits in [1, W],
    w_back >= 0, N + 1 <= MAX_STEPS, duals (when given) of C = 8 + 2M
    columns, a resume slab (when given) of 6 rows and modes the kernel
    runs."""
    check_modes(p.modes)
    dtype, device = p.x0.dtype, p.x0.device
    N, B, W, M = cfg.N, p.x0.shape[1], p.window, p.ox.shape[0]
    if N + 1 > MAX_STEPS:
        raise ValueError(f"N={N} exceeds the kernel's horizon bound {MAX_STEPS - 1}")
    P = p.line.shape[1] if p.line.dim() > 1 else 0
    line = (3, P) if p.line.dim() == 2 else (3, P, B)
    if P < 1 or p.w_back < 0:
        raise ValueError(f"line: expected (3, P) or (3, P, B) with P >= 1 and w_back >= 0, "
                         f"got {tuple(p.line.shape)}, w_back={p.w_back}")
    shapes = {"x0": (8, B), "uinit": (2, N, B), "line": line, "ox": (M, N + 1, B),
              "oy": (M, N + 1, B), "oyaw": (M, N + 1, B), "mu": (8 + 2 * M, N, B),
              "rho": (B,), "stats": (6, B)}
    for name, shape in shapes.items():
        t = getattr(p, name)
        if t is None and name in ("mu", "rho", "stats"):
            continue
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if len(p.row_limits) != N + 1 or not all(0 < r <= W for r in p.row_limits):
        raise ValueError(f"row_limits must be N+1 values in [1, {W}]")
    if p.it0 < 0 or (p.stats is None and p.it0 != 0):
        raise ValueError(f"it0={p.it0}: a solve starts at 0 unless it resumes from stats")


class Launch(NamedTuple):
    """One solve's kernel arguments before the launch plan, and its outputs."""

    name: str  # ``variant`` (+ ``_resume``)
    args: tuple  # the C entry's arguments up to ``ls_chunk``: ``fields``' values
    keep: tuple  # host arrays the arguments point into
    out: PackedSolution
    fields: dict  # the arguments by the C entry's parameter names


def prepare_launch(cfg: CILQRConfig, w: CILQRWeights, p: PackedProblem,
                   max_iter: Optional[int] = None, window_out=None) -> Launch:
    """Check ``p`` and allocate the outputs (and the fold's scratch) of a
    solve of iterations [p.it0, max_iter) (``cfg.max_iter`` when None)
    on ``p``'s device; return the C entry's arguments. ``window_out``, a
    (1 + F R, B) tensor (F = 3 in the dot form, else 2; R the largest row
    limit) or None, receives each solve's window start and staged rows
    (tests). The launch adds to ``k1_record`` of ``p``'s device. Raises on
    anything the kernel lacks. Makes no device-to-host copy (the weights
    come from ``host_weights``), so a launch can be captured in a CUDA
    graph."""
    dtype, dev = p.x0.dtype, p.x0.device
    name = variant(cfg, dtype, p.modes) + ("" if p.stats is None else "_resume")
    _, gravity, alm = instantiation(cfg, dtype, p.modes)
    check_packed(cfg, p)
    N, B, M = cfg.N, p.x0.shape[1], p.ox.shape[0]
    mu_in = rho_in = mu = rho = None
    if alm:
        mu_in = (torch.zeros((8 + 2 * M, N, B), dtype=dtype, device=dev) if p.mu is None
                 else p.mu)
        rho_in = w.alm_rho_init.to(dtype).expand(B).contiguous() if p.rho is None else p.rho
        mu = torch.empty_like(mu_in)
        rho = torch.empty_like(rho_in)
    # the fold's scratch of ceil(R / 2) scores and row indices per step and
    # scenario
    fold_s = fold_i = None
    if p.modes.proj_fold:
        half = (max(p.row_limits) + 1) // 2
        fold_s = torch.empty((half, N + 1, B), dtype=dtype, device=dev)
        fold_i = torch.empty((half, N + 1, B), dtype=torch.int32, device=dev)
    u = torch.empty((2, N, B), dtype=dtype, device=dev)
    x = torch.empty((4, N + 1, B), dtype=dtype, device=dev)
    stats = torch.empty((6, B), dtype=dtype, device=dev)
    wts = host_weights(w, dtype)[0]
    lims = _limits_array(tuple(p.row_limits))

    def ptr(t):
        return None if t is None else t.data_ptr()

    if window_out is not None:
        rows = 1 + (3 if p.modes.proj_dot else 2) * max(p.row_limits)
        if (tuple(window_out.shape) != (rows, B) or window_out.dtype != dtype
                or window_out.device != dev or not window_out.is_contiguous()):
            raise ValueError(f"window_out: expected contiguous {(rows, B)} {dtype} on {dev}")
    fields = dict(
        wts=ctypes.addressof(wts), limits=ctypes.addressof(lims), x0=ptr(p.x0),
        uinit=ptr(p.uinit), line=ptr(p.line), ox=ptr(p.ox), oy=ptr(p.oy), oyaw=ptr(p.oyaw),
        mu_in=ptr(mu_in), rho_in=ptr(rho_in), stats_in=ptr(p.stats), u_out=ptr(u),
        x_out=ptr(x), stats_out=ptr(stats), mu_out=ptr(mu), rho_out=ptr(rho),
        fold_s=ptr(fold_s), fold_i=ptr(fold_i), window_out=ptr(window_out),
        totals=ptr(k1_record(dev)), B=B, N=N, M=M,
        W=p.window, P=p.line.shape[1], w_back=p.w_back, line_bs=int(p.line.dim() == 3),
        max_iter=cfg.max_iter if max_iter is None else max_iter, it0=p.it0,
        n_alphas=len(alpha_schedule(cfg.min_alpha)), gravity=int(gravity), alm=int(alm),
        proj_dot=int(p.modes.proj_dot), proj_fold=int(p.modes.proj_fold),
        ls_chunk=p.modes.ls_chunk)
    # the inputs and the scratch stay referenced until the launch is enqueued
    keep = (wts, lims, mu_in, rho_in, fold_s, fold_i)
    return Launch(name, tuple(fields.values()), keep, PackedSolution(u, x, stats, mu, rho),
                  fields)


def run_entry(fn, launch: Launch, device, *extra) -> None:
    """Call the C entry ``fn`` with ``launch``'s arguments, then ``extra``,
    on ``device``'s current stream; raises on a launch error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*launch.args, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{launch.name} kernel launch failed: cudaError_t {err}")


def cilqr_solve_kernel(cfg: CILQRConfig, w: CILQRWeights, p: PackedProblem,
                       max_iter: Optional[int] = None, window_out=None) -> PackedSolution:
    """Launch the CUDA kernel on packed CUDA tensors for iterations
    [p.it0, max_iter) (``cfg.max_iter`` when None), through its resume
    entry when ``p.stats`` is given, with ``launch_plan``'s shape; returns
    the solution packed like ``cilqr_solve_ref``'s. ``window_out`` as in
    ``prepare_launch``. Raises on anything the kernel lacks."""
    instantiation(cfg, p.x0.dtype, p.modes)  # raises on what no instantiation covers
    if p.x0.device.type != "cuda":
        raise ValueError(f"cilqr_solve_kernel needs CUDA tensors, got {p.x0.device}")
    launch = prepare_launch(cfg, w, p, max_iter, window_out)
    plan = launch_plan(p.x0.shape[1], cfg.N, p.ox.shape[0], max(p.row_limits), p.x0.dtype,
                       p.modes)
    note_plan(cfg, p)
    lib = load_library()[0]
    fn = lib.cilqr_solve_f32 if p.x0.dtype == torch.float32 else lib.cilqr_solve_f64
    run_entry(fn, launch, p.x0.device, plan.shared_bytes)
    launches[launch.name] += 1
    return launch.out


def straggler_schedule(straggler_cap, max_iter: int) -> tuple:
    """The iteration bound of each phase of a compacted solve: the caps
    (an int, or a strictly increasing tuple) that lie in (0, max_iter),
    then max_iter. 0 or () is one phase (ilqr_tpu/ops/pallas/
    cilqr_kernel.py:1596-1622)."""
    if isinstance(straggler_cap, (tuple, list)):
        caps = tuple(straggler_cap)
    else:
        caps = (straggler_cap,) if straggler_cap else ()
    caps = tuple(c for c in caps if 0 < c < max_iter)
    if any(a >= b for a, b in zip(caps, caps[1:])):
        raise ValueError(f"straggler_cap phases must be strictly increasing: {straggler_cap}")
    return caps + (max_iter,)


def stragglers(out: PackedSolution) -> torch.Tensor:
    """Indices, in order, of the rows of ``out`` that are neither converged
    nor overflowed: those a later phase resumes. Syncs with the device."""
    return ((out.stats[2] < 0.5) & (out.stats[3] < 0.5)).nonzero()[:, 0]


def resume_problem(p: PackedProblem, out: PackedSolution, rows: torch.Tensor,
                   it0: int) -> PackedProblem:
    """Rows ``rows`` of ``p`` as a dense problem that resumes at iteration
    ``it0`` from ``out``, the solution of the phase that stopped there:
    its controls, stats and (ALM) duals. What has no batch axis (a shared
    line) is kept as it is."""
    def take(t):
        return None if t is None else t.index_select(-1, rows)

    return dataclasses.replace(
        p, x0=take(p.x0), uinit=take(out.u), line=take(p.line) if p.line.dim() == 3 else p.line,
        ox=take(p.ox), oy=take(p.oy), oyaw=take(p.oyaw), mu=take(out.mu), rho=take(out.rho),
        stats=take(out.stats), it0=it0)


def _phase_solver(p: PackedProblem, solve=None, work: Optional[dict] = None):
    """``solve`` when given, else what solves a phase of ``p``: the kernel
    on CUDA tensors, the plain version on CPU tensors (``work`` as in
    ``cilqr_solve_ref``)."""
    if solve is not None:
        return solve
    if p.x0.device.type == "cuda":
        return cilqr_solve_kernel
    if p.x0.device.type == "cpu":
        return functools.partial(cilqr_solve_ref, work=work)
    raise ValueError(f"unsupported device {p.x0.device}")


def solve_packed(cfg: CILQRConfig, w: CILQRWeights, p: PackedProblem, straggler_cap=0,
                 work: Optional[dict] = None, solve=None) -> PackedSolution:
    """Solve a packed batch: the kernel on CUDA tensors (one launch per
    phase), the plain version on CPU tensors (``work`` as in
    ``cilqr_solve_ref``), with straggler compaction when ``straggler_cap``
    sets phases (``straggler_schedule``). Each later phase resumes only the
    rows the phase before left running and is skipped when there are none;
    the result equals a one-phase solve bit for bit. ``solve(cfg, w, p,
    max_iter=)`` replaces the phase's solver (a test's build of the
    kernel)."""
    solve = _phase_solver(p, solve, work)
    schedule = straggler_schedule(straggler_cap, cfg.max_iter)
    out = solve(cfg, w, p, max_iter=schedule[0])
    for it0, cap in zip(schedule, schedule[1:]):
        rows = stragglers(out)
        if rows.numel() == 0:
            break  # no row resumes, now or in a later phase
        part = solve(cfg, w, resume_problem(p, out, rows, it0), max_iter=cap)
        out = PackedSolution(*(None if full is None else full.index_copy(-1, rows, sub)
                               for full, sub in zip(out, part)))
    return out


def solve_packed_sorted(cfg: CILQRConfig, w: CILQRWeights, p: PackedProblem,
                        straggler_cap=0, solve=None) -> PackedSolution:
    """``solve_packed`` as the JAX package runs it inside one program
    (ilqr_tpu/ops/pallas/cilqr_kernel.py:1622-1641), with no host sync:
    after each phase a stable argsort of the done flags puts the rows
    still running first, the whole batch is permuted and relaunched
    through the resume entry (rows that stopped pass through it
    unchanged), and the inverse permutation restores the order at the
    end. Every phase runs, so a graph can capture it. Bitwise equal to
    ``solve_packed``. ``solve`` as there."""
    solve = _phase_solver(p, solve)
    schedule = straggler_schedule(straggler_cap, cfg.max_iter)
    out = solve(cfg, w, p, max_iter=schedule[0])
    if len(schedule) == 1:
        return out
    order = torch.arange(p.x0.shape[1], device=p.x0.device)
    for it0, cap in zip(schedule, schedule[1:]):
        done = ((out.stats[2] > 0.5) | (out.stats[3] > 0.5)).to(torch.int32)
        perm = torch.argsort(done, stable=True)  # stragglers first, order kept
        order = order[perm]
        p = resume_problem(p, out, perm, it0)
        out = solve(cfg, w, p, max_iter=cap)
    inv = torch.argsort(order)
    return PackedSolution(*(None if t is None else t.index_select(-1, inv) for t in out))


def unpack_stats(stats) -> SolveStats:
    """The ``SolveStats`` of stats slabs (..., 6, B) (iterations and
    statuses are stored as floats); cost and lambda are views."""
    iters, status, converged, overflow, cost, lamb = stats.unbind(-2)
    return SolveStats(iters=iters.round().to(torch.int32), status=status.round().to(torch.int32),
                      converged=converged > 0.5, lamb_overflow=overflow > 0.5,
                      final_cost=cost, final_lamb=lamb)


def cilqr_solve_cuda(cfg: CILQRConfig, w: CILQRWeights, x0_b, scenario_b: Scenario,
                     window: int = 512, u_init=None, proj_rows_per_step: int = 0,
                     w_back: int = W_BACK, alm_mu0=None, alm_rho0=None,
                     return_alm: bool = False, straggler_cap=0, proj_dot=None,
                     ls_chunk=None, proj_fold=None):
    """Batched CILQR solve through the fused kernel.

    x0_b (B, 4); scenario_b: batched ``Scenario``; u_init (B, N, 2) warm-start
    controls or None (zeros). Returns (u (B, N, 2), x (B, N+1, 4),
    SolveStats), plus the final duals (alm_mu (B, N, C0), alm_rho (B,)) when
    ``return_alm`` (ALM mode only). CUDA tensors launch the kernel; CPU
    tensors run the plain version ``cilqr_solve_ref``.

    ALM warm starts: ``alm_mu0`` (B, N, C0) / ``alm_rho0`` (B,) seed the dual
    state; None is the reference's cold reset, zero mu and rho_init
    (src/cilqr_solver.cpp:88-93). When to carry the previous solve's duals
    is the caller's policy, as in ``ilqr_tpu``'s ``cilqr_solve_pallas``.

    ``straggler_cap``: straggler compaction, as ``cilqr_solve_pallas``
    takes it -- an int or a strictly increasing tuple of iteration caps;
    caps outside (0, max_iter) are dropped, and 0 (the default) solves in
    one launch. Results are bitwise those of one launch
    (``solve_packed``).

    ``proj_dot``, ``ls_chunk``, ``proj_fold``: the modes (see the module
    docstring); None resolves as ``cilqr_solve_pallas`` resolves it
    (``resolve_modes``): on CUDA tensors the dot form with chunks of 4, on
    CPU tensors all off, unless ``ILQR_PROJ_DOT``, ``ILQR_LS_CHUNK`` or
    ``ILQR_PROJ_FOLD`` says otherwise. A mode the kernel lacks raises.
    """
    if return_alm and cfg.solve_type != "alm":
        raise ValueError("return_alm needs solve_type='alm'")
    modes = resolve_modes(x0_b.device, proj_dot, ls_chunk, proj_fold)
    p = pack_problem(cfg, x0_b, scenario_b, window, u_init, w_back, proj_rows_per_step,
                     alm_mu0, alm_rho0, modes)
    out = solve_packed(cfg, w, p, straggler_cap)
    result = (out.u.permute(2, 1, 0), out.x.permute(2, 1, 0), unpack_stats(out.stats))
    if not return_alm:
        return result
    return result + ((out.mu[:cfg.num_constraints].permute(2, 1, 0), out.rho),)
