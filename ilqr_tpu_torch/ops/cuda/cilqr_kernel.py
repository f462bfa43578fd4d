"""Fused CILQR solve on an NVIDIA Hopper GPU: host side.

Counterpart of ``ilqr_tpu/ops/pallas/cilqr_kernel.py`` (the TPU kernel
``kernel`` built by ``_build_kernel`` and launched by ``call_kernel``). The
kernel itself is CUDA C++ in ``ilqr_tpu_torch/csrc/cilqr_kernel.cu``: one
thread runs one scenario's whole solve (initial rollout and projection, up
to ``max_iter`` iterations of cost derivatives, Riccati backward pass and
serial line search, the lambda/status machine).

This module holds what the JAX package did outside its kernel, in plain
torch:

- the per-scenario window gather around the initial nearest index
  (``pack_problem``). ``start = max(argmin - w_back, 0)`` is not clamped to
  ``P - W``; indices clamp to ``P - 1``, so the tail repeats the last
  sample and first-min ties pin the initial projection at row <= w_back;
- the obstacle pad to 1e6 when there are no obstacles;
- the x0 packing ``[x, y, v, yaw, rb_hi, rb_lo, ref_velo, 0]``;
- the per-step search bounds ``row_limits[k] = min(W, round_up_8(w_back +
  slack + k * rows))``. The round-up to 8 was a TPU sublane artifact; it is
  kept because it decides which window rows are searched.

Packed layout (every array scenario-fastest, ``[row][B]``, as the Pallas
host packed its lanes): x0 (8, B), uinit (2, N, B), rx/ry/ryaw (W, B),
ox/oy/oyaw (M, N+1, B); outputs u (2, N, B), x (4, N+1, B) and stats
(6, B) = [iters, status, converged, lamb_overflow, final_cost, final_lamb].

``cilqr_solve_ref`` is the plain version: the eager solver of
``solvers/cilqr.py`` on the same packed inputs, with the window-restricted
first-min projection. ``cilqr_solve_cuda`` takes it for CPU tensors only;
for a CUDA tensor it launches the kernel or raises.

The kernel is built at first use with nvcc into ``ilqr_tpu_torch/_build/``
(a shared library with a plain C interface, loaded with ctypes), under a
file name keyed by a hash of the source and flags.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ilqr_tpu_torch.solvers.cilqr import alpha_schedule, solve_from_controls
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, Scenario, SolveStats

W_BACK = 64  # window rows behind the ego's initial projection
# Extra window rows above the per-step search bound (the JAX package's
# shipped value, ilqr_tpu/ops/pallas/cilqr_kernel.py:1235).
_PROJ_SLACK = 16
MAX_STEPS = 32  # the kernel's horizon bound: N + 1 <= MAX_STEPS

# Kernel launches by ``cilqr_solve_kernel`` in this process.
launches = 0

_PKG = Path(__file__).resolve().parents[2]
_SOURCE = _PKG / "csrc" / "cilqr_kernel.cu"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Order of the weights the kernel reads (struct Weights in the .cu source).
_WEIGHT_ORDER = (
    "dt", "wheelbase", "width", "length", "d_safe", "velo_max", "velo_min",
    "acc_max", "acc_min", "stl_lim", "w_pos", "w_vel", "w_yaw", "w_acc", "w_stl",
    "state_exp_q1", "state_exp_q2", "obstacle_exp_q1", "obstacle_exp_q2",
    "init_lamb", "lamb_decay", "lamb_amplify", "max_lamb",
    "convergence_threshold", "accept_step_threshold", "exp_clip",
)


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
    rx: torch.Tensor  # (W, B)
    ry: torch.Tensor
    ryaw: torch.Tensor
    ox: torch.Tensor  # (M, N+1, B)
    oy: torch.Tensor
    oyaw: torch.Tensor
    row_limits: tuple  # N+1 ints


def pack_problem(cfg: CILQRConfig, x0_b, scenario_b: Scenario, window: int,
                 u_init=None, w_back: int = W_BACK,
                 proj_rows_per_step: int = 0) -> PackedProblem:
    """Window gather, obstacle pad and packing, in the dtype and on the
    device of ``x0_b`` (B, 4)."""
    dtype, dev = x0_b.dtype, x0_b.device
    B, N, W = x0_b.shape[0], cfg.N, window
    ref = scenario_b.ref_line.to(dtype)  # (B, P, 4)
    P = ref.shape[1]
    d2 = (ref[:, :, 0] - x0_b[:, None, 0]) ** 2 + (ref[:, :, 1] - x0_b[:, None, 1]) ** 2
    start = torch.clamp_min(torch.argmin(d2, dim=1) - w_back, 0)
    gidx = torch.clamp_max(start[:, None] + torch.arange(W, device=dev), P - 1)
    win = torch.gather(ref, 1, gidx[:, :, None].expand(-1, -1, 4))  # (B, W, 4)
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

    def lanes(a):
        return a.permute(*range(1, a.dim()), 0).contiguous()

    return PackedProblem(
        x0=x0_in.contiguous(), uinit=uinit,
        rx=lanes(win[..., 0]), ry=lanes(win[..., 1]), ryaw=lanes(win[..., 2]),
        ox=lanes(obs[..., 0]), oy=lanes(obs[..., 1]), oyaw=lanes(obs[..., 2]),
        row_limits=row_limits(N, W, w_back, proj_rows_per_step))


def cilqr_solve_ref(cfg: CILQRConfig, w: CILQRWeights, p: PackedProblem):
    """Plain version of the kernel: same packed inputs, same outputs, any
    dtype on any device (the eager solver with the windowed projection)."""
    B, N, M = p.x0.shape[1], cfg.N, cfg.num_obstacles
    win = torch.stack([p.rx, p.ry, p.ryaw, torch.zeros_like(p.rx)], dim=-1)  # (W,B,4)
    obs = torch.stack([p.ox, p.oy, p.oyaw], dim=-1)[:M]  # (M, N+1, B, 3)
    scenario = Scenario(
        ref_line=win.permute(1, 0, 2),
        ref_velo=p.x0[6],
        obs_preds=obs.permute(2, 0, 1, 3),
        road_borders=p.x0[4:6].T,
    )
    limits = torch.tensor(p.row_limits, device=p.x0.device)
    u, x, st, _, _ = solve_from_controls(cfg, w, p.x0[:4].T, p.uinit.permute(2, 1, 0),
                                         scenario, row_limits=limits)
    stats = torch.stack([st.iters.to(u.dtype), st.status.to(u.dtype),
                         st.converged.to(u.dtype), st.lamb_overflow.to(u.dtype),
                         st.final_cost, st.final_lamb])
    return u.permute(2, 1, 0).contiguous(), x.permute(2, 1, 0).contiguous(), stats


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


@functools.cache
def load_library():
    """Build the kernel library (once per source hash) and load it.

    Returns (ctypes library, the nvcc log of its build). Raises with nvcc's
    output when the build fails.
    """
    key = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = _BUILD_DIR / f"libcilqr_{key.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("cilqr_solve_f32", "cilqr_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 13 + [ci] * 6 + [vp]
        fn.restype = ci
    return lib, log_path.read_text() if log_path.exists() else ""


def cilqr_solve_kernel(cfg: CILQRConfig, w: CILQRWeights, p: PackedProblem):
    """Launch the CUDA kernel on packed CUDA tensors; returns (u, x, stats)
    packed like ``cilqr_solve_ref``. Raises on anything the kernel lacks."""
    global launches
    if cfg.reference_point != "rear_center" or cfg.solve_type != "barrier":
        raise NotImplementedError(
            "the CUDA kernel runs barrier constraints with the rear-center bicycle only; "
            f"got solve_type={cfg.solve_type!r}, reference_point={cfg.reference_point!r}")
    dtype, dev = p.x0.dtype, p.x0.device
    if dev.type != "cuda":
        raise ValueError(f"cilqr_solve_kernel needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}")
    N, B, W = cfg.N, p.x0.shape[1], p.rx.shape[0]
    M = p.ox.shape[0]
    if N + 1 > MAX_STEPS:
        raise ValueError(f"N={N} exceeds the kernel's horizon bound {MAX_STEPS - 1}")
    shapes = {"x0": (8, B), "uinit": (2, N, B), "rx": (W, B), "ry": (W, B),
              "ryaw": (W, B), "ox": (M, N + 1, B), "oy": (M, N + 1, B),
              "oyaw": (M, N + 1, B)}
    for name, shape in shapes.items():
        t = getattr(p, name)
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if len(p.row_limits) != N + 1 or not all(0 < r <= W for r in p.row_limits):
        raise ValueError(f"row_limits must be N+1 values in [1, {W}]")
    lib, _ = load_library()
    u = torch.empty((2, N, B), dtype=dtype, device=dev)
    x = torch.empty((4, N + 1, B), dtype=dtype, device=dev)
    stats = torch.empty((6, B), dtype=dtype, device=dev)
    scalar = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    wvals = torch.stack([getattr(w, f) for f in _WEIGHT_ORDER]).to(dtype).tolist()
    wts = (scalar * len(wvals))(*wvals)
    lims = (ctypes.c_int * (N + 1))(*p.row_limits)
    fn = lib.cilqr_solve_f32 if dtype == torch.float32 else lib.cilqr_solve_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(wts), ctypes.addressof(lims),
                 *(t.data_ptr() for t in (p.x0, p.uinit, p.rx, p.ry, p.ryaw,
                                          p.ox, p.oy, p.oyaw, u, x, stats)),
                 B, N, M, W, cfg.max_iter, len(alpha_schedule(cfg.min_alpha)), stream)
    if err != 0:
        raise RuntimeError(f"cilqr_solve kernel launch failed: cudaError_t {err}")
    launches += 1
    return u, x, stats


def cilqr_solve_cuda(cfg: CILQRConfig, w: CILQRWeights, x0_b, scenario_b: Scenario,
                     window: int = 512, u_init=None, proj_rows_per_step: int = 0,
                     w_back: int = W_BACK):
    """Batched CILQR solve through the fused kernel.

    x0_b (B, 4); scenario_b: batched ``Scenario``; u_init (B, N, 2) warm-start
    controls or None (zeros). Returns (u (B, N, 2), x (B, N+1, 4),
    SolveStats). CUDA tensors launch the kernel; CPU tensors run the plain
    version ``cilqr_solve_ref``.
    """
    p = pack_problem(cfg, x0_b, scenario_b, window, u_init, w_back, proj_rows_per_step)
    if x0_b.device.type == "cuda":
        u, x, stats = cilqr_solve_kernel(cfg, w, p)
    elif x0_b.device.type == "cpu":
        u, x, stats = cilqr_solve_ref(cfg, w, p)
    else:
        raise ValueError(f"unsupported device {x0_b.device}")
    return u.permute(2, 1, 0), x.permute(2, 1, 0), SolveStats(
        iters=stats[0].to(torch.int32),
        status=stats[1].to(torch.int32),
        converged=stats[2] > 0.5,
        lamb_overflow=stats[3] > 0.5,
        final_cost=stats[4],
        final_lamb=stats[5],
    )
