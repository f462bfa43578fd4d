"""The Pallas repro kernels of ``tools/debug/`` on an NVIDIA Hopper GPU.

Each TPU repro isolated one piece of the straggler-resume dataflow of the
CILQR kernel; here they are small CUDA kernels
(``ilqr_tpu_torch/csrc/debug_repros.cu``), each with its plain PyTorch
version beside it, as regression checks of the same dataflow on the card:

- K2 ``resume_echo`` (``tools/debug/min_resume_repro.py:18``): echoes a
  tenth input block (8, Bp); the first 8 rows of the eight others (x0,
  uinit, the window x3, the obstacles x3) are read and multiplied by 0.
  The repro's weights block is not read by its kernel, and is not taken.
- K3 ``dataflow`` (``tools/debug/min_dataflow_repro.py:25``, ``:33``):
  ``k1`` writes u (64, Bp) = [2x + 1; 0] and s = 3x - 5, a stable sort of
  the columns by ``done`` permutes both, ``k2`` adds s + u[0:8], and the
  inverse permutation restores the column order.
- K4 ``carry`` (``tools/debug/min_carry_repro.py:16``): rows 0..5 of a
  resume block as the carries of a 2-trip loop that adds zeros; out =
  those rows, then 2 zero rows. K5 ``zerotrip``
  (``tools/debug/min_zerotrip_repro.py:14``): the same loop with 0 trips.

Shapes are the repros' with one group (G = 1; the card has no lane
interleave): Bp = 2048 columns, W = 384 window rows, M = 3 obstacles, 32
horizon rows, float32, column-fastest ([row][Bp]). ``repro_inputs`` makes
each repro's inputs from numpy's generator with seed 0, as the repros do.

Each wrapper runs its plain version for CPU tensors; for CUDA tensors it
launches its kernel (counted in ``launches`` under its own name) or raises.
The library is built with nvcc at first use into ``ilqr_tpu_torch/_build/``,
as ``cilqr_kernel.load_library`` builds the solve.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ilqr_tpu_torch.ops.cuda.cilqr_kernel import build_library

BP, W, M, NH = 2048, 384, 3, 32  # the repros' columns, window, obstacles, horizon rows

# Kernel launches in this process by kernel name; only the wrappers add to
# them, once per launch.
launches: collections.Counter = collections.Counter()

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "debug_repros.cu"


@functools.cache
def load_library():
    """Build the repro kernels' library (once per source hash) and load it.
    Returns (ctypes library, the nvcc log of its build)."""
    lib, log = build_library(_SOURCE, "libdebug_repros")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, args in (("min_resume_echo", [vp] * 10 + [ci]),
                       ("min_dataflow_k1", [vp] * 3 + [ci]),
                       ("min_dataflow_k2", [vp] * 3 + [ci]),
                       ("min_carry", [vp] * 3 + [ci, ci])):
        fn = getattr(lib, name)
        fn.argtypes = args + [vp]
        fn.restype = ci
    return lib, log


def repro_inputs(device="cpu") -> dict:
    """Each repro's inputs, made as the repro makes them (numpy, seed 0),
    at G = 1: ``resume`` the nine blocks (x0, uinit, rx, ry, ryaw, ox, oy,
    oyaw, res), ``dataflow`` (x, done), ``carry`` (x0, res)."""
    def normal(rng, rows):
        return torch.as_tensor(rng.normal(size=(rows, BP)), dtype=torch.float32, device=device)

    rng = np.random.default_rng(0)
    resume = [normal(rng, r) for r in (8, 2 * NH, W, W, W, M * NH, M * NH, M * NH, 8)]
    rng = np.random.default_rng(0)
    x = normal(rng, 8)
    done = torch.as_tensor(rng.integers(0, 2, size=(BP,)), dtype=torch.int32, device=device)
    rng = np.random.default_rng(0)
    carry_in = [normal(rng, 8), normal(rng, 8)]
    return {"resume": resume, "dataflow": (x, done), "carry": carry_in}


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for contiguous float32 CUDA tensors on one device, False for
    CPU tensors; raises on anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"expected contiguous 2-d float32, got {t.dtype} {tuple(t.shape)}")
    return True


def _launch(name: str, kernel: str, out: torch.Tensor, *args) -> None:
    fn = getattr(load_library()[0], kernel)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launches[name] += 1


def _columns(*ts: torch.Tensor, rows: int) -> int:
    Bp = ts[0].shape[1]
    for t in ts:
        if t.dim() != 2 or t.shape[1] != Bp or t.shape[0] < rows:
            raise ValueError(f"expected ({rows}+, {Bp}) blocks, got {tuple(t.shape)}")
    return Bp


def resume_echo_ref(x0, uinit, rx, ry, ryaw, ox, oy, oyaw, res):
    """Plain K2: res + 0 x0 + ... + 0 oyaw over the first 8 rows."""
    out = res[:8]
    for t in (x0, uinit, rx, ry, ryaw, ox, oy, oyaw):
        out = out + 0.0 * t[:8]
    return out


def resume_echo(x0, uinit, rx, ry, ryaw, ox, oy, oyaw, res):
    """K2 (8, Bp): the echo of ``res`` through a launch that reads every
    other block."""
    ins = (x0, uinit, rx, ry, ryaw, ox, oy, oyaw, res)
    Bp = _columns(*ins, rows=8)
    if not _on_cuda(*ins):
        return resume_echo_ref(*ins)
    out = torch.empty((8, Bp), dtype=torch.float32, device=res.device)
    _launch("min_resume_echo", "min_resume_echo", out, *ins, out, Bp)
    return out


def dataflow_k1_ref(x):
    """Plain K3 ``k1``: (u (64, Bp) = [2x + 1; 0], s = 3x - 5)."""
    u = torch.cat([2.0 * x + 1.0, x.new_zeros((2 * NH - 8, x.shape[1]))])
    return u, 3.0 * x - 5.0


def dataflow_k1(x):
    """K3 ``k1`` on x (8, Bp)."""
    Bp = _columns(x, rows=8)
    if not _on_cuda(x):
        return dataflow_k1_ref(x)
    u = torch.empty((2 * NH, Bp), dtype=torch.float32, device=x.device)
    s = torch.empty((8, Bp), dtype=torch.float32, device=x.device)
    _launch("min_dataflow_k1", "min_dataflow_k1", u, x, u, s, Bp)
    return u, s


def dataflow_k2_ref(u, s):
    """Plain K3 ``k2``: s + u[0:8]."""
    return s + u[:8]


def dataflow_k2(u, s):
    """K3 ``k2`` on u (64, Bp) and s (8, Bp)."""
    Bp = _columns(u, s, rows=8)
    if not _on_cuda(u, s):
        return dataflow_k2_ref(u, s)
    out = torch.empty((8, Bp), dtype=torch.float32, device=s.device)
    _launch("min_dataflow_k2", "min_dataflow_k2", out, u, s, out, Bp)
    return out


def dataflow(x, done):
    """K3's whole flow: ``k1``, a stable column sort by ``done``, ``k2``,
    and the inverse permutation. Returns (out, u1, s1)."""
    u1, s1 = dataflow_k1(x)
    perm = torch.argsort(done, stable=True)
    out = dataflow_k2(u1.index_select(1, perm), s1.index_select(1, perm))
    return out.index_select(1, torch.argsort(perm)), u1, s1


def carry_ref(x0, res, trips: int):
    """Plain K4 / K5: rows 0..5 of res plus ``trips`` times 0 x0[0], then
    2 zero rows."""
    lane0 = x0[0:1] * 0.0
    rows = [res[k:k + 1] for k in range(6)]
    for _ in range(trips):
        rows = [r + lane0 for r in rows]
    return torch.cat(rows + [res.new_zeros((2, res.shape[1]))])


def _carry(name: str, x0, res, trips: int):
    Bp = _columns(x0, res, rows=8)
    if not _on_cuda(x0, res):
        return carry_ref(x0, res, trips)
    out = torch.empty((8, Bp), dtype=torch.float32, device=res.device)
    _launch(name, "min_carry", out, x0, res, out, Bp, trips)
    return out


def carry(x0, res):
    """K4: the 2-trip carry loop."""
    return _carry("min_carry", x0, res, 2)


def zerotrip(x0, res):
    """K5: the same loop with 0 trips."""
    return _carry("min_zerotrip", x0, res, 0)
