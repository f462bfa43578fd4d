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
launches its kernel (counted in ``launches`` under its own name) with
``launch_plan``'s shape, or raises. The library is built with nvcc at first
use into ``ilqr_tpu_torch/_build/``, as ``cilqr_kernel.load_library``
builds the solve. ``LIBRARY`` holds, per kernel, one PyTorch call that
computes the same function (``chip_smoke.py``'s yardstick; the port never
calls it), or None where there is none.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ilqr_tpu_torch.ops.cuda.cilqr_kernel import build_library

BP, W, M, NH = 2048, 384, 3, 32  # the repros' columns, window, obstacles, horizon rows

# Kernel launches in this process by kernel name; only the wrappers add to
# them, once per launch.
launches: collections.Counter = collections.Counter()

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "debug_repros.cu"

# Per C entry: the pointer arguments before Bp, the int arguments from Bp
# on (grid and block last), threads a block. Every kernel is a flat pass of
# one thread per float4 quad of an 8-row block, 2 Bp quads; small blocks
# spread them over many SMs. Each block is the best of 32, 64 and 128 on
# the H100 (chip_smoke.py phase 7); resume_echo takes at most 128.
_ENTRIES = {
    "min_resume_echo": (10, 3, 64),
    "min_dataflow_k1": (3, 3, 32),
    "min_dataflow_k2": (3, 3, 128),
    "min_carry": (3, 4, 128),
}


def launch_plan(kernel: str, Bp: int, block: int | None = None) -> tuple[int, int]:
    """(grid, block) of a launch of the C entry ``kernel`` over Bp columns:
    one thread per quad of an 8-row block (8 Bp is a multiple of 4), in
    blocks of ``block`` threads (the kernel's own by default)."""
    block = block or _ENTRIES[kernel][2]
    return -(-2 * Bp // block), block


def bind_library(lib):
    """Declare the argument and result types of the repro library's C
    entry points on ``lib``; returns {entry name: bound function}."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, (ptrs, ints, _) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [vp] * ptrs + [ci] * ints + [vp]
        fn.restype = ci
        fns[name] = fn
    return fns


@functools.cache
def load_library():
    """Build the repro kernels' library (once per source hash) and load it.
    Returns (ctypes library, the nvcc log of its build)."""
    return build_library(_SOURCE, "libdebug_repros")


@functools.cache
def _bound():
    """The C entries, bound once; the current-stream handle and current
    device lookups (CUDA is initialised once a CUDA tensor exists)."""
    return (bind_library(load_library()[0]), torch._C._cuda_getCurrentRawStream,
            torch._C._cuda_getDevice)


def _plant(t, every: int, value: float, start: int = 0):
    """``t`` with ``value`` at every ``every``-th element from ``start`` (in
    place)."""
    t.view(-1)[start::every] = value
    return t


def repro_inputs(device="cpu", bp: int = BP, planted: bool = False) -> dict:
    """Each repro's inputs, made as the repro makes them (numpy, seed 0),
    at G = 1 and ``bp`` columns: ``resume`` the nine blocks (x0, uinit, rx,
    ry, ryaw, ox, oy, oyaw, res), ``dataflow`` (x, done), ``carry`` (x0,
    res). ``planted`` puts -0, +-inf and NaN at fixed strides: in the eight
    blocks the echo multiplies by 0, +inf, -inf or NaN (0 inf is NaN) at
    every 16th element, block j from element j, so that each element's
    chain meets one NaN at most (IEEE 754 leaves open which NaN a sum of
    two keeps, and the CPU's kernels differ in it), and -0 in its res;
    -0, +-inf and NaN in x; -0 and -inf in the carries' res, and in their
    x0 +inf and -1 (0 (-1) is -0)."""
    def normal(rng, rows):
        return torch.as_tensor(rng.normal(size=(rows, bp)), dtype=torch.float32, device=device)

    inf, nan = float("inf"), float("nan")
    rng = np.random.default_rng(0)
    resume = [normal(rng, r) for r in (8, 2 * NH, W, W, W, M * NH, M * NH, M * NH, 8)]
    rng = np.random.default_rng(0)
    x = normal(rng, 8)
    done = torch.as_tensor(rng.integers(0, 2, size=(bp,)), dtype=torch.int32, device=device)
    rng = np.random.default_rng(0)
    x0, res = normal(rng, 8), normal(rng, 8)
    if planted:
        for j, t in enumerate(resume[:-1]):
            _plant(t, 16, (inf, -inf, nan)[j % 3], j)
        _plant(resume[-1], 3, -0.0)
        for every, value in ((3, -0.0), (5, inf), (7, -inf), (11, nan)):
            _plant(x, every, value)
        _plant(_plant(res, 3, -0.0), 7, -inf)
        _plant(_plant(x0, 4, inf), 5, -1.0)
    return {"resume": resume, "dataflow": (x, done), "carry": [x0, res]}


def _checked(kernel: str, ins: tuple, rows: int = 8):
    """One pass over a launch's inputs: each a 2-d block of at least
    ``rows`` rows and the first one's columns, all on one device, each
    starting on 16 bytes (the kernels move float4s; checked on every device,
    so that what runs on the CPU runs on the card). Returns (Bp, CUDA
    device index, the inputs' pointers), the index None for CPU tensors; on
    CUDA each must also be contiguous float32. Raises on anything else."""
    first = ins[0]
    Bp = first.shape[1] if first.dim() == 2 else -1
    dev, cuda = first.get_device(), first.is_cuda
    ptrs = []
    for t in ins:
        shape, ptr = t.shape, t.data_ptr()
        if len(shape) != 2 or shape[1] != Bp or shape[0] < rows:
            raise ValueError(f"expected ({rows}+, {Bp}) blocks, got {tuple(shape)}")
        if t.get_device() != dev:
            raise ValueError(f"tensors on several devices: {first.device}, {t.device}")
        if cuda and (t.dtype is not torch.float32 or not t.is_contiguous()):
            raise ValueError(f"expected contiguous float32, got {t.dtype} {tuple(shape)}")
        if ptr % 16:
            raise ValueError(f"{kernel}: every block must be 16-byte aligned; a view at "
                             f"{ptr:#x} is not")
        ptrs.append(ptr)
    if not cuda and first.device.type != "cpu":
        raise ValueError(f"unsupported device {first.device}")
    return Bp, dev if cuda else None, ptrs


def _launch(name: str, kernel: str, dev: int, Bp: int, *args) -> None:
    """Launch the C entry ``kernel`` on device ``dev``'s current stream with
    ``args`` (pointers, then ints) and ``launch_plan``'s shape; raises on a
    launch error and counts the launch under ``name``."""
    fns, raw_stream, current_device = _bound()
    grid, block = launch_plan(kernel, Bp)
    if dev == current_device():
        err = fns[kernel](*args, grid, block, raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fns[kernel](*args, grid, block, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launches[name] += 1


def _out8(like, Bp: int):
    """An uninitialised (8, Bp) float32 block beside ``like`` (the cheaper
    ``empty_like`` when ``like`` has that shape)."""
    return torch.empty_like(like) if like.shape[0] == 8 else like.new_empty((8, Bp))


def resume_echo_ref(x0, uinit, rx, ry, ryaw, ox, oy, oyaw, res):
    """Plain K2: res + 0 x0 + ... + 0 oyaw over the first 8 rows."""
    out = res[:8]
    for t in (x0, uinit, rx, ry, ryaw, ox, oy, oyaw):
        out = out + 0.0 * t[:8]
    return out


def resume_echo(x0, uinit, rx, ry, ryaw, ox, oy, oyaw, res):
    """K2 (8, Bp): the echo of ``res`` through a launch that reads every
    other block; every block 16-byte aligned."""
    ins = (x0, uinit, rx, ry, ryaw, ox, oy, oyaw, res)
    Bp, dev, ptrs = _checked("min_resume_echo", ins)
    if dev is None:
        return resume_echo_ref(*ins)
    out = _out8(res, Bp)
    _launch("min_resume_echo", "min_resume_echo", dev, Bp, *ptrs, out.data_ptr(), Bp)
    return out


def dataflow_k1_ref(x):
    """Plain K3 ``k1``: (u (64, Bp) = [2x + 1; 0], s = 3x - 5)."""
    u = torch.cat([2.0 * x + 1.0, x.new_zeros((2 * NH - 8, x.shape[1]))])
    return u, 3.0 * x - 5.0


def dataflow_k1(x):
    """K3 ``k1`` on x (8, Bp), 16-byte aligned."""
    Bp, dev, ptrs = _checked("min_dataflow_k1", (x,))
    if dev is None:
        return dataflow_k1_ref(x)
    u = x.new_empty((2 * NH, Bp))
    s = _out8(x, Bp)
    _launch("min_dataflow_k1", "min_dataflow_k1", dev, Bp, *ptrs, u.data_ptr(), s.data_ptr(), Bp)
    return u, s


def dataflow_k2_ref(u, s):
    """Plain K3 ``k2``: s + u[0:8]."""
    return s + u[:8]


def dataflow_k2(u, s):
    """K3 ``k2`` on u (64, Bp) and s (8, Bp), both 16-byte aligned."""
    Bp, dev, ptrs = _checked("min_dataflow_k2", (u, s))
    if dev is None:
        return dataflow_k2_ref(u, s)
    out = _out8(s, Bp)
    _launch("min_dataflow_k2", "min_dataflow_k2", dev, Bp, *ptrs, out.data_ptr(), Bp)
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


def carry_trips(x0, res, trips: int, name: str = "min_carry"):
    """The carry loop with ``trips`` >= 0 trips (counted under ``name``);
    x0 and res 16-byte aligned."""
    if trips < 0:
        raise ValueError(f"trips must be >= 0, got {trips}")
    Bp, dev, ptrs = _checked("min_carry", (x0, res))
    if dev is None:
        return carry_ref(x0, res, trips)
    out = _out8(res, Bp)
    _launch(name, "min_carry", dev, Bp, *ptrs, out.data_ptr(), Bp, trips)
    return out


def carry(x0, res):
    """K4: the 2-trip carry loop."""
    return carry_trips(x0, res, 2)


def zerotrip(x0, res):
    """K5: the same loop with 0 trips."""
    return carry_trips(x0, res, 0, "min_zerotrip")


# One PyTorch call of each kernel's function, on the wrapper's arguments,
# bitwise its plain version (tests/test_torch_debug_repros.py), or None
# where no one call computes it: K2 adds 0 x for each other block x (a NaN
# or inf there gives NaN, res = -0 plus +0 gives +0), K4 adds 0 x0[0]
# twice to rows 0..5 (the same) and writes zeros over rows 6..7, K3 k1
# writes two outputs.
LIBRARY = {
    "min_resume_echo": None,
    "min_dataflow_k1": None,
    "min_dataflow_k2": lambda u, s: torch.add(s, u[:8]),
    "min_carry": None,
    "min_zerotrip": lambda x0, res: F.pad(res[:6], (0, 0, 0, 2)),
}
