"""The thread-per-scenario CILQR kernel, for comparison only.

``ilqr_tpu_torch/csrc/cilqr_kernel_thread.cu`` is the design the warp
kernel (``csrc/cilqr_kernel.cu``) replaced: one thread runs one scenario's
whole solve, its trajectory, gains and line-search chunk in per-thread
arrays. It takes the same packed problem and computes the same function.
No solver path, option or environment variable reaches it: ``solve`` is
called only by the comparison phase of ``chip_smoke.py`` and by one GPU
test, each against the warp kernel on the same inputs.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "cilqr_kernel_thread.cu"

# Launches in this process by ``ck.variant`` (+ ``_resume``); only ``solve``
# adds to them.
launches: collections.Counter = collections.Counter()


@functools.cache
def load_library():
    """Build the thread kernel's library (once per source hash) and load it.
    Returns (ctypes library, the nvcc log of its build)."""
    lib, log = ck.build_library(_SOURCE, "libcilqr_thread")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("cilqr_solve_f32", "cilqr_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 23 + [ci] * 12 + [vp]
        fn.restype = ci
    return lib, log


def solve(cfg: CILQRConfig, w: CILQRWeights, p: ck.PackedProblem,
          max_iter: Optional[int] = None) -> ck.PackedSolution:
    """The thread kernel on packed CUDA tensors, as ``ck.cilqr_solve_kernel``
    takes them (128 threads a block, one scenario a thread)."""
    dev = p.x0.device
    ck.instantiation(cfg, p.x0.dtype, p.modes)
    if dev.type != "cuda":
        raise ValueError(f"the thread kernel needs CUDA tensors, got {dev}")
    launch = ck.prepare_launch(cfg, w, p, max_iter)
    lib, _ = load_library()
    fn = lib.cilqr_solve_f32 if p.x0.dtype == torch.float32 else lib.cilqr_solve_f64
    ck.run_entry(fn, launch, dev)
    launches[launch.name] += 1
    return launch.out
