"""Wall-clock timing and profiling helpers.

Counterpart of ``ilqr_tpu/utils/timing.py``. The reference has two
``TicToc`` variants (include/utils.hpp:77-91 returning seconds,
include/utils.hpp:234-248 returning milliseconds); one class covers both.
``time_torch`` times a call whose work is enqueued asynchronously on a
CUDA device with CUDA events, so the host's early return does not lie to
the timer.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable

import torch

from ilqr_tpu_torch.utils.tree import tree_leaves


class TicToc:
    def __init__(self) -> None:
        self.tic()

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self) -> float:
        """Elapsed seconds."""
        return time.perf_counter() - self._start

    def toc_ms(self) -> float:
        """Elapsed milliseconds."""
        return 1000.0 * self.toc()


def _cuda_device(out):
    """The CUDA device of the first CUDA tensor in ``out``, or None."""
    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def time_torch(fn: Callable, *args, warmup: int = 1, iters: int = 10, **kwargs) -> float:
    """Median seconds per call of ``fn(*args, **kwargs)``.

    When the warm-up's outputs lie on a CUDA device, each call is timed
    between two CUDA events on that device's current stream (the device
    time of the work the call enqueued, launch gaps included); otherwise
    on the host's clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    dev = _cuda_device(out) if warmup else None
    if dev is not None:
        torch.cuda.synchronize(dev)
    samples = []
    for _ in range(iters):
        if dev is None:
            t = TicToc()
            fn(*args, **kwargs)
            samples.append(t.toc())
            continue
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3)
    return statistics.median(samples)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` trace of the block (the host and, with a card,
    the device), written to ``logdir`` as a Chrome trace file."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
