"""Numerical debugging aids.

Counterpart of ``ilqr_tpu/utils/debug.py``. The reference has no
sanitizers (SURVEY.md section 5 "Race detection"); what a data-parallel
numerical code needs is NaN trapping and a check that a sharded run equals
an unsharded one.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ilqr_tpu_torch.utils.tree import tree_leaves


class _NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the first operator whose
    floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_checking():
    """Within the block, every operator's floating outputs are checked, and
    the first NaN raises ``FloatingPointError`` naming the operator that
    produced it (torch's counterpart of ``jax_debug_nans``; each check
    syncs with the device). Leaving the block restores unchecked ops."""
    with _NanCheck():
        yield


def check_sharding_determinism(fn: Callable, sharded_args, replicated_fn: Callable,
                               replicated_args, atol: float = 0.0) -> dict:
    """Run the same computation sharded and unsharded; report max deviations.

    The outputs may be tensors or nested dicts, lists, tuples, NamedTuples
    and dataclasses of them. Returns {"leaf<i>": max_abs_diff} over their
    leaves in order. atol=0 demands bitwise determinism (valid for
    row-partitioned batches with no cross-row reductions).
    """
    def host(x):
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64)

    flat_sh = tree_leaves(fn(*sharded_args))
    flat_re = tree_leaves(replicated_fn(*replicated_args))
    if len(flat_sh) != len(flat_re):
        raise AssertionError(f"sharded run has {len(flat_sh)} leaves, replicated "
                             f"{len(flat_re)}")
    report = {}
    for i, (a, b) in enumerate(zip(flat_sh, flat_re)):
        a, b = host(a), host(b)
        d = float(np.max(np.abs(a - b))) if a.size else 0.0
        report[f"leaf{i}"] = d
        if d > atol:
            raise AssertionError(
                f"sharded vs replicated mismatch at leaf {i}: max|diff|={d} > {atol}")
    return report
