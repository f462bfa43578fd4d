"""The CUDA kernel's launch plan, computed on the host (no GPU needed).

A block of one warp per scenario, lane k owning horizon step k, the
solve's state in the block's dynamic shared memory: ``ck.launch_plan`` must cover
every step once, fit the card's shared memory and agree with the field
counts of the CUDA source, which checks the bytes it is given.
"""

import re
from pathlib import Path

import pytest
import torch

from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

_SOURCE = Path(ck.__file__).resolve().parents[2] / "csrc" / "cilqr_kernel.cu"


def _source_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", _SOURCE.read_text())
    assert m, name
    return int(m[1])


def test_plan_matches_the_cuda_source():
    """The wrapper's constants are the source's: lanes, the chunk bound and
    the scalars of a warp's region per step, chain, obstacle and window
    row."""
    assert _source_int("kWarp") == ck.WARP == ck.MAX_STEPS
    assert _source_int("kMaxChunk") == ck.MAX_LS_CHUNK
    step = sum(_source_int(f"k{f}Fields") for f in ("Traj", "Gain", "Deriv", "Jac"))
    assert step == ck._STEP_FIELDS
    assert _source_int("kTrialFields") == ck._TRIAL_FIELDS
    assert _source_int("kObsFields") == ck._OBS_FIELDS


# (dtype, N, M, ls_chunk, proj_dot, R): the main path's shape (N 30, 3
# obstacles, 312 rows searched), its serial squared mode, an ALM path's 4
# obstacles in float64, the widest chunk, a short horizon and a full
# 512-row window
SHAPES = [
    (torch.float32, 30, 3, 4, True, 312),
    (torch.float32, 30, 3, 0, False, 312),
    (torch.float64, 30, 4, 4, True, 312),
    (torch.float64, 30, 3, 8, True, 512),
    (torch.float32, 5, 1, 3, False, 64),
    (torch.float64, 31, 3, 4, True, 384),
]


@pytest.mark.parametrize("dtype,N,M,chunk,dot,R", SHAPES)
def test_plan_covers_every_step_and_fits(dtype, N, M, chunk, dot, R):
    """Every step 0..N has one lane of a warp; lanes hold at most one step
    each, so their window rows differ by at most one step's; the region is
    the counted scalars rounded up to 16 bytes, and stays under the card's
    227 KB a block."""
    modes = ck.Modes(dot, chunk, False)
    plan = ck.launch_plan(8192, N, M, R, dtype, modes)
    assert plan.lanes == ck.WARP
    assert len(plan.step_lane) == N + 1 <= plan.lanes
    assert sorted(plan.step_lane) == list(range(N + 1))  # each step exactly once
    limits = ck.row_limits(N, R, 24, 9)
    load = [sum(limits[k] for k, lane in enumerate(plan.step_lane) if lane == i)
            for i in range(plan.lanes)]
    held = [x for x in load if x]
    assert max(held) - min(held) <= max(limits)
    size = torch.empty((), dtype=dtype).element_size()
    floats = (N + 1) * (42 + 6 * max(chunk, 1) + 4 * M) + (3 if dot else 2) * R
    assert plan.shared_bytes == -(-floats * size // 16) * 16 <= ck.MAX_SHARED_BYTES
    assert plan.shared_bytes % 16 == 0


@pytest.mark.parametrize("B", [1, 31, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_shape(B, dtype):
    """A block of one warp per scenario: B blocks of 32 threads, each with
    one scenario's shared bytes whatever the batch."""
    modes = ck.Modes(True, 4, False)
    plan = ck.launch_plan(B, 30, 3, 312, dtype, modes)
    assert (plan.grid, plan.block) == (B, 32)
    assert plan.shared_bytes == ck.region_bytes(30, 3, 312, dtype, modes)


def test_plan_refuses_what_the_kernel_cannot_run():
    """A horizon past a warp, a window whose staged rows overflow a block's
    shared memory, a bad mode."""
    modes = ck.Modes(True, 4, False)
    with pytest.raises(ValueError, match="horizon"):
        ck.launch_plan(8, ck.MAX_STEPS, 3, 312, torch.float32, modes)
    with pytest.raises(ValueError, match="shared bytes"):
        ck.launch_plan(8, 30, 3, 20000, torch.float64, modes)
    with pytest.raises(ValueError):
        ck.launch_plan(8, 30, 3, 312, torch.float32, ck.Modes(True, 9, False))
    with pytest.raises(TypeError):
        ck.launch_plan(8, 30, 3, 312, torch.float16, modes)
