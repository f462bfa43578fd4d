"""The sweep entry point and the parallel layer on the card.

The sweep's kernel engine at batch 1024 equals ``cilqr_solve_cuda`` called
directly on each step's starts, bit for bit, one launch a step; the bench's
straggler schedule equals one launch; and a one-rank NCCL group's
all-reduced summary equals the local one. Marked ``gpu``; skips without a
CUDA device. Imports only the port:

    python -m pytest -m gpu tests/test_torch_sweep_gpu.py -q
"""

import dataclasses
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from ilqr_tpu_torch.apps import sweep
from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.parallel import aggregate_stats, make_mesh, sharded_kernel_solve_fn
from ilqr_tpu_torch.parallel.mesh import initialize_distributed
from ilqr_tpu_torch.sim.scenario import build_scenario_setup
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

CFG = Path(__file__).resolve().parents[1] / "configs" / "scenario_two_straight.yaml"
BATCH = 1024
BENCH_CAPS = (8, 16, 32)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _direct(dev):
    """``solve(step, caps)``: ``cilqr_solve_cuda`` on sweep step ``step``'s
    starts with the sweep's kernel settings; and the config."""
    gc = GlobalConfig.from_file(str(CFG))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float32, device=dev)
    sc = st.device_scenario(tick=0, dtype=torch.float32, device=dev, batch=BATCH)
    kw = dict(window=384, proj_rows_per_step=ck.derive_proj_rows(gc["vehicle/target_velocity"],
                                                                 gc["delta_t"]))

    def solve(step, caps=sweep.parse_caps(sweep.DEFAULT_STRAGGLER_CAP)):
        x0 = torch.as_tensor(sweep.step_starts(st.ego_x0, BATCH, step), dtype=torch.float32,
                             device=dev)
        return ck.cilqr_solve_cuda(cfg, w, x0, sc, straggler_cap=caps, **kw)

    return solve, cfg, w, sc, kw


def _fields(stats):
    return [getattr(stats, f.name) for f in dataclasses.fields(stats)]


@pytest.mark.gpu
def test_sweep_kernel_engine_matches_direct_solves(cuda_device):
    steps = []
    ck.launches.clear()
    assert sweep.main(["-c", str(CFG), "--batch", str(BATCH), "--steps", "2", "--engine",
                       "kernel", "--window", "384"],
                      on_step=lambda step, stats, *_: steps.append((step, _fields(stats)))) == 0
    launches = dict(ck.launches)
    solve, cfg, *_ = _direct(cuda_device)
    variant = ck.variant(cfg, torch.float32, ck.resolve_modes(cuda_device))
    assert launches.get(variant) == 2 and set(launches) <= {variant, variant + "_resume"}
    assert [s for s, _ in steps] == [0, 1]
    for step, got in steps:
        assert all(torch.equal(a, b) for a, b in zip(got, _fields(solve(step)[2])))


@pytest.mark.gpu
def test_sweep_compaction_bitwise(cuda_device):
    solve = _direct(cuda_device)[0]
    one, comp = solve(0, 0), solve(0, BENCH_CAPS)
    assert int(one[2].iters.max()) > BENCH_CAPS[0]  # rows resume
    for a, b in zip(list(one[:2]) + _fields(one[2]), list(comp[:2]) + _fields(comp[2])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_one_rank_nccl_summary(cuda_device, tmp_path):
    """A one-rank NCCL group (file rendezvous, no socket): the sharded
    kernel solve's all-reduced summary equals the local aggregate."""
    solve, cfg, w, sc, kw = _direct(cuda_device)
    initialize_distributed(f"file://{tmp_path / 'store'}", num_processes=1, process_id=0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        assert mesh.group is not None and mesh.devices == (torch.device("cuda", 0),)
        x0 = torch.as_tensor(sweep.step_starts(build_scenario_setup(
            GlobalConfig.from_file(str(CFG))).ego_x0, BATCH, 0), dtype=torch.float32,
            device=cuda_device)
        u, x, stats, summary = sharded_kernel_solve_fn(mesh, cfg, **kw)(w, x0, sc)
    finally:
        dist.destroy_process_group()
    local = aggregate_stats(stats)
    assert set(summary) == set(local)
    assert all(torch.equal(summary[k], local[k]) for k in local)
    assert all(torch.equal(a, b) for a, b in zip(_fields(stats), _fields(solve(0)[2])))
