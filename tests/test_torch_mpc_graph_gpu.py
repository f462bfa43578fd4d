"""The graph-captured episode drivers against the host loop, on the card.

``run_mpc_kernel_scan`` and ``run_mpc_kernel_chunked`` capture their ticks
as a CUDA graph and replay it; each must equal ``run_mpc_kernel`` (one
launch a tick from the host) bit for bit, tick for tick, and count in
``ck.launches`` exactly the launches its replays made. Marked ``gpu``;
skips without a CUDA device. Imports only the port:

    python -m pytest -m gpu tests/test_torch_mpc_graph_gpu.py -q
"""

import pytest
import torch

from ilqr_tpu_torch.apps.validate_kernel import problem
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim import mpc
from ilqr_tpu_torch.types import Scenario

DUALS_MOVE = dict(alm_gamma=0.3, max_rho=40.0)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _episode_args(name, batch, ticks, dtype, dev, weights=None, **over):
    st, cfg, w, x0, rows = problem(name, batch, dtype, dev, weights, **over)
    sc = st.device_scenario(tick=0, dtype=dtype, device=dev, batch=batch)
    obs = torch.as_tensor(st.obs_preds_array(), device=dev).to(dtype)
    args = (cfg, w, x0, sc.ref_line, sc.ref_velo, obs.expand(batch, *obs.shape),
            sc.road_borders, ticks)
    return args, dict(window=384, proj_rows_per_step=rows, w_back=24)


def _tensors(out):
    ego, us, st = out[:3]
    return [ego, us, st.iters, st.status, st.converged, st.lamb_overflow, st.final_cost,
            st.final_lamb]


def _assert_bitwise(a, b):
    for i, (p, q) in enumerate(zip(_tensors(a), _tensors(b))):
        assert torch.equal(p, q), f"output {i} differs"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_graph_drivers_match_host_loop_main_path(cuda_device, dtype):
    """The main path (warm, card modes): scan and chunks bitwise equal to
    the host loop; a replay of a cached graph counts one launch a tick."""
    ticks = 8
    args, kw = _episode_args("scenario_two_straight", 1024, ticks, dtype, cuda_device,
                             use_last_solution=True)
    ref = mpc.run_mpc_kernel(*args, **kw)
    _assert_bitwise(ref, mpc.run_mpc_kernel_scan(*args, **kw))
    _assert_bitwise(ref, mpc.run_mpc_kernel_chunked(*args, chunk=4, **kw))
    name = ck.variant(args[0], dtype, ck.resolve_modes(cuda_device))
    ck.launches.clear()
    again = mpc.run_mpc_kernel_chunked(*args, chunk=4, **kw)  # both graphs cached
    torch.cuda.synchronize()
    assert dict(ck.launches) == {name: ticks}
    _assert_bitwise(ref, again)


@pytest.mark.gpu
def test_graph_schedule_matches_host_loop(cuda_device):
    """Path (a) (cold, gravity center) with the bench's schedule on every
    tick: every phase relaunches the sorted batch, bitwise the host loop's
    compaction and the run without."""
    ticks = 3
    args, kw = _episode_args("scenario_three_bend", 512, ticks, torch.float32, cuda_device)
    ref = mpc.run_mpc_kernel(*args, **kw)
    sched = dict(straggler_cap=(8, 16, 32))
    _assert_bitwise(ref, mpc.run_mpc_kernel(*args, **sched, **kw))
    ck.launches.clear()
    _assert_bitwise(ref, mpc.run_mpc_kernel_scan(*args, **sched, **kw))
    name = ck.variant(args[0], torch.float32, ck.resolve_modes(cuda_device))
    # one warm-up tick and the captured ticks, each with all four phases
    assert dict(ck.launches) == {name: ticks + 1, name + "_resume": 3 * (ticks + 1)}


@pytest.mark.gpu
def test_graph_alm_duals_carried(cuda_device):
    """ALM, warm, duals that move, carried across ticks and chunks, with
    the bench's schedule: bitwise the host loop, duals included."""
    ticks = 4
    args, kw = _episode_args("scenario_three_bend", 512, ticks, torch.float32, cuda_device,
                             weights=DUALS_MOVE, solve_type="alm", use_last_solution=True)
    sched = dict(straggler_cap=(8, 16, 32), straggler_cap_warm=(6, 12, 24))
    ref = mpc.run_mpc_kernel(*args, return_alm=True, **sched, **kw)
    scan = mpc.run_mpc_kernel_scan(*args, with_carry=True, **sched, **kw)
    chunked = mpc.run_mpc_kernel_chunked(*args, chunk=2, **sched, **kw)
    _assert_bitwise(ref, scan)
    _assert_bitwise(ref, chunked)
    mu, rho = ref[3]
    assert torch.equal(scan[3][1], mu) and torch.equal(scan[3][2], rho)
    assert bool((rho > 20.0).any())


@pytest.mark.gpu
def test_window_build_matches_pack_problem(cuda_device):
    """The per-episode packing builds each tick's problem bitwise equal to
    ``pack_problem``'s, on a shared line and on per-row lines."""
    args, kw = _episode_args("scenario_two_straight", 256, 1, torch.float32, cuda_device)
    cfg, w, x0, line, rv, obs, rb, _ = args
    modes = ck.resolve_modes(cuda_device)
    shifts = torch.linspace(-10.0, 200.0, x0.shape[0], device=cuda_device)
    ego = x0.clone()
    ego[:, 0] += shifts  # starts from the line's head to past P - W
    for ref_line in (line, line.contiguous()):
        ep = ck.pack_episode(cfg, ego, ref_line, rv, obs, rb, kw["window"], 24,
                             kw["proj_rows_per_step"], modes)
        got = ck.tick_problem(ep, ego.T, 5, torch.zeros(2, cfg.N, 256, device=cuda_device))
        sc = Scenario(ref_line=ref_line, ref_velo=rv, obs_preds=obs[:, :, 5:5 + cfg.N + 1],
                      road_borders=rb)
        want = ck.pack_problem(cfg, ego, sc, kw["window"], None, 24, kw["proj_rows_per_step"],
                               modes=modes)
        for f in ("x0", "uinit", "rx", "ry", "ryaw", "ox", "oy", "oyaw"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
