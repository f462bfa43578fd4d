"""The port's episode program (``run_mpc_kernel_scan``,
``run_mpc_kernel_chunked``), its per-episode packing and its sorted
straggler schedule, on the CPU, and the port's bench entry.

On CPU tensors the drivers run the tick code they capture on the card
eagerly over the plain version, so here they must equal ``run_mpc_kernel``
(the host loop) bit for bit, tick for tick, as the JAX package holds its
own episode programs to its host loop (``tests/test_pallas_kernel.py``),
and in float64 match ``ilqr_tpu.sim.mpc`` at the 1e-8 bar with exact
iterations. Sizes of the JAX tests: N = 6, max_iter 6-8, 2-4 rows, 5-6
ticks.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.sim.mpc import run_mpc as jax_run_mpc
from ilqr_tpu.sim.mpc import run_mpc_scan as jax_run_mpc_scan
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.apps import bench
from ilqr_tpu_torch.apps.validate_kernel import CASES
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim import mpc
from ilqr_tpu_torch.sim.scenario import perturbed_initial_states
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, Scenario

from tests.torch_parity import TOL, W_BACK, WINDOW, load_both, port_config, port_weights, t64

DUALS_MOVE = dict(alm_gamma=0.3, max_rho=40.0)
# with two alphas (1, 0.5) a line search exhausts at N = 6 too: mu moves, rho grows
DUALS_MOVE_CFG = dict(solve_type="alm", use_last_solution=True, min_alpha=0.25)
BENCH_CAPS = (8, 16, 32)


def _episode(name, dtype, B=3, ticks=6, max_iter=6, weights=None, **over):
    """The arguments of a batch of ``B`` episodes of a shipped scenario at
    N = 6 (starts perturbed with seed 3), up to ``ticks``."""
    _, _, gc, st = load_both(name)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=max_iter), N=6,
                              **over)
    w = CILQRWeights.from_global_config(gc, dtype=dtype, **(weights or {}))
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, B, seed=3), dtype=dtype)
    sc = st.device_scenario(tick=0, horizon=cfg.N, dtype=dtype, batch=B)
    obs = torch.as_tensor(st.obs_preds_array(), dtype=dtype).expand(B, -1, -1, -1)
    return cfg, w, x0, sc.ref_line, sc.ref_velo, obs, sc.road_borders, ticks


def _tensors(out):
    """ego, u and the six stats of an episode result."""
    ego, us, st = out[:3]
    return [ego, us] + [getattr(st, f.name) for f in dataclasses.fields(st)]


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for i, (p, q) in enumerate(zip(a, b)):
        assert torch.equal(p, q), f"output {i} differs"


def _no_launch(fn, *args, **kw):
    before = sum(ck.launches.values())
    out = fn(*args, **kw)
    assert sum(ck.launches.values()) == before  # CPU tensors never launch the kernel
    return out


# (scenario, dtype, config overrides, weight overrides, schedule)
EPISODES = {
    "f32_cold_barrier": ("scenario_two_straight", torch.float32,
                         dict(use_last_solution=False), None, {}),
    "f64_warm_barrier": ("scenario_two_straight", torch.float64,
                         dict(use_last_solution=True), None, {}),
    "f32_cold_gravity_schedule": ("scenario_three_bend", torch.float32,
                                  dict(use_last_solution=False), None,
                                  dict(straggler_cap=(2, 4))),
    "f64_warm_barrier_schedule": ("scenario_two_straight", torch.float64,
                                  dict(use_last_solution=True), None,
                                  dict(straggler_cap=3, straggler_cap_warm=2)),
    "alm_two_borrow": ("scenario_two_borrow", torch.float64,
                       dict(solve_type="alm", use_last_solution=True), None, {}),
    "alm_three_bend_duals_move": ("scenario_three_bend", torch.float32, DUALS_MOVE_CFG,
                                  DUALS_MOVE,
                                  dict(straggler_cap=(2, 4), straggler_cap_warm=2)),
}


@pytest.mark.parametrize("case", list(EPISODES))
def test_graph_drivers_bitwise_host_loop(case):
    """``run_mpc_kernel_scan`` and ``run_mpc_kernel_chunked`` (chunks of 2
    and 3) equal ``run_mpc_kernel`` in ego, u and the six stats, tick for
    tick, and in ALM mode in the final duals; with a schedule, rows resume
    past their first cap."""
    name, dtype, over, weights, sched = EPISODES[case]
    args = _episode(name, dtype, weights=weights, **over)
    cfg = args[0]
    alm = cfg.solve_type == "alm"
    kw = dict(window=WINDOW, w_back=W_BACK, **sched)
    ref = _no_launch(mpc.run_mpc_kernel, *args, return_alm=alm, **kw)
    scan = _no_launch(mpc.run_mpc_kernel_scan, *args, with_carry=True, **kw)
    _assert_bitwise(_tensors(ref), _tensors(scan))
    for chunk in (2, 3):
        _assert_bitwise(_tensors(ref), _tensors(_no_launch(mpc.run_mpc_kernel_chunked, *args,
                                                           chunk=chunk, **kw)))
    u_last, mu, rho = scan[3]
    assert torch.equal(u_last, ref[1][-1])
    if alm:
        _assert_bitwise(ref[3], (mu, rho))
    if case == "alm_three_bend_duals_move":
        assert bool((rho > float(args[1].alm_rho_init)).any())  # the duals moved
    if sched:
        assert bool((ref[2].iters > ck.straggler_schedule(sched["straggler_cap"],
                                                          cfg.max_iter)[0]).any())


@pytest.mark.parametrize("t0", [3, torch.tensor(3)], ids=["int", "tensor"])
def test_scan_continuation_t0_carry(t0):
    """Two calls, the second from ``t0`` with the first's carry and a warm
    first tick, equal one episode, duals included (ALM, moving duals)."""
    args = _episode("scenario_three_bend", torch.float64, weights=DUALS_MOVE, **DUALS_MOVE_CFG)
    cfg, w, x0, line, rv, obs, rb, ticks = args
    kw = dict(window=WINDOW, w_back=W_BACK, straggler_cap=(2, 4), straggler_cap_warm=2)
    ref = mpc.run_mpc_kernel(*args, return_alm=True, **kw)
    ego1, us1, st1, carry = mpc.run_mpc_kernel_scan(cfg, w, x0, line, rv, obs, rb, 3,
                                                    with_carry=True, **kw)
    ego2, us2, st2, carry2 = mpc.run_mpc_kernel_scan(
        cfg, w, ego1[-1], line, rv, obs, rb, 3, t0=t0, carry_in=carry, with_carry=True,
        cold_first_tick=False, **kw)
    joined = [torch.cat([ego1, ego2[1:]]), torch.cat([us1, us2])] + [
        torch.cat([getattr(st1, f.name), getattr(st2, f.name)])
        for f in dataclasses.fields(st1)]
    _assert_bitwise(_tensors(ref), joined)
    _assert_bitwise(ref[3], carry2[1:])
    assert bool((carry[2] > float(w.alm_rho_init)).any())  # duals moved before the split


@pytest.mark.parametrize("caps", [(2, 5), 3], ids=str)
@pytest.mark.parametrize("case", ["rear_barrier", "gravity_alm_duals_move"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_sorted_schedule_bitwise_solve_packed(dtype, case, caps):
    """The schedule in the JAX form (every phase relaunches the sorted
    batch; stopped rows pass through) equals ``solve_packed`` (only the
    stragglers relaunch) and one pass, bit for bit."""
    name, over, wover = CASES[case]
    _, _, gc, st = load_both(name)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=8), N=6,
                              use_last_solution=False, **over)
    w = CILQRWeights.from_global_config(gc, dtype=dtype, **wover)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, 8, seed=0), dtype=dtype)
    p = ck.pack_problem(cfg, x0, st.device_scenario(tick=0, horizon=6, dtype=dtype, batch=8),
                        WINDOW, w_back=W_BACK)
    one = ck.solve_packed(cfg, w, p)
    sorted_ = _no_launch(ck.solve_packed_sorted, cfg, w, p, caps)
    _assert_bitwise([t for t in ck.solve_packed(cfg, w, p, caps) if t is not None],
                    [t for t in sorted_ if t is not None])
    _assert_bitwise([t for t in one if t is not None], [t for t in sorted_ if t is not None])
    assert bool((one.stats[0] > ck.straggler_schedule(caps, 8)[0]).any())


def test_sorted_schedule_near_tie_path_a_float32():
    """Path (a)'s cold float32 solve at N = 30 (``tests/test_torch_straggler.py``'s
    near-tie case: row 19 resumes at iteration 16 on a near-tie): the
    sorted schedule equals one pass bit for bit."""
    _, _, gc, st = load_both("scenario_three_bend")
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float32)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, 24, seed=0), dtype=torch.float32)
    sc = st.device_scenario(tick=0, dtype=torch.float32, batch=24)
    p = ck.pack_problem(cfg, x0, sc, 384, w_back=W_BACK, proj_rows_per_step=ck.derive_proj_rows(
        gc["vehicle/target_velocity"], gc["delta_t"]))
    one = ck.solve_packed(cfg, w, p)
    assert int(one.stats[0][19]) > BENCH_CAPS[1]
    _assert_bitwise([t for t in one if t is not None],
                    [t for t in ck.solve_packed_sorted(cfg, w, p, BENCH_CAPS) if t is not None])


@pytest.fixture(scope="module")
def jax_episodes():
    """JAX float64 episodes of scenario_two_straight at N = 6, warm: the
    host loop ``run_mpc`` from the first start and the scan
    ``run_mpc_scan`` vmapped over two starts."""
    jgc, jst, _, st = load_both("scenario_two_straight")
    jcfg = dataclasses.replace(JaxConfig.from_global_config(jgc, max_iter=8), N=6,
                               use_last_solution=True)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    x0 = perturbed_initial_states(jst.ego_x0, 2, seed=3)
    ticks = 5
    host = jax_run_mpc(jcfg, jw, dataclasses.replace(jst, ego_x0=x0[0]), dtype=jnp.float64,
                       ticks=ticks)
    jsc = jst.device_scenario(tick=0, dtype=jnp.float64)
    obs = st.obs_preds_array()
    scan = jax.vmap(lambda x: jax_run_mpc_scan(jcfg, jw, x, jsc.ref_line, jsc.ref_velo,
                                               jnp.asarray(obs), jsc.road_borders,
                                               ticks))(jnp.asarray(x0))
    return port_config(jcfg), port_weights(jw), st, x0, ticks, host, scan


def test_graph_drivers_match_jax_float64(jax_episodes):
    """The batched drivers against ``ilqr_tpu.sim.mpc.run_mpc_scan``:
    exact iterations and statuses, ego and u within 1e-8."""
    cfg, w, st, x0, ticks, _, (ego_r, us_r, st_r) = jax_episodes
    B = len(x0)
    sc = st.device_scenario(tick=0, horizon=cfg.N, dtype=torch.float64, batch=B)
    obs = t64(st.obs_preds_array()).expand(B, -1, -1, -1)
    args = (cfg, w, t64(x0), sc.ref_line, sc.ref_velo, obs, sc.road_borders, ticks)
    for out in (mpc.run_mpc_kernel_scan(*args, window=WINDOW, w_back=W_BACK),
                mpc.run_mpc_kernel_chunked(*args, chunk=ticks, window=WINDOW, w_back=W_BACK)):
        ego, us, stats = out
        np.testing.assert_array_equal(stats.iters.numpy(), np.asarray(st_r.iters).T)
        np.testing.assert_array_equal(stats.status.numpy(), np.asarray(st_r.status).T)
        np.testing.assert_allclose(ego.numpy(), np.moveaxis(np.asarray(ego_r), 0, 1), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(us.numpy(), np.moveaxis(np.asarray(us_r), 0, 1), rtol=0,
                                   atol=TOL)


def test_run_mpc_scan_matches_run_mpc_and_jax(jax_episodes):
    """The port's one-scenario scan equals its ``run_mpc`` bit for bit and
    matches ``ilqr_tpu.sim.mpc.run_mpc`` within 1e-8, iterations exact."""
    cfg, w, st, x0, ticks, host, _ = jax_episodes
    ego, us, stats = mpc.run_mpc_scan(cfg, w, t64(x0[0]), st.center_lines[0].as_array(),
                                      st.gc["vehicle/target_velocity"], st.obs_preds_array(),
                                      st.road_borders, ticks)
    h = mpc.run_mpc(cfg, w, dataclasses.replace(st, ego_x0=x0[0]), ticks=ticks)
    assert np.array_equal(ego.numpy(), h["ego"]) and np.array_equal(us.numpy(), h["u"])
    assert stats.iters.tolist() == [int(s.iters) for s in h["stats"]]
    np.testing.assert_allclose(ego.numpy(), host["ego"], rtol=0, atol=TOL)
    np.testing.assert_allclose(us.numpy(), host["u"], rtol=0, atol=TOL)
    assert stats.iters.tolist() == [int(s.iters) for s in host["stats"]]
    assert stats.status.tolist() == [int(s.status) for s in host["stats"]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("lines", ["shared", "per_row"])
def test_tick_problem_bitwise_pack_problem(lines, dtype):
    """A tick packed from the episode equals ``pack_problem``'s bit for
    bit, with window starts at 0 (ego behind the line's head), mid-line and
    past P - W (the tail repeating sample P - 1), on a line shared by the
    rows (indexed) and on per-row lines (gathered)."""
    _, _, gc, st = load_both("scenario_two_straight")
    cfg = CILQRConfig.from_global_config(gc)
    B, N, W, t = 5, cfg.N, 384, 4
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, B, seed=1), dtype=dtype)
    x0[:, 0] += torch.tensor([-30.0, 0.0, 80.0, 190.0, 260.0], dtype=dtype)
    sc = st.device_scenario(tick=0, dtype=dtype, batch=B)
    line = sc.ref_line
    if lines == "per_row":  # each row its own line, shifted sideways
        line = line + torch.arange(B, dtype=dtype)[:, None, None] * torch.tensor(
            [0.0, 0.05, 0.0, 0.0], dtype=dtype)
    obs = torch.as_tensor(st.obs_preds_array(), dtype=dtype).expand(B, -1, -1, -1)
    rows = ck.derive_proj_rows(gc["vehicle/target_velocity"], gc["delta_t"])
    ep = ck.pack_episode(cfg, x0, line, sc.ref_velo, obs, sc.road_borders, W, W_BACK, rows)
    assert ep.line.dim() == (2 if lines == "shared" else 3)
    uinit = torch.randn(2, N, B, dtype=dtype, generator=torch.Generator().manual_seed(0))
    got = ck.tick_problem(ep, x0.T, t, uinit)
    scenario = Scenario(ref_line=line, ref_velo=sc.ref_velo,
                        obs_preds=obs[:, :, t:t + N + 1], road_borders=sc.road_borders)
    want = ck.pack_problem(cfg, x0, scenario, W, uinit.permute(2, 1, 0), W_BACK, rows)
    for f in ("x0", "uinit", "rx", "ry", "ryaw", "ox", "oy", "oyaw"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.row_limits == want.row_limits
    P = line.shape[1]
    assert bool((want.rx[0] == line[:, 0, 0]).any())  # a window from row 0
    assert bool((want.rx[-1] == line[:, P - 1, 0]).any())  # a tail past P - 1


def _stub_solve(cfg, w, p, max_iter=None, work=None):
    """A phase solver without host syncs: deterministic outputs of the
    packed inputs, rows stopping by a pattern of their state."""
    B, N = p.x0.shape[1], cfg.N
    it0 = p.stats[0] if p.stats is not None else torch.zeros_like(p.x0[0])
    steps = torch.arange(N + 1, dtype=p.x0.dtype)[:, None]
    x = torch.stack([p.x0[0] + 0.8 * steps, p.x0[1] + 0 * steps, p.x0[2] + 0 * steps,
                     p.x0[3] + 0 * steps])
    stop = ((p.x0[0] * 7).floor() % 2) * (it0 > 0)
    stats = torch.stack([it0 + 1, torch.zeros_like(it0), stop, torch.zeros_like(it0),
                         p.rx.sum(0) + p.ox.sum((0, 1)), torch.ones_like(it0)])
    mu = rho = None
    if cfg.solve_type == "alm":
        mu = (torch.zeros((8 + 2 * p.ox.shape[0], N, B), dtype=p.x0.dtype) if p.mu is None
              else p.mu + 1)
        rho = torch.ones(B, dtype=p.x0.dtype) if p.rho is None else p.rho * 1.5
    return ck.PackedSolution(p.uinit * 0.5 + 0.01, x, stats, mu, rho)


def test_tick_code_makes_no_host_sync(monkeypatch):
    """With the phase solver stubbed and every way a tensor reaches the
    host made to raise, the drivers run their ticks through: the code a
    CUDA graph captures makes no host sync (ALM duals carried, a
    schedule on every tick)."""
    args = _episode("scenario_three_bend", torch.float64, B=4, ticks=4, weights=DUALS_MOVE,
                    **DUALS_MOVE_CFG)
    kw = dict(window=WINDOW, w_back=W_BACK, straggler_cap=(2, 4), straggler_cap_warm=2)
    monkeypatch.setattr(ck, "cilqr_solve_ref", _stub_solve)
    stubbed = mpc.run_mpc_kernel_scan(*args, **kw)

    def host_sync(*_, **__):
        raise AssertionError("host sync in the tick code")

    for name in ("item", "tolist", "nonzero", "cpu", "numpy", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, host_sync)
    scan = mpc.run_mpc_kernel_scan(*args, **kw)
    chunked = mpc.run_mpc_kernel_chunked(*args, chunk=2, **kw)
    monkeypatch.undo()
    _assert_bitwise(_tensors(stubbed), _tensors(scan))
    _assert_bitwise(_tensors(stubbed), _tensors(chunked))


def test_prepare_launch_reads_host_weights_once(monkeypatch):
    """The weights reach the host once per set of weight tensors: a launch
    then makes no device-to-host copy, and an in-place change of a weight
    is seen."""
    args = _episode("scenario_two_straight", torch.float32)
    cfg, w = args[0], args[1]
    p = ck.pack_problem(cfg, args[2], Scenario(args[3], args[4], args[5][:, :, :7], args[6]),
                        WINDOW, w_back=W_BACK)
    first = ck.prepare_launch(cfg, w, p)
    with monkeypatch.context() as m:
        for name in ("item", "tolist"):
            m.setattr(torch.Tensor, name, lambda *_: pytest.fail("device-to-host copy"))
        again = ck.prepare_launch(cfg, w, p)
    assert again.args[0] == first.args[0]  # the same host array
    dt = ck.host_weights(w, torch.float32)[0][0]  # "dt" leads the kernel's weights
    w.dt.mul_(2.0)
    assert ck.host_weights(w, torch.float32)[0][0] == 2 * dt


@pytest.mark.parametrize("mode, metric", [("mpc", "cilqr_mpc_solves_per_sec"),
                                          ("cold", "cilqr_solves_per_sec")])
def test_bench_prints_one_json_line(monkeypatch, capsys, mode, metric):
    """``python -m ilqr_tpu_torch.apps.bench`` on the CPU at batch 2 (and
    2 ticks): one parseable JSON line on stdout."""
    for key, value in dict(BENCH_DEVICE="cpu", BENCH_MODE=mode, BENCH_BATCH="2",
                           BENCH_TICKS="2", BENCH_ITERS="1").items():
        monkeypatch.setenv(key, value)
    assert bench.main() == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == metric and result["unit"] == "solves/s"
    assert result["min"] <= result["value"] <= result["max"] and result["value"] > 0
    assert "vs_baseline" not in result
    assert "mean_iters" in out.err


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure()
