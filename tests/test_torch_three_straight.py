"""scenario_three_straight (8 agents, gravity center, warm start) on the
port's episode path, on the CPU, against the benchmark's plain reference.

The benchmark's cell ``three_straight.mpc`` runs this configuration's
100-tick warm episodes through ``run_mpc_kernel_chunked`` on the card.
Here the same function runs 20 ticks of 4 seeded starts in float64 over the
plain version of the kernel (``ck.cilqr_solve_ref``, through the same
packing), in two chunks of 10, so the warm hand-off between chunks is
covered; every tick is solved again by ``benchmarks/reference/cilqr.py``
from the program's own ego state and shifted controls, as
``benchmarks/reference/judge.py`` judges a run. The inputs are the cell's:
its configuration file, its traffic's window and ``w_back``, the scene and
the starts the benchmark builds from a seed.
"""

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmarks import harness
from benchmarks.reference.cilqr import CONVERGED, Params, Reference, proj_rows, row_limits, window
from benchmarks.scenario import build_scene, starts
from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_chunked
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights
from ilqr_tpu_torch.utils import counters

CELL = "three_straight.mpc"
B, TICKS, CHUNK = 4, 20, 10
SEED = 2**31 + 16
# u of a tick against the reference's re-solve of it. Both solve in float64
# the same equations in other orders (batched eager ops against the
# reference's own), so the controls part by rounding that the Riccati
# recursion and the line search's acceptance carry along 30 steps: 9.2e-15
# at most over these 80 solves. A wrong warm start parts by far more: the
# tick before's controls handed over unshifted part by 0.037.
U_TOL = 1e-9
# the returned next ego state against a float64 bicycle step from the
# tick's own controls: one step of the same arithmetic (0 here)
X_TOL = 1e-12


@pytest.fixture(scope="module")
def episode():
    """The cell's configuration run for TICKS ticks of B starts, with the
    counter record as the episode left it."""
    cell = harness.load_cell(CELL)
    sc, tr = cell.config["scenario"], cell.traffic
    scene, params = build_scene(sc), Params.of(sc)
    gc = GlobalConfig.from_dict(sc)
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float64)
    x0 = torch.tensor(starts(scene.ego_x0, B, SEED, 0))
    line, obs = torch.tensor(scene.line), torch.tensor(scene.obs)
    W, w_back, rows = int(tr["window"]), int(tr["w_back"]), proj_rows(params.v_ref, params.dt)
    counters.reset()
    ego, u, st = run_mpc_kernel_chunked(
        cfg, w, x0, line[None].expand(B, -1, -1),
        torch.tensor(scene.ref_velo, dtype=torch.float64).expand(B),
        obs[None].expand(B, -1, -1, -1), torch.tensor(scene.road_borders).expand(B, 2),
        TICKS, chunk=CHUNK, window=W, proj_rows_per_step=rows, w_back=w_back)
    return SimpleNamespace(cfg=cfg, params=params, line=line, obs=obs, W=W, w_back=w_back,
                           rows=rows, ego=ego, u=u, st=st, record=counters.snapshot())


@pytest.mark.timeout(120)
def test_episode_matches_reference_tick_by_tick(episode):
    """Every tick of every row: on the rows the reference converges, the
    same iterations and status; u within U_TOL everywhere; the next ego
    state the tick returned within X_TOL of a bicycle step."""
    e, N = episode, episode.params.N
    assert e.cfg.use_last_solution and e.cfg.reference_point == "gravity_center"
    assert e.cfg.num_obstacles == 8 and N == 30
    x0 = e.ego[:TICKS].reshape(-1, 4)  # (tick, row) order
    prev = torch.cat([torch.zeros_like(e.u[:1]), e.u[:-1]])  # tick 0 is cold
    u0 = torch.cat([prev[:, :, 1:], prev[:, :, -1:]], dim=2).reshape(-1, N, 2)
    obs = torch.stack([e.obs[:, t:t + N + 1] for t in range(TICKS)])
    obs = obs[:, None].expand(-1, B, -1, -1, -1).reshape(-1, *obs.shape[1:])
    ref = Reference(e.params)
    sol = ref.solve(x0, u0, window(e.line, x0, e.W, e.w_back),
                    row_limits(N, e.W, e.w_back, e.rows), obs)
    iters, status = e.st.iters.reshape(-1).long(), e.st.status.reshape(-1).long()
    conv = sol.status == CONVERGED
    assert bool(conv.float().mean() > 0.9)
    assert torch.equal(iters[conv], sol.iters[conv])
    assert torch.equal(status[conv], sol.status[conv])
    u = e.u.reshape(-1, N, 2)
    assert float((u - sol.u).abs().max()) < U_TOL
    step = ref.rollout(x0, u)[:, 1]
    assert float((e.ego[1:].reshape(-1, 4) - step).abs().max()) < X_TOL


def test_counter_record_holds_the_plan(episode):
    """The plan the episode's solves noted: 8 agent columns, 8 + 2M = 24
    constraint columns, R = 344 window rows staged (w_back 24 + 16 + 30
    steps of 10 rows, rounded up to 8), no residency on the CPU; the ticks
    counted, no graph."""
    plan = episode.record["plan"]
    assert plan["variant"] == "cilqr_solve_f64_gravity_barrier"
    assert (plan["agents"], plan["columns"], plan["rows"]) == (8, 24, 344)
    assert plan["resident"] is None
    assert plan["shared_bytes"] % 16 == 0 and plan["shared_bytes"] > 8 * 344 * 3
    assert episode.record["episode_ticks"] == TICKS
    assert episode.record.get("graph_captures", 0) == 0


@pytest.mark.parametrize("metric", ["k1_resident.mpc", "k1_ns_per_iter.mpc"])
def test_new_readers_without_the_record(metric, monkeypatch):
    """On a tree whose port has no counter module, or an empty record, each
    new reader returns None and does not raise; with a plan recorded, the
    time reader divides K1's device ns by the scenario-iterations."""
    import ilqr_tpu_torch.utils as utils

    read = harness.reader(metric)
    ctx = SimpleNamespace(kind="mpc_episodes", solves=[{"iters": 40.0}, {"iters": 60.0}],
                          trace=SimpleNamespace(spans=[("cilqr_solve_kernel<float>", 0, 50)]))
    try:
        with monkeypatch.context() as m:
            m.delattr(utils, "counters")
            m.setitem(sys.modules, "ilqr_tpu_torch.utils.counters", None)
            assert read(ctx) is None
        counters.reset()
        assert read(ctx) is None
        counters.record_plan(("test",), variant="v", agents=8, columns=24, rows=344,
                             shared_bytes=16288, resident=13)
        assert read(ctx) == {"k1_resident.mpc": 13, "k1_ns_per_iter.mpc": 500.0}[metric]
        assert read(SimpleNamespace(kind="cold_sweep")) is None
    finally:
        counters.reset()  # no made-up plan outlives the test
