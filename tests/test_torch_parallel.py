"""The port's parallel layer (``ilqr_tpu_torch.parallel``) on the CPU.

- ``aggregate_stats`` against ``ilqr_tpu.parallel.sharding.aggregate_stats``
  on the same stats;
- ``sharded_solve_fn`` on a 4-way CPU mesh (4 copies of ``cpu``) against the
  JAX package's on 4 of the 8 virtual CPU devices, float64, to the 1e-8 bar
  with exact iterations and statuses;
- ``sharded_kernel_solve_fn`` (the plain version per shard on CPU tensors)
  and ``run_mpc_chunked_sharded`` bitwise equal to the port's single-device
  ``cilqr_solve_cuda`` and ``run_mpc_kernel_chunked``, as
  ``tests/test_sharding.py`` holds the JAX package's sharded kernel to its
  single-device kernel;
- two processes over gloo, each with half the rows, as
  ``tests/test_multihost.py`` runs the JAX package: the all-reduced summary
  equals the single-process one.

Sums of counts (solves, converged, overflowed, iterations) and the ratios
of them are held to 1e-12. The cost sums are held to float32 rounding
(relative 1e-6): the JAX package sums float32 values in float32, the port
in float64 before rounding to float32, so the last bit may differ.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.parallel import make_mesh as jax_make_mesh
from ilqr_tpu.parallel import shard_batch as jax_shard_batch
from ilqr_tpu.parallel import sharded_solve_fn as jax_sharded_solve_fn
from ilqr_tpu.parallel.sharding import aggregate_stats as jax_aggregate_stats
from ilqr_tpu.parallel.sharding import replicate as jax_replicate
from ilqr_tpu.types import SolveStats as JaxSolveStats
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.parallel import (aggregate_stats, make_mesh, run_mpc_chunked_sharded,
                                     shard_batch, sharded_kernel_solve_fn, sharded_solve_fn)
from ilqr_tpu_torch.parallel.mesh import initialize_distributed
from ilqr_tpu_torch.parallel.sharding import replicate, shard_batch_multihost
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_chunked
from ilqr_tpu_torch.sim.scenario import perturbed_initial_states
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, SolveStats
from ilqr_tpu_torch.utils.debug import check_sharding_determinism

from tests import torch_multiprocess as tmp
from tests.torch_parity import check_solution, load_both, small_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_CAPS = (8, 16, 32)
COUNT_KEYS = ("num_solves", "converged", "lamb_overflow", "total_iters", "converged_frac",
              "mean_iters")
COST_KEYS = ("total_cost", "mean_cost")


def _assert_summary(got: dict, want: dict, exact_cost: bool = False):
    assert set(got) == set(want)
    for k in COUNT_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=1e-12, err_msg=k)
    for k in COST_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=0 if exact_cost else 1e-6, err_msg=k)


def _random_stats(B, seed):
    rng = np.random.default_rng(seed)
    return dict(iters=rng.integers(1, 100, B).astype(np.int32),
                status=rng.integers(0, 5, B).astype(np.int32),
                converged=rng.random(B) < 0.7, lamb_overflow=rng.random(B) < 0.1,
                final_cost=(rng.random(B) * 500).astype(np.float32),
                final_lamb=rng.random(B).astype(np.float32))


@pytest.mark.parametrize("B", [8, 64, 1])
def test_aggregate_stats_matches_jax(B):
    d = _random_stats(B, seed=B)
    got = aggregate_stats(SolveStats(**{k: torch.as_tensor(v) for k, v in d.items()}))
    want = jax_aggregate_stats(JaxSolveStats(**{k: jnp.asarray(v) for k, v in d.items()}))
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in got.values())
    _assert_summary(got, want)


def test_make_mesh_and_shard_batch():
    mesh = make_mesh(4)
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.group is None
    assert (mesh.world_size, mesh.rank, mesh.global_size) == (1, 0, 4)
    x = torch.arange(24.0).reshape(8, 3)
    shards = shard_batch(mesh, {"x": x, "y": x[:, 0]})
    assert len(shards) == 4
    torch.testing.assert_close(torch.cat([s["x"] for s in shards]), x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(mesh, torch.zeros(6, 2))
    with pytest.raises(ValueError, match="axis"):
        shard_batch(mesh, x, axis_name="model")
    assert len(replicate(mesh, torch.ones(2))) == 4
    with pytest.raises(ValueError, match="initialize_distributed"):
        shard_batch_multihost(mesh, x)
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("127.0.0.1:1")


@pytest.mark.parametrize("knob", [dict(groups=8), dict(interpret=True)], ids=str)
def test_tpu_knobs_raise(knob):
    cfg = CILQRConfig()
    with pytest.raises(ValueError, match="TPU kernel knobs"):
        sharded_kernel_solve_fn(make_mesh(2), cfg, **knob)


def test_sharded_solve_fn_matches_jax_f64():
    """The eager solver per shard, float64: 4-way CPU mesh against the JAX
    package's shard_map over 4 of its 8 virtual devices."""
    jcfg, jw, x0, jsc, cfg, w, sc = small_problem("scenario_two_straight", 8, seed=3,
                                                  max_iter=20)
    jmesh = jax_make_mesh(4)
    ju, jx, jstats, jsummary = jax_sharded_solve_fn(jmesh, jcfg)(
        jax_replicate(jmesh, jw), jax_shard_batch(jmesh, jnp.asarray(x0)),
        jax_shard_batch(jmesh, jsc))
    mesh = make_mesh(4)
    u, x, stats, summary = sharded_solve_fn(mesh, cfg)(w, torch.as_tensor(x0), sc)
    assert int(stats.iters.max()) > 2  # rows iterate
    check_solution(u, x, stats, ju, jx, jstats)
    _assert_summary(summary, jsummary)
    _assert_summary(summary, aggregate_stats(stats), exact_cost=True)


@pytest.fixture(scope="module")
def main_path_f32():
    """The sweep's first step at batch 8: the main path's cold float32
    solve (N = 30, window 384, the derived search bound) of
    ``perturbed_initial_states(seed=1000)``."""
    _, _, gc, st = load_both("scenario_two_straight")
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float32)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, 8, seed=1000), dtype=torch.float32)
    sc = st.device_scenario(tick=0, dtype=torch.float32, batch=8)
    rows = ck.derive_proj_rows(gc["vehicle/target_velocity"], gc["delta_t"])
    return cfg, w, x0, sc, dict(window=384, proj_rows_per_step=rows)


def _stat_fields(stats):
    return [getattr(stats, f.name) for f in dataclasses.fields(stats)]


@pytest.mark.parametrize("caps", [0, BENCH_CAPS], ids=str)
def test_sharded_kernel_solve_fn_bitwise(main_path_f32, caps):
    """The kernel engine per shard (its plain version on the CPU) on a
    2-way mesh equals one ``cilqr_solve_cuda`` of the whole batch bit for
    bit, with the bench's schedule (rows resume in its third phase) and
    without; the summary is the whole batch's."""
    cfg, w, x0, sc, kw = main_path_f32
    before = sum(ck.launches.values())
    u, x, stats, summary = sharded_kernel_solve_fn(make_mesh(2), cfg, straggler_cap=caps,
                                                   **kw)(w, x0, sc)
    u1, x1, stats1 = ck.cilqr_solve_cuda(cfg, w, x0, sc, straggler_cap=caps, **kw)
    assert sum(ck.launches.values()) == before  # CPU tensors never launch the kernel
    for a, b in zip([u, x] + _stat_fields(stats), [u1, x1] + _stat_fields(stats1)):
        assert torch.equal(a, b)
    assert int(stats.iters.max()) > BENCH_CAPS[1]
    _assert_summary(summary, aggregate_stats(stats1), exact_cost=True)


def test_sharded_kernel_alm_io_bitwise():
    """ALM dual I/O through the sharded kernel engine
    (``scenario_two_borrow``, duals seeded from numpy): the duals come back
    in row order, bitwise the single-device solve's."""
    _, _, x0, _, cfg, w, sc = small_problem("scenario_two_borrow", 8, seed=5, max_iter=8,
                                            solve_type="alm")
    x0 = torch.as_tensor(x0)
    rng = np.random.default_rng(11)
    mu0 = torch.as_tensor(rng.random((8, cfg.N, cfg.num_constraints)) * 0.1)
    rho0 = torch.as_tensor(float(w.alm_rho_init) * (1 + rng.random(8)))
    kw = dict(window=256, w_back=24)
    mesh = make_mesh(4)
    fn = sharded_kernel_solve_fn(mesh, cfg, with_alm_io=True, **kw)
    u, x, stats, summary, (mu, rho) = fn(w, x0, sc, mu0, rho0)
    u1, x1, stats1, (mu1, rho1) = ck.cilqr_solve_cuda(cfg, w, x0, sc, alm_mu0=mu0,
                                                      alm_rho0=rho0, return_alm=True, **kw)
    for a, b in zip([u, x, mu, rho] + _stat_fields(stats),
                    [u1, x1, mu1, rho1] + _stat_fields(stats1)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        fn(w, x0, sc)
    with pytest.raises(ValueError, match="ALM"):
        sharded_kernel_solve_fn(mesh, dataclasses.replace(cfg, solve_type="barrier"),
                                with_alm_io=True)


def test_run_mpc_chunked_sharded_bitwise():
    """Sharded episodes (4-way mesh) equal the single-device chunked driver
    tick for tick, bit for bit: warm start and ALM duals carried across
    chunk boundaries, cold and warm schedules (``tests/test_sharding.py``'s
    case)."""
    _, _, gc, st = load_both("scenario_two_straight")
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6), N=6,
                              solve_type="alm", use_last_solution=True)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float32)
    B, ticks = 8, 4
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, B, seed=0), dtype=torch.float32)
    sc = st.device_scenario(tick=0, horizon=cfg.N, dtype=torch.float32, batch=B)
    obs = torch.as_tensor(st.obs_preds_array(np.float32)[:, :ticks + cfg.N + 1])
    args = (x0, sc.ref_line, sc.ref_velo, obs.expand(B, *obs.shape), sc.road_borders)
    kw = dict(chunk=2, window=256, w_back=24, straggler_cap=2, straggler_cap_warm=3)
    ego, us, stats = run_mpc_chunked_sharded(make_mesh(4), cfg, w, *args, ticks=ticks, **kw)
    ego1, us1, stats1 = run_mpc_kernel_chunked(cfg, w, *args, ticks, **kw)
    assert ego.shape == (ticks + 1, B, 4) and us.shape == (ticks, B, cfg.N, 2)
    report = check_sharding_determinism(
        lambda: (ego, us, stats), (), lambda: (ego1, us1, stats1), ())
    assert len(report) == 8 and max(report.values()) == 0.0


def test_two_process_gloo(tmp_path):
    """Two processes (gloo, a file rendezvous, ``tests/torch_multiprocess.py``),
    each solving its half of the rows: both see the same all-reduced
    summary, equal to one process's summary of the whole batch, for both
    engines."""
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    store = str(tmp_path / "store")
    worker = os.path.join(REPO, "tests", "torch_multiprocess.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), store], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    results = {}
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
            line = next(s for s in out.splitlines() if s.startswith("RESULT "))
            results[r] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert results[0] == results[1]
    want = tmp.summaries(make_mesh(), *tmp.problem(8))
    for name in want:
        assert results[0][name]["num_solves"] == 8.0
        assert results[0][name]["total_iters"] > 8  # the solver iterated
        _assert_summary(results[0][name], want[name], exact_cost=True)
