"""Straggler compaction and the resume entry on the plain path, and the
plain versions of the ``tools/debug`` repro kernels.

On CPU tensors ``cilqr_solve_cuda(straggler_cap=...)`` runs every phase
through the plain version (``cilqr_solve_ref``), resuming the rows still
running from the stats, controls and duals of the phase before. That must
equal one uncapped solve bit for bit (``torch.equal``) in every field, as
the JAX package holds its own compaction to a single pass
(``tests/test_pallas_kernel.py``), and the compacted float64 solve must
match ``ilqr_tpu.solvers.cilqr.solve`` at the 1e-8 bar of
``tests/test_torch_kernel.py``. The CUDA resume entry is held to the same on
the card (``tests/test_torch_kernel_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.solvers.cilqr import solve as jax_solve
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.apps.validate_kernel import CASES
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.ops.cuda import debug_repros as dr
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel
from ilqr_tpu_torch.sim.scenario import perturbed_initial_states
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.torch_parity import TOL, W_BACK, WINDOW, load_both, port_config, port_weights, t64

BENCH_CAPS = (8, 16, 32)  # the JAX bench's cold schedule (bench.py:86)


def _problem(case, dtype, B=8, max_iter=8, N=6, seed=0):
    """A cold batch of ``B`` perturbed starts of a ``CASES`` entry (the
    sizes of ``tests/test_pallas_kernel.py``): config, weights, x0 and the
    batched scenario."""
    name, over, wover = CASES[case]
    _, _, gc, st = load_both(name)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=max_iter), N=N,
                              use_last_solution=False, **over)
    w = CILQRWeights.from_global_config(gc, dtype=dtype, device="cpu", **wover)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, B, seed=seed), dtype=dtype)
    return cfg, w, x0, st.device_scenario(tick=0, horizon=N, dtype=dtype, batch=B)


def _stats(st):
    """The six fields of a ``SolveStats``, in order."""
    return tuple(getattr(st, f.name) for f in dataclasses.fields(st))


def _solve(cfg, w, x0, sc, window=WINDOW, **kw):
    """``cilqr_solve_cuda`` on CPU tensors, duals included in ALM mode, as
    one tuple of tensors; checks that no kernel launched."""
    before = sum(ck.launches.values())
    alm = cfg.solve_type == "alm"
    out = ck.cilqr_solve_cuda(cfg, w, x0, sc, window=window, w_back=W_BACK, return_alm=alm,
                              **kw)
    assert sum(ck.launches.values()) == before
    u, x, st = out[:3]
    return (u, x, *_stats(st)) + (tuple(out[3]) if alm else ())


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for i, (p, q) in enumerate(zip(a, b)):
        assert torch.equal(p, q), f"output {i} differs"


@pytest.mark.parametrize("caps", [3, (2, 5), BENCH_CAPS], ids=str)
@pytest.mark.parametrize("case", ["rear_barrier", "gravity_barrier", "gravity_alm_duals_move"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_compaction_bitwise_plain(dtype, case, caps):
    """Compaction on equals compaction off in u, x, the six stats and the
    duals; where a cap lies below max_iter, rows really resume past it."""
    cfg, w, x0, sc = _problem(case, dtype)
    one = _solve(cfg, w, x0, sc)
    _assert_bitwise(one, _solve(cfg, w, x0, sc, straggler_cap=caps))
    schedule = ck.straggler_schedule(caps, cfg.max_iter)
    if len(schedule) > 1:
        assert bool((one[2] > schedule[0]).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_compaction_bitwise_moving_duals(dtype):
    """The ALM duals cross the resume: at N = 30 (40 iterations) line
    searches exhaust, so mu moves and rho grows on rows that resume."""
    cfg, w, x0, sc = _problem("gravity_alm_duals_move", dtype, max_iter=40, N=30)
    one = _solve(cfg, w, x0, sc, window=384)
    _assert_bitwise(one, _solve(cfg, w, x0, sc, window=384, straggler_cap=BENCH_CAPS))
    assert bool(((one[-1] > float(w.alm_rho_init)) & (one[2] > BENCH_CAPS[0])).any())


@pytest.fixture(scope="module")
def main_path_f64():
    """The main path's cold solve (scenario_two_straight, N = 30, window 384,
    w_back 24, the derived search bound), B = 16, float64: the JAX config,
    weights and starts, and the port's compacted solve with the bench
    schedule."""
    jgc, jst, _, st = load_both("scenario_two_straight")
    jcfg = JaxConfig.from_global_config(jgc)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    x0 = perturbed_initial_states(jst.ego_x0, 16, seed=0)
    rows = ck.derive_proj_rows(jgc["vehicle/target_velocity"], jgc["delta_t"])
    sc = st.device_scenario(tick=0, dtype=torch.float64, batch=16)
    kw = dict(window=384, proj_rows_per_step=rows)
    cfg, w = port_config(jcfg), port_weights(jw)
    return jcfg, jw, jst, x0, _solve(cfg, w, t64(x0), sc, straggler_cap=BENCH_CAPS, **kw), kw


def test_compaction_bitwise_main_path_float64(main_path_f64):
    jcfg, jw, jst, x0, compacted, kw = main_path_f64
    sc = load_both("scenario_two_straight")[3].device_scenario(tick=0, batch=16)
    one = _solve(port_config(jcfg), port_weights(jw), t64(x0), sc, **kw)
    assert int(one[2].max()) > BENCH_CAPS[1]  # rows resume in the third phase
    _assert_bitwise(one, compacted)


def test_compaction_bitwise_path_a_float32():
    """Path (a)'s cold float32 solve (scenario_three_bend, N = 30, window
    384), B = 24: row 19 resumes at iteration 16 on a near-tie, where a
    horizon sum taken in another order (controls resumed as a strided
    view) once turned its iteration 17 from a failed line search into a
    small step."""
    _, _, gc, st = load_both("scenario_three_bend")
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float32)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, 24, seed=0), dtype=torch.float32)
    sc = st.device_scenario(tick=0, dtype=torch.float32, batch=24)
    kw = dict(window=384, proj_rows_per_step=ck.derive_proj_rows(gc["vehicle/target_velocity"],
                                                                 gc["delta_t"]))
    one = _solve(cfg, w, x0, sc, **kw)
    assert int(one[2][19]) > BENCH_CAPS[1]
    _assert_bitwise(one, _solve(cfg, w, x0, sc, straggler_cap=BENCH_CAPS, **kw))


def test_compacted_float64_matches_jax_solver(main_path_f64):
    """The compacted plain path against the JAX solver: exact iterations,
    statuses and flags, u, x and the final cost within 1e-8."""
    jcfg, jw, jst, x0, (u, x, iters, status, conv, ovf, cost, lamb), _ = main_path_f64
    jsc = jax.tree.map(lambda a: jnp.stack([a] * 16), jst.device_scenario(tick=0,
                                                                          dtype=jnp.float64))
    ju, jx, js, _ = jax.jit(jax.vmap(jax_solve, in_axes=(None, None, 0, 0, None)),
                            static_argnums=0)(jcfg, jw, jnp.asarray(x0), jsc, None)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(js.iters))
    np.testing.assert_array_equal(status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(js.converged))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(js.lamb_overflow))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=TOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    np.testing.assert_allclose(cost.numpy(), np.asarray(js.final_cost), rtol=TOL)
    np.testing.assert_array_equal(lamb.numpy(), np.asarray(js.final_lamb))


@pytest.mark.parametrize("name, weights", [
    ("scenario_three_straight", {}),  # the JAX test's case (rho_init 0: ALM terms off)
    ("scenario_three_bend", dict(alm_gamma=0.3, max_rho=40.0)),  # duals move
])
def test_episode_warm_tick_schedule_bitwise(name, weights):
    """``run_mpc_kernel`` with a first-tick and a warm-tick schedule equals
    the episode without, tick for tick, over 4 warm ALM ticks with the
    duals carried (mirrors the JAX package's
    ``test_kernel_episode_warm_tick_schedule_bitwise``)."""
    _, _, gc, st = load_both(name)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=6), N=6,
                              solve_type="alm", use_last_solution=True)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float64, **weights)
    B, ticks = 2, 4
    x0 = t64(perturbed_initial_states(st.ego_x0, B, seed=3))
    sc = st.device_scenario(tick=0, dtype=torch.float64, batch=B)
    obs = t64(st.obs_preds_array()).expand(B, -1, -1, -1)
    args = (cfg, w, x0, sc.ref_line, sc.ref_velo, obs, sc.road_borders, ticks)
    before = sum(ck.launches.values())
    plain = run_mpc_kernel(*args, window=WINDOW, w_back=W_BACK, return_alm=True)
    sched = run_mpc_kernel(*args, window=WINDOW, w_back=W_BACK, return_alm=True,
                           straggler_cap=3, straggler_cap_warm=2)
    assert sum(ck.launches.values()) == before
    ego, us, st_, (mu, rho) = plain
    _assert_bitwise((ego, us, *_stats(st_), mu, rho),
                    (sched[0], sched[1], *_stats(sched[2]), *sched[3]))
    assert bool((st_.iters[1:] > 2).any())  # warm ticks resume past their cap


def _spy_phases(monkeypatch):
    """Record the batch size and first iteration of every plain-version
    call ``solve_packed`` makes."""
    calls = []
    ref = ck.cilqr_solve_ref

    def spy(cfg, w, p, **kw):
        calls.append((p.x0.shape[1], p.it0))
        return ref(cfg, w, p, **kw)

    monkeypatch.setattr(ck, "cilqr_solve_ref", spy)
    return calls


def test_phase_without_stragglers_is_skipped(monkeypatch):
    cfg, w, x0, sc = _problem("gravity_barrier", torch.float64, max_iter=30)
    one = _solve(cfg, w, x0, sc)
    assert bool((one[4] | one[5]).all())  # every row stops before max_iter
    cap = int(one[2].max()) + 1
    assert cap < cfg.max_iter
    calls = _spy_phases(monkeypatch)
    _assert_bitwise(one, _solve(cfg, w, x0, sc, straggler_cap=(cap, cap + 1)))
    assert calls == [(8, 0)]  # phase 1 only: no resume ran


def test_every_row_a_straggler(monkeypatch):
    cfg, w, x0, sc = _problem("rear_barrier", torch.float64)
    one = _solve(cfg, w, x0, sc)
    calls = _spy_phases(monkeypatch)
    _assert_bitwise(one, _solve(cfg, w, x0, sc, straggler_cap=1))
    assert calls == [(8, 0), (8, 1)]  # all 8 rows resume at iteration 1


def test_straggler_schedule_semantics():
    """JAX semantics (ilqr_tpu/ops/pallas/cilqr_kernel.py:1596-1622): caps
    outside (0, max_iter) are dropped, max_iter closes the schedule, and a
    tuple must be strictly increasing."""
    assert ck.straggler_schedule(0, 8) == (8,)
    assert ck.straggler_schedule(3, 8) == (3, 8)
    assert ck.straggler_schedule(8, 8) == (8,)
    assert ck.straggler_schedule(BENCH_CAPS, 8) == (8,)
    assert ck.straggler_schedule(BENCH_CAPS, 100) == (8, 16, 32, 100)
    assert ck.straggler_schedule((0, 3, 8, 9), 8) == (3, 8)
    for bad in ((5, 3), (3, 3), (2, 6, 4)):
        with pytest.raises(ValueError, match="strictly increasing"):
            ck.straggler_schedule(bad, 100)
    cfg, w, x0, sc = _problem("rear_barrier", torch.float64)
    with pytest.raises(ValueError, match="strictly increasing"):
        _solve(cfg, w, x0, sc, straggler_cap=(5, 3))


def test_resume_state_checks():
    """A problem that starts past iteration 0 needs a resume slab of 6
    rows."""
    cfg, w, x0, sc = _problem("rear_barrier", torch.float32)
    p = ck.pack_problem(cfg, x0, sc, WINDOW, w_back=W_BACK)
    with pytest.raises(ValueError, match="it0"):
        ck.check_packed(cfg, dataclasses.replace(p, it0=3))
    with pytest.raises(ValueError, match="stats"):
        ck.check_packed(cfg, dataclasses.replace(p, stats=torch.zeros(5, 8), it0=3))
    ck.check_packed(cfg, dataclasses.replace(p, stats=torch.zeros(6, 8), it0=3))


# the repro kernels' plain versions against the closed forms the repros
# check (``want_*`` in tools/debug/*.py), bitwise


def _no_launch(fn, *args):
    before = sum(dr.launches.values())
    out = fn(*args)
    assert sum(dr.launches.values()) == before  # CPU tensors never launch
    return out


def test_resume_echo_plain():
    ins = dr.repro_inputs()["resume"]
    assert [tuple(t.shape) for t in ins] == [(r, dr.BP) for r in (8, 64, 384, 384, 384, 96, 96,
                                                                  96, 8)]
    assert torch.equal(_no_launch(dr.resume_echo, *ins), ins[-1])


def test_dataflow_plain():
    x, done = dr.repro_inputs()["dataflow"]
    out, u1, s1 = _no_launch(dr.dataflow, x, done)
    xn = x.numpy()
    want_u, want_s = 2.0 * xn + 1.0, 3.0 * xn - 5.0
    np.testing.assert_array_equal(u1[:8].numpy(), want_u)
    assert not u1[8:].any() and u1.shape == (64, dr.BP)
    np.testing.assert_array_equal(s1.numpy(), want_s)
    np.testing.assert_array_equal(out.numpy(), want_s + want_u)
    assert 0 < int(done.sum()) < dr.BP  # the permutation moves columns


@pytest.mark.parametrize("fn", [dr.carry, dr.zerotrip], ids=["carry", "zerotrip"])
def test_carry_plain(fn):
    x0, res = dr.repro_inputs()["carry"]
    out = _no_launch(fn, x0, res)
    assert torch.equal(out[:6], res[:6]) and not out[6:].any() and out.shape == (8, dr.BP)
