"""The port's log-depth Riccati pass (``ops/riccati_pscan.py``) against
``ilqr_tpu.ops.riccati_pscan``, and ``riccati_impl="pscan"`` in the eager
solver.

Both packages in float64 on the same seeded LQ problems. The scans group
the compositions differently (Hillis-Steele against
``lax.associative_scan``), so the gains agree up to rounding: 1e-9
relative and 1e-10 absolute. Against the sequential pass at lambda = 0,
rtol 1e-7 / atol 1e-8 (``tests/test_riccati.py``'s bar). The solve at
lambda 0, N = 12, max_iter 20 (``tests/test_riccati.py:112``'s setting):
equal iterations and statuses, u and x within rtol 1e-6 / atol 1e-8,
``pscan`` against ``scan`` in the port and the port's ``pscan`` against
JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops.riccati_pscan import parallel_lqr_backward
from ilqr_tpu.solvers.cilqr import solve as jax_solve
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.ops.riccati import backward_pass
from ilqr_tpu_torch.ops import riccati_pscan
from ilqr_tpu_torch.solvers.cilqr import solve

from tests.torch_parity import load_both, port_config, port_weights, port_solve, small_problem

RTOL, ATOL = 1e-9, 1e-10
jax_parallel = jax.jit(parallel_lqr_backward)
port_parallel = riccati_pscan.parallel_lqr_backward


def _random_lq(rng, N, nx=4, nu=2):
    A = np.eye(nx) + 0.1 * rng.normal(size=(N, nx, nx))
    B = 0.1 * rng.normal(size=(N, nx, nu))
    l_x = rng.normal(size=(N + 1, nx))
    l_u = rng.normal(size=(N, nu))
    M = rng.normal(size=(N + 1, nx, nx))
    l_xx = 0.1 * np.einsum("kij,klj->kil", M, M) + np.eye(nx)
    l_uu = np.broadcast_to(np.diag([1.0, 40.0]), (N, nu, nu)).copy()
    return A, B, l_x, l_u, l_xx, l_uu


def _port(arrays):
    return [torch.as_tensor(a)[None] for a in arrays]


@pytest.mark.parametrize("N", [1, 7, 30, 64])
def test_parallel_backward_matches_jax(N, rng):
    lq = _random_lq(rng, N)
    got = port_parallel(*_port(lq))
    want = jax_parallel(*map(jnp.asarray, lq))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert not bool(got.fail[0]) and not bool(want.fail)
    # lambda on the gains only: the same as JAX's
    lamb = torch.tensor([0.7], dtype=torch.float64)
    got = port_parallel(*_port(lq), lamb=lamb)
    want = jax_parallel(*map(jnp.asarray, lq), lamb=0.7)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    # and the sequential recursion at lambda 0
    seq = backward_pass(*_port(lq), torch.zeros(1, dtype=torch.float64))
    par = port_parallel(*_port(lq))
    for g, w in zip(par[:4], seq[:4]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-7, atol=1e-8)


def test_parallel_backward_flags_indefinite_quu(rng):
    """Per row: a non-PD Q_uu block fails its row only (cholesky_ex's info
    where jnp's cholesky gives NaN)."""
    good = _random_lq(rng, 6)
    bad = [a.copy() for a in good]
    bad[5][3] = -np.eye(2)
    rows = [torch.as_tensor(np.stack([g, b])) for g, b in zip(good, bad)]
    res = port_parallel(*rows)
    assert res.fail.tolist() == [False, True]
    assert bool(jax_parallel(*map(jnp.asarray, bad)).fail)
    assert not bool(jax_parallel(*map(jnp.asarray, good)).fail)


@pytest.fixture(scope="module")
def zero_lamb():
    """The setting of tests/test_riccati.py:112 in both packages: one cold
    start of scenario_two_straight, N = 12, max_iter 20, init_lamb 0."""
    jgc, jst, _, st = load_both("scenario_two_straight")
    jw = dataclasses.replace(JaxWeights.from_global_config(jgc, dtype=jnp.float64),
                             init_lamb=jnp.float64(0.0))
    jsc = jst.device_scenario(tick=0, horizon=12, dtype=jnp.float64)
    sc = st.device_scenario(tick=0, horizon=12, dtype=torch.float64)
    x0 = np.asarray(jst.ego_x0, np.float64)
    out = {}
    for impl in ("scan", "pscan"):
        jcfg = dataclasses.replace(JaxConfig.from_global_config(jgc, max_iter=20), N=12,
                                   use_last_solution=False, riccati_impl=impl)
        ju, jx, jstats, _ = jax.jit(jax_solve, static_argnums=0)(jcfg, jw, jnp.asarray(x0),
                                                                  jsc, None)
        u, x, stats, _ = solve(port_config(jcfg), port_weights(jw),
                               torch.as_tensor(x0)[None], sc)
        out[impl] = ((u[0], x[0], int(stats.iters[0]), int(stats.status[0])),
                     (np.asarray(ju), np.asarray(jx), int(jstats.iters), int(jstats.status)))
    return out


def _same_solve(a, b):
    assert a[2:] == b[2:]
    for g, w in zip(a[:2], b[:2]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-8)


def test_pscan_solve_matches_scan_at_zero_lamb(zero_lamb):
    _same_solve(zero_lamb["pscan"][0], zero_lamb["scan"][0])


def test_pscan_solve_matches_jax(zero_lamb):
    _same_solve(zero_lamb["pscan"][0], zero_lamb["pscan"][1])


def test_kernel_plain_version_keeps_the_sequential_pass():
    """``cilqr_solve_cuda`` (its plain version, on CPU tensors) runs what
    the kernel runs, the sequential pass, whatever ``riccati_impl`` says."""
    _, _, x0, _, cfg, w, sc = small_problem("scenario_two_straight", 4, seed=3)
    ref = port_solve(cfg, w, x0, sc)
    got = port_solve(dataclasses.replace(cfg, riccati_impl="pscan"), w, x0, sc)
    for a, b in zip(ref[:2], got[:2]):
        assert torch.equal(a, b)
    assert torch.equal(ref[2].iters, got[2].iters)
