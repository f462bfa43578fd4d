"""The port's demo CILQR (``solvers/cilqr_demo.py``) against
``ilqr_tpu.solvers.cilqr_demo``, both in float64 on the same inputs (the
JAX demo scenario's arrays, the JAX params' values, seeded controls).

Tolerances:

- the cost, its derivatives (N = 60) and the line-search rollout from the
  same gains: 1e-9 absolute;
- the backward pass and one iteration: 1e-9 absolute at N = 12 (the
  scenario cut to its first 12 steps). At N = 60 the demo's recursion
  amplifies rounding about 3x a step: one backward pass from the same
  inputs differs from JAX's by ~5e-4 on d (measured), as JAX's own batched
  and single lowerings do (``tests/test_cilqr_demo.py:59-62``);
- the full solve (N = 60, max_iter 50): the same iterations and
  convergence, J within ``J_RTOL`` (relative) and x within ``X_ATOL`` (m).
  Measured: the port on the CPU against JAX, J 5.6e-6 relative and x
  2.6e-3 m apart; the port on an H100 against the port on the CPU, J
  9.3e-6 and x 6.1e-3 m (row 0 of a batch of 4096), J 3.5e-5 (one
  solve). The bars are tighter than ``tests/test_cilqr_demo.py``'s
  batch-against-single ones (rtol 5e-3, 0.05 m); ``chip_smoke.py`` phase
  10 holds the card's solve to the CPU's with the same two numbers.

Within the port, rows of a batch are bitwise their solves alone, so
identical rows are bitwise equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.models.bicycle import rollout as jax_rollout
from ilqr_tpu.solvers import cilqr_demo as jdemo
from ilqr_tpu_torch.models.bicycle import rollout
from ilqr_tpu_torch.solvers import cilqr_demo as demo

from tests.torch_parity import port_demo_params, t64

TOL = 1e-9
J_RTOL = 1e-3
X_ATOL = 0.03
SHORT_N = 12


@pytest.fixture(scope="module")
def scene():
    """(JAX params, JAX scenario, port params, port scenario)."""
    jp, jx0, *jscene = jdemo.demo_scenario()
    return jp, (jx0, *jscene), port_demo_params(jp), tuple(t64(a) for a in (jx0, *jscene))


def _cut(scene_arrays, n):
    x0, ref, rv, oa, op = scene_arrays
    return x0, ref, rv, oa, op[:, : n + 1]


def _controls(rng, jp, jx0, n):
    u = rng.normal(size=(n, 2)) * np.array([0.5, 0.1])
    x = np.asarray(jax_rollout(jx0, jnp.asarray(u), jp.dt, jp.wheelbase, "gravity_center"))
    return u, x


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def test_demo_scenario_matches_jax(scene):
    _, jsc, p, sc = scene
    tsc = demo.demo_scenario()
    for f in dataclasses.fields(p):
        assert torch.equal(getattr(tsc[0], f.name), getattr(p, f.name)), f.name
    for got, want in zip(tsc[1:], sc):
        _close(got, want, 1e-12)
    assert torch.equal(tsc[2], sc[1])  # jnp.linspace's rounding


def test_cost_and_derivatives_match_jax(scene, rng):
    jp, (jx0, *jsc), p, (_, *sc) = scene
    u, x = _controls(rng, jp, jx0, 60)
    _close(demo.total_cost(p, t64(u)[None], t64(x)[None], *sc)[0],
           jdemo.total_cost(jp, u, x, *jsc))
    got = demo.cost_derivatives(p, t64(u)[None], t64(x)[None], *sc)
    for g, w in zip(got, jdemo.cost_derivatives(jp, u, x, *jsc)):
        _close(g[0], w)


def test_cost_derivatives_against_autograd(scene, rng):
    """l_u at every row, l_x at rows 1..N: the demo adds barrier terms at
    row 0 that its cost does not contain (the reference quirk)."""
    _, (jx0, *_), p, (x0, *sc) = scene
    u = t64(rng.normal(size=(1, 60, 2)) * np.array([0.5, 0.1]))
    x = rollout(x0[None], u, p.dt, p.wheelbase)
    l_x, l_u, _, _ = demo.cost_derivatives(p, u, x, *sc)
    uu, xx = u.clone().requires_grad_(), x.clone().requires_grad_()
    gu, gx = torch.autograd.grad(demo.total_cost(p, uu, xx, *sc).sum(), (uu, xx))
    _close(l_u, gu, 1e-8)
    _close(l_x[:, 1:], gx[:, 1:], 1e-8)
    assert not torch.allclose(l_x[:, 0], gx[:, 0])  # the row-0 quirk is there


def test_backward_forward_iter_step_match_jax(scene, rng):
    jp, jsc, p, sc = scene
    jx0, *js = _cut(jsc, SHORT_N)
    _, *ts = _cut(sc, SHORT_N)
    u, x = _controls(rng, jp, jx0, SHORT_N)
    tu, tx = t64(u)[None], t64(x)[None]
    for lamb in (20.0, 0.5):
        jd, jK = jdemo.backward_pass(jp, u, x, lamb, *js)
        d, K = demo.backward_pass(p, tu, tx, t64([lamb]), *ts)
        _close(d[0], jd)
        _close(K[0], jK)
        J = jdemo.total_cost(jp, u, x, *js)
        got = demo.iter_step(p, tu, tx, t64([float(J)]), t64([lamb]), *ts)
        want = jdemo.iter_step(jp, u, x, J, lamb, *js)
        for g, w in zip(got, want):
            _close(g[0].double(), jnp.asarray(w, jnp.float64))
    # the rollout from the same gains over the whole horizon
    jp_, (jx0, *js), _, (_, *ts) = scene
    u, x = _controls(rng, jp, jx0, 60)
    d, K = rng.normal(size=(60, 2)) * 0.1, rng.normal(size=(60, 2, 4)) * 0.1
    for alpha in demo.ALPHAS:
        got = demo.forward_pass(p, t64(u)[None], t64(x)[None], t64(d)[None], t64(K)[None], alpha)
        for g, w in zip(got, jdemo.forward_pass(jp, u, x, d, K, alpha)):
            _close(g[0], w)


@pytest.fixture(scope="module")
def solves(scene):
    jp, jsc, p, sc = scene
    want = jax.jit(lambda: jdemo.solve(jp, *jsc))()
    got = demo.solve(p, *sc)
    return want, got


def test_full_solve_matches_jax(solves):
    want, got = solves
    assert int(got.iters) == int(want.iters) == 50
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.J), float(want.J), rtol=J_RTOL)
    _close(got.x, want.x, X_ATOL)
    x = got.x.numpy()
    assert x[-1, 0] > 15.0 and np.all(x[:, 2] <= 10.3) and np.all(x[:, 2] >= -0.3)


def test_batch_rows_bitwise_alone(scene, solves):
    """Rows of a batch against the same solves alone, bit for bit: at the
    shipped tolerance (every row runs 50 iterations) and at a looser one
    under which the rows converge at different iterations and freeze."""
    _, _, p, (x0, *sc) = scene
    _, alone = solves
    starts = torch.stack([x0, x0 + t64([0.0, 0.2, -0.5, 0.0]), x0])
    res = demo.solve(p, starts, *sc)
    for t, a in zip(res, alone):
        assert torch.equal(t[0], a) and torch.equal(t[2], a)
    loose = dataclasses.replace(p, tol=t64(20.0))
    starts = torch.stack([x0, x0 + t64([0.5, 0.3, 0.0, 0.0]), x0 + t64([-0.4, -0.2, 0.5, 0.0])])
    res = demo.solve(loose, starts, *sc, max_iter=15)
    assert bool(res.converged.all()) and len(set(res.iters.tolist())) == 3, res.iters
    for i in range(3):
        one = demo.solve(loose, starts[i], *sc, max_iter=15)
        for t, a in zip(res, one):
            assert torch.equal(t[i], a)
