"""The port's demos 0 and 1 against ``ilqr_tpu``: the DARE and the LQR
regulator (``ops/dare.py``, ``solvers/lqr.py``) and LQR path tracking
(``solvers/lqr_tracking.py``, the splines it needs).

Both packages run in float64 on the same inputs (seeded numpy arrays).
Tolerances: 1e-10 absolute on the DARE, gains, controller ticks and
rollouts (relative where a rollout grows: the open loop diverges), 1e-9 on
the 5000-tick tracking episode (the JAX one reaches its goal at tick 254
here, and so must the port's), 1e-12 on the spline fits; the host-side
course and speed profile are equal. Within the port a batch equals its
rows run one at a time, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops import dare as jdare
from ilqr_tpu.solvers import lqr as jlqr
from ilqr_tpu.solvers import lqr_tracking as jtrk
from ilqr_tpu.utils import splines as jspl
from ilqr_tpu_torch.ops.dare import lqr_gain, solve_dare
from ilqr_tpu_torch.solvers import lqr_tracking as trk
from ilqr_tpu_torch.solvers.lqr import (closed_loop_rollout, lqr_demo, lqr_demo_batch_x0,
                                        open_loop_rollout)
from ilqr_tpu_torch.utils import splines as spl

from tests.torch_parity import port_tracker_params, t64

TOL = 1e-10
EPISODE_TOL = 1e-9
SPLINE_TOL = 1e-12

# the demo-0 system (reference scripts/0-lqr-demo.py:24-27)
A0 = np.array([[1.95, -0.025, -1.6], [1.6, 1.1, -3.2], [0.425, 0.185, 0.3]])
B0 = np.array([[0.0, 1.0], [1.0, 1.0], [0.0, 1.0]])


def _oracle_dare(A, B, Q, R, max_iter=150, eps=0.01):
    """(P, iterations) of the fixed-point iteration in numpy (tests/test_demos.py:21)."""
    p = Q
    for it in range(max_iter):
        p_next = A.T @ p @ A - A.T @ p @ B @ np.linalg.inv(R + B.T @ p @ B) @ B.T @ p @ A + Q
        if np.abs(p_next - p).max() < eps:
            return p_next, it + 1
        p = p_next
    return p_next, max_iter


def _close(got, want, tol=TOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=tol)


def test_dare_matches_jax_and_oracle():
    Q, R = np.eye(3), np.eye(2)
    P = solve_dare(t64(A0), t64(B0), t64(Q), t64(R))
    K = lqr_gain(t64(A0), t64(B0), t64(Q), t64(R))
    _close(P, jdare.solve_dare(A0, B0, Q, R))
    _close(K, jdare.lqr_gain(A0, B0, Q, R))
    np.testing.assert_allclose(P.numpy(), _oracle_dare(A0, B0, Q, R)[0], atol=1e-6)
    Pn = P.numpy()
    resid = (A0.T @ Pn @ A0 - A0.T @ Pn @ B0 @ np.linalg.inv(R + B0.T @ Pn @ B0) @ B0.T @ Pn @ A0
             + Q - Pn)
    assert np.abs(resid).max() < 0.02


def test_dare_batch_freezes_each_row_at_its_convergence(rng):
    """Rows that converge at different iterations: the batch equals each
    row solved alone bit for bit, and JAX's vmap (which freezes each row
    at its own exit) to 1e-10 -- a row iterated past its exit moves by up
    to eps."""
    scales = np.array([0.2, 0.5, 1.0, 1.0, 0.9])
    A = np.stack([A0 * s for s in scales])
    A[3] += 0.05 * rng.normal(size=(3, 3))
    Q = np.stack([np.eye(3) * (1 + i) for i in range(len(scales))])
    R = np.eye(2)
    iters = [_oracle_dare(a, B0, q, R)[1] for a, q in zip(A, Q)]
    assert len(set(iters)) >= 3, iters  # the rows stop at different iterations
    P = solve_dare(t64(A), t64(B0), t64(Q), t64(R))
    for i in range(len(scales)):
        alone = solve_dare(t64(A[i]), t64(B0), t64(Q[i]), t64(R))
        assert torch.equal(P[i], alone)
    P_jax = jax.vmap(jdare.solve_dare, in_axes=(0, None, 0, None))(A, B0, Q, R)
    _close(P, P_jax)


def test_rollouts_and_lqr_demo_match_jax(rng):
    Q, R = np.eye(3), np.eye(2)
    x0 = np.array([1.0, 2.0, 3.0])
    K = jdare.lqr_gain(A0, B0, Q, R)
    for got, want in ((open_loop_rollout(t64(A0), t64(x0), 50), jlqr.open_loop_rollout(A0, x0, 50)),
                      (closed_loop_rollout(t64(A0), t64(B0), t64(K), t64(x0), 20),
                       jlqr.closed_loop_rollout(A0, B0, K, x0, 20))):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w, rtol=TOL)
    P, Kp, ol, cl = lqr_demo(t64(A0), t64(B0), t64(Q), t64(R), t64(x0), steps=50)
    want = jlqr.lqr_demo(A0, B0, Q, R, x0, steps=50)
    _close(P, want[0])
    _close(Kp, want[1])
    for got, w in ((ol, want[2]), (cl, want[3])):
        for g, ww in zip(got, w):
            _close(g, ww, rtol=TOL)
    assert float(ol.x[-1].abs().max()) > 1e3 and float(cl.x[-1].abs().max()) < 1e-2
    # the batched form: JAX's vmap over the start, P and K per row
    xb = rng.normal(size=(4, 3))
    got = lqr_demo_batch_x0(t64(A0), t64(B0), t64(Q), t64(R), t64(xb), steps=30)
    want = jlqr.lqr_demo_batch_x0(A0, B0, Q, R, xb, 30)
    for g, w in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(tuple(want))):
        assert tuple(g.shape) == w.shape
        _close(g, w, rtol=TOL)


def test_spline_course_and_speed_profile_match_jax(rng):
    ax = [0.0, 15.0, 31.25, 25.0, 18.75, 7.5, -2.5]
    ay = [0.0, -7.5, -12.25, 16.25, 7.5, 12.5, -5.0]
    got, want = spl.calc_spline_course(ax, ay, 0.1), jspl.calc_spline_course(ax, ay, 0.1)
    assert len(got[4]) == len(want[4]) == 1061  # s[-1] exclusive, accumulated s += ds
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(trk.calc_speed_profile(got[2], 20 / 3.6),
                                  jtrk.calc_speed_profile(want[2], 20 / 3.6))
    # the tensor fit and evaluation
    x = np.cumsum(rng.uniform(0.5, 2.0, size=9))
    y = rng.normal(size=9)
    coeffs = spl.fit_natural_cubic(t64(x), t64(y))
    for g, w in zip(coeffs, jspl.fit_natural_cubic(x, y)):
        _close(g, w, SPLINE_TOL)
    t = np.linspace(x[0] - 1, x[-1] + 1, 37)
    for dd in (0, 1, 2):
        _close(spl.eval_spline(t64(x), *coeffs, t64(t), dd=dd),
               jspl.eval_spline(x, *jspl.fit_natural_cubic(x, y), t, dd=dd), SPLINE_TOL)
        _close(spl.CubicSpline1D(x, y)(t, dd), jspl.CubicSpline1D(x, y)(t, dd), SPLINE_TOL)
    s = np.linspace(0.0, 40.0, 23)
    _close(spl.CubicSpline2D(ax, ay).calc_curvature(s),
           jspl.CubicSpline2D(ax, ay).calc_curvature(s), SPLINE_TOL)


def test_nearest_index_sign():
    cx = torch.linspace(0, 10, 101, dtype=torch.float64)
    cy = torch.zeros(101, dtype=torch.float64)
    states = t64([[5.0, 1.0, 0.0, 0.0], [5.0, -1.0, 0.0, 0.0]])
    ind, e = trk.nearest_index(states, cx, cy, torch.zeros_like(cy))
    assert ind.tolist() == [50, 50]
    assert float(e[0]) > 0 and float(e[1]) < 0  # left of the path positive


def test_pi_2_pi_floors():
    a = np.array([-7.0, -3.2, -np.pi, 0.0, 3.2, 7.0, 100.0])
    _close(trk.pi_2_pi(t64(a)), jtrk.pi_2_pi(jnp.asarray(a)), 1e-12)


def test_control_step_matches_jax(rng):
    course_j, _ = jtrk.make_demo_course()
    course = tuple(t64(c) for c in course_j)
    pj = jtrk.default_params()
    p = port_tracker_params(pj)
    idx = rng.integers(0, len(course_j[0]), size=6)
    states = np.stack([np.asarray(course_j[0])[idx] + rng.normal(size=6),
                       np.asarray(course_j[1])[idx] + rng.normal(size=6),
                       np.asarray(course_j[2])[idx] + 0.2 * rng.normal(size=6),
                       rng.uniform(0.5, 6.0, size=6)], axis=-1)
    pe, pth_e = rng.normal(size=6) * 0.3, rng.normal(size=6) * 0.1
    got = trk.control_step(p, t64(states), course, t64(pe), t64(pth_e))
    want = jax.vmap(lambda s, a, b: jtrk.control_step(pj, s, course_j, a, b))(states, pe, pth_e)
    for g, w in zip(got, want):
        _close(g, w)
    _close(trk.vehicle_update(p, t64(states), got[1], got[0]),
           jax.vmap(lambda s, a, d: jtrk.vehicle_update(pj, s, a, d))(states, want[1], want[0]))


@pytest.fixture(scope="module")
def episodes():
    """The JAX episode and the port's, from the origin, and a batch of the
    origin and a perturbed start."""
    course_j, goal = jtrk.make_demo_course()
    pj = jtrk.default_params()
    want = jax.jit(lambda: jtrk.simulate(pj, course_j, goal, max_ticks=5000))()
    course, _ = trk.make_demo_course()
    p = port_tracker_params(pj)
    got = trk.simulate(p, course, goal)
    x0 = t64([[0.0, 0.0, 0.0, 0.0], [0.3, -0.4, 0.05, 0.0]])
    batch = trk.simulate(p, course, goal, x0=x0)
    return want, got, batch, (p, course, goal, x0)


def test_simulate_matches_jax(episodes):
    want, got, _, _ = episodes
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
    assert int(np.argmax(np.asarray(want[2]))) == 254
    assert int(got[2].int().argmax()) == 254
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0], want[0], EPISODE_TOL)
    _close(got[1], want[1], EPISODE_TOL)
    p = episodes[3][0]
    assert float(got[1][:, 1].abs().max()) <= float(p.max_steer) + 1e-9


def test_simulate_batch_equals_rows_alone(episodes):
    _, got, batch, (p, course, goal, x0) = episodes
    for g, b in zip(got, batch):
        assert torch.equal(b[0], g)
    alone = trk.simulate(p, course, goal, x0=x0[1])
    for a, b in zip(alone, batch):
        assert torch.equal(b[1], a)
    assert bool(batch[2][:, -1].all())
