"""The port's two-stage ``hier`` projection (``ops/projection.py``) against
its ``exact`` one and against ``ilqr_tpu``'s ``hier``: bitwise, in float64
(both compute the same squared distances of the same rows and take first
minima in row order, so the winning rows are the same rows). A solve with
``projection="hier"`` is bitwise the ``exact`` one; rows padded with
``PAD_COORD`` never win.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops.projection import nearest_ref_points as jax_nearest
from ilqr_tpu_torch.ops.projection import HIER_STRIDE, Modes, nearest_ref_points
from ilqr_tpu_torch.sim.scenario import perturbed_initial_states
from ilqr_tpu_torch.solvers.cilqr import solve
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.torch_parity import SCENARIOS, load_both


def _queries(st, rng, n=500):
    line = st.center_lines[0]
    t = rng.integers(0, len(line.x), size=n)
    base = np.stack([line.x[t], line.y[t]], axis=-1)
    return base + rng.normal(size=base.shape) * 3.0


@pytest.mark.parametrize("name", SCENARIOS)
def test_hier_matches_exact_and_jax(name, rng):
    _, jst, _, _ = load_both(name)
    ref = jst.center_lines[0].as_array()
    pos = _queries(jst, rng)
    line, q = torch.as_tensor(ref)[None], torch.as_tensor(pos)[None]
    hier = nearest_ref_points(q, line, method="hier")
    assert torch.equal(hier, nearest_ref_points(q, line))
    np.testing.assert_array_equal(hier[0].numpy(),
                                  np.asarray(jax_nearest(jnp.asarray(pos), jnp.asarray(ref), "hier")))


def test_padded_rows_never_win(rng):
    _, _, _, pst = load_both("scenario_two_straight")
    padded = pst.center_lines[0].as_array(pad_to=4096)  # PAD_COORD rows past the line
    n = len(pst.center_lines[0].x)
    assert (4096 - 1) // HIER_STRIDE * HIER_STRIDE >= n  # coarse rows land in the padding
    pos = torch.tensor([[[1000.0, 0.0], [0.0, 0.0], [-50.0, 3.0], [210.0, 0.5]]],
                       dtype=torch.float64)
    line = torch.as_tensor(padded)[None]
    for method in ("exact", "hier"):
        got = nearest_ref_points(pos, line, method=method)
        assert float(got[..., 0].max()) < 1e5, method
    assert torch.equal(nearest_ref_points(pos, line, method="hier"), nearest_ref_points(pos, line))


def test_hier_refuses_row_limits_and_modes():
    pos, line = torch.zeros((1, 3, 2)), torch.zeros((1, 40, 4))
    with pytest.raises(ValueError):
        nearest_ref_points(pos, line, row_limits=torch.tensor([5, 5, 5]), method="hier")
    with pytest.raises(ValueError):
        nearest_ref_points(pos, line, modes=Modes(proj_dot=True), method="hier")
    with pytest.raises(ValueError):
        nearest_ref_points(pos, line, method="windowed")


def test_full_solve_same_with_hier_projection():
    """A cold batch of two_straight at its shipped N and max_iter."""
    _, _, gc, st = load_both("scenario_two_straight")
    w = CILQRWeights.from_global_config(gc, dtype=torch.float64)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, 3, seed=0))
    sc = st.device_scenario(tick=0, dtype=torch.float64, batch=3)
    outs = []
    for proj in ("exact", "hier"):
        cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, projection=proj),
                                  use_last_solution=False)
        u, x, stats, _ = solve(cfg, w, x0, sc)
        outs.append([u, x, *(getattr(stats, f.name) for f in dataclasses.fields(stats))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
