"""Host data of the PyTorch port equals ``ilqr_tpu``'s on all four configs.

The host side is the same float64 numpy arithmetic in both packages, so the
bar is exact equality (``assert_array_equal``); only the weights cross a
dtype conversion, and they must be exactly the JAX package's values too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ilqr_tpu.sim.scenario import perturbed_initial_states as jax_perturbed
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.sim.scenario import perturbed_initial_states
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.torch_parity import SCENARIOS, load_both


@pytest.mark.parametrize("name", SCENARIOS)
def test_config_and_geometry_equal(name):
    jgc, jst, gc, st = load_both(name)
    assert gc.config_map == jgc.config_map
    assert (gc.solve_type, gc.num_obstacles) == (jgc.solve_type, jgc.num_obstacles)
    for jl, pl in zip(jst.center_lines + jst.borders, st.center_lines + st.borders):
        np.testing.assert_array_equal(pl.as_array(), jl.as_array())
    np.testing.assert_array_equal(st.road_borders, jst.road_borders)
    np.testing.assert_array_equal(st.ego_x0, jst.ego_x0)
    assert st.num_ticks == jst.num_ticks


@pytest.mark.parametrize("name", SCENARIOS)
def test_routing_lines_equal(name):
    jgc, jst, gc, st = load_both(name)
    assert len(st.routing_lines) == len(jst.routing_lines)
    for jl, pl in zip(jst.routing_lines, st.routing_lines):
        np.testing.assert_array_equal(pl.as_array(), jl.as_array())
    np.testing.assert_array_equal(st.obs_preds_array(), jst.obs_preds_array())


def test_noisy_routing_lines_equal():
    """Seeded agent noise draws the same numbers in both packages."""
    from ilqr_tpu.sim.scenario import build_scenario_setup as jax_build
    from ilqr_tpu_torch.sim.scenario import build_scenario_setup

    jgc, _, gc, _ = load_both("scenario_two_straight")
    jst = jax_build(jgc, noise=True, seed=3)
    st = build_scenario_setup(gc, noise=True, seed=3)
    np.testing.assert_array_equal(st.obs_preds_array(), jst.obs_preds_array())


@pytest.mark.parametrize("name", SCENARIOS)
def test_device_scenario_equal(name):
    """The batched device scenario holds the JAX scenario's arrays per row."""
    import jax.numpy as jnp

    jgc, jst, gc, st = load_both(name)
    jsc = jst.device_scenario(tick=3, dtype=jnp.float64)
    sc = st.device_scenario(tick=3, dtype=torch.float64, batch=2)
    for field in ("ref_line", "ref_velo", "obs_preds", "road_borders"):
        got = getattr(sc, field).numpy()
        want = np.asarray(getattr(jsc, field))
        for row in got:
            np.testing.assert_array_equal(row, want)


@pytest.mark.parametrize("seed,n", [(0, 1024), (7, 5)])
def test_perturbed_initial_states_bit_identical(seed, n):
    _, jst, _, _ = load_both("scenario_two_straight")
    np.testing.assert_array_equal(perturbed_initial_states(jst.ego_x0, n, seed=seed),
                                  jax_perturbed(jst.ego_x0, n, seed=seed))


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_weights_and_config_equal(name, dtype):
    import jax.numpy as jnp

    jgc, _, gc, _ = load_both(name)
    jw = JaxWeights.from_global_config(jgc, dtype=getattr(jnp, dtype))
    w = CILQRWeights.from_global_config(gc, dtype=getattr(torch, dtype))
    for f in dataclasses.fields(jw):
        got = getattr(w, f.name)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jw, f.name)),
                                      err_msg=f.name)
    jcfg = JaxConfig.from_global_config(jgc)
    assert dataclasses.asdict(CILQRConfig.from_global_config(gc)) == dataclasses.asdict(jcfg)
    assert CILQRConfig.from_dict(dataclasses.asdict(jcfg)).num_constraints == \
        jcfg.num_constraints
