"""The port's copy of the native scenario generator (``ilqr_tpu_torch.native``)
against the JAX package's (``ilqr_tpu.native``), bit for bit, on the inputs
of ``tests/test_native.py``: both build the same C++ source with the same
flags, each from its own copy."""

import os
from pathlib import Path

import numpy as np
import pytest

from ilqr_tpu import native as jax_native
from ilqr_tpu_torch import native
from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.sim.scenario import _snap_to_center_line, build_scenario_setup

from tests.conftest import CONFIG_DIR

pytestmark = pytest.mark.skipif(not (native.available() and jax_native.available()),
                                reason="no native toolchain")

KX = [-10.0, 0.0, 50.0, 100.0, 150.0, 200.0]
KY = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
KX_BEND = [-20.0, -5.0, 10.0, 20.0, 35.0, 70.0, 100.0, 150.0]
KY_BEND = [1.0, 1.0, 1.0, 5.0, 6.5, 0.0, 0.0, 0.0]


def test_own_copy_built_in_build_dir():
    """The port builds its own source into ``ilqr_tpu_torch/_build``."""
    lib = Path(native._build())
    assert lib.parent.name == "_build" and lib.parent.parent.name == "ilqr_tpu_torch"
    assert native._SRC.parent == Path(native.__file__).parent


@pytest.mark.parametrize("kx, ky, width", [(KX, KY, 3.6), (KX_BEND, KY_BEND, -1.8)])
def test_refline_bitwise(kx, ky, width):
    got = native.refline_build(kx, ky, width)
    np.testing.assert_array_equal(got, jax_native.refline_build(kx, ky, width))
    assert got.shape[1] == 4 and len(got) > 100


@pytest.mark.parametrize("idx", [1, 4])  # vehicle 4 is oncoming (yaw ~ pi)
@pytest.mark.parametrize("noise", [False, True])
def test_routing_bitwise(idx, noise):
    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR, "scenario_two_borrow.yaml"))
    st = build_scenario_setup(gc)
    kx = [float(v) for v in gc["laneline/reference/x"]]
    ky = [float(v) for v in gc["laneline/reference/y"]]
    cond = gc["initial_condition"][idx]
    line_num, start_s = _snap_to_center_line(st.center_lines, cond[0], cond[1])
    args = (kx, ky, gc["laneline/center_line"][line_num], start_s, cond[2], cond[3],
            gc["delta_t"], gc["max_simulation_time"] + 10)
    got = native.routing_generate(*args, noise=noise, seed=3)
    np.testing.assert_array_equal(got, jax_native.routing_generate(*args, noise=noise, seed=3))
    if not noise:  # and the port's pure-Python routing, as test_native.py holds the JAX one
        np.testing.assert_allclose(got, st.routing_lines[idx].as_array(), atol=1e-9)


def test_batch_variants_bitwise():
    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR, "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    kx = np.asarray(gc["laneline/reference/x"], float)
    ky = np.asarray(gc["laneline/reference/y"], float)
    L = len(gc["laneline/center_line"])
    knots = np.stack([np.stack([kx, ky], axis=-1)] * L)
    widths = np.asarray(gc["laneline/center_line"], float)
    conds = gc["initial_condition"]
    lines, starts = zip(*[_snap_to_center_line(st.center_lines, c[0], c[1]) for c in conds])
    args = (knots, widths, lines, starts, [c[2] for c in conds], [c[3] for c in conds],
            0.1, 22.0)
    got = native.routing_generate_batch(*args, n_variants=8, seed=5)
    assert got.shape == (8, len(conds), 220, 3)
    np.testing.assert_array_equal(got, jax_native.routing_generate_batch(*args, n_variants=8,
                                                                         seed=5))
    np.testing.assert_array_equal(got, native.routing_generate_batch(*args, n_variants=8,
                                                                     seed=5))
    assert np.abs(got[0, 1] - got[1, 1]).max() > 0  # noise on the agents
    clean = native.routing_generate_batch(*args, n_variants=1, noise=False)
    np.testing.assert_array_equal(clean, jax_native.routing_generate_batch(
        *args, n_variants=1, noise=False))
