"""The port's utility modules against ``ilqr_tpu.utils``: math helpers to
1e-12 and ribbon geometry (both packages in float64 on the same numpy
inputs), and the port's own timing, NaN trapping, checkpoint and sharding
determinism aids (mirroring ``tests/test_utils.py``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.utils import geometry as jax_geometry
from ilqr_tpu.utils import math as jax_math
from ilqr_tpu_torch import utils
from ilqr_tpu_torch.types import SolveStats
from ilqr_tpu_torch.utils import geometry, math
from ilqr_tpu_torch.utils.checkpoint import restore_state, save_state
from ilqr_tpu_torch.utils.debug import check_sharding_determinism, nan_checking
from ilqr_tpu_torch.utils.timing import TicToc, profile_trace, time_torch

TOL = 1e-12


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


def test_sign_matches_jax(rng):
    v = np.concatenate([rng.normal(size=7), [0.0, -0.0]])
    _close(math.sign(torch.as_tensor(v)), jax_math.sign(jnp.asarray(v)))
    assert float(math.sign(torch.tensor(0.0))) == 1.0  # reference quirk: sign(0) = +1
    ints = math.sign(torch.tensor([-3, 0, 2]))
    assert ints.dtype == torch.int32 and ints.tolist() == [-1, 1, 1]


def test_angles_and_transforms_match_jax(rng):
    th = np.concatenate([rng.uniform(-20.0, 20.0, size=9), [np.pi, -np.pi, 0.0]])
    _close(math.pi_2_pi(torch.as_tensor(th)), jax_math.pi_2_pi(jnp.asarray(th)))
    _close(math.rotation_matrix2d(torch.as_tensor(th)), jax_math.rotation_matrix2d(jnp.asarray(th)))
    x, y = rng.normal(size=2)
    _close(math.transformation_matrix2d(float(x), float(y), torch.as_tensor(th)),
           jax_math.transformation_matrix2d(float(x), float(y), jnp.asarray(th)))
    assert math.rotation_matrix2d(torch.as_tensor(th)).shape == (12, 2, 2)


def test_diff_cumsum_variance_match_jax(rng):
    m = rng.normal(size=(3, 10))
    for axis in (0, -1):
        _close(math.diff(torch.as_tensor(m), axis), jax_math.diff(jnp.asarray(m), axis))
        _close(math.cumsum(torch.as_tensor(m), axis), jax_math.cumsum(jnp.asarray(m), axis))
    _close(math.variance(torch.as_tensor(m)), jax_math.variance(jnp.asarray(m)))


def test_geometry_matches_jax(rng):
    traj = np.cumsum(rng.normal(size=(12, 4)), axis=0)
    b = geometry.get_boundary(traj, 1.9)
    np.testing.assert_array_equal(b, jax_geometry.get_boundary(traj, 1.9))
    np.testing.assert_array_equal(geometry.get_closed_curve(b),
                                  jax_geometry.get_closed_curve(b))
    assert b.shape == (11, 4) and geometry.get_closed_curve(b).shape == (2, 22)


def test_nan_checking_raises_then_restores():
    with nan_checking():
        assert float(torch.log(torch.tensor(2.0))) > 0  # finite ops pass
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.0))
    assert torch.isnan(torch.log(torch.tensor(-1.0)))  # unchecked again


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck" / "state")
    state = {"u": torch.arange(6.0).reshape(2, 3), "step": 4,
             "stats": SolveStats(*(torch.arange(3),) * 6), "x": np.ones(2)}
    save_state(path, state)
    assert os.listdir(tmp_path / "ck") == ["state"]  # the temporary file was renamed
    back = restore_state(path)
    assert torch.equal(back["u"], state["u"]) and back["step"] == 4
    assert torch.equal(back["stats"]["final_cost"], torch.arange(3))
    assert torch.equal(back["x"], torch.ones(2, dtype=torch.float64))
    template = {"u": torch.zeros(2, 3, dtype=torch.float64), "step": 0,
                "stats": SolveStats(*(torch.zeros(3, dtype=torch.float32),) * 6),
                "x": torch.zeros(2, dtype=torch.float32)}
    typed = restore_state(path, template)
    assert typed["u"].dtype == torch.float64 and typed["step"] == 4
    assert isinstance(typed["stats"], SolveStats) and typed["stats"].iters.dtype == torch.float32
    save_state(path, {"step": 5})  # overwrites whole
    assert restore_state(path) == {"step": 5}


def test_check_sharding_determinism():
    x = torch.arange(8.0)
    report = check_sharding_determinism(lambda a: {"y": a * 2, "z": (a, a + 1)}, (x,),
                                        lambda a: {"y": a * 2, "z": (a, a + 1)}, (x,))
    assert report == {"leaf0": 0.0, "leaf1": 0.0, "leaf2": 0.0}
    with pytest.raises(AssertionError, match="leaf 0"):
        check_sharding_determinism(lambda a: a, (x,), lambda a: a + 1e-9, (x,))
    assert check_sharding_determinism(lambda a: a, (x,), lambda a: a + 1e-9, (x,),
                                      atol=1e-6)["leaf0"] > 0


def test_tictoc_time_torch_and_profile_trace(tmp_path):
    assert utils.TicToc is TicToc
    t = TicToc()
    assert t.toc() >= 0.0 and t.toc_ms() >= 0.0
    assert time_torch(lambda a: (a * 2).sum(), torch.ones(16), warmup=1, iters=3) > 0
    with profile_trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))
