"""Shared helpers of the tests that hold ``ilqr_tpu_torch`` against ``ilqr_tpu``.

Parameters cross between the packages as numpy, so both compute with
identical values: the config through ``dataclasses.asdict``, the weights
field by field, scenario arrays as float64 arrays.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu.config import GlobalConfig as JaxGlobalConfig
from ilqr_tpu.sim.scenario import build_scenario_setup as jax_build_scenario_setup
from ilqr_tpu.sim.scenario import perturbed_initial_states
from ilqr_tpu.solvers.cilqr import solve as jax_solve
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim.scenario import build_scenario_setup
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.conftest import CONFIG_DIR

TOL = 1e-8  # float64 parity bar: sum-order drift only
WINDOW, W_BACK = 256, 24  # the small problems' reference-line window

SCENARIOS = [
    "scenario_two_straight",
    "scenario_two_borrow",
    "scenario_three_straight",
    "scenario_three_bend",
]


@functools.cache
def load_both(name):
    """(jax GlobalConfig, jax ScenarioSetup, port GlobalConfig, port ScenarioSetup),
    built once per process; callers must not modify them."""
    path = os.path.join(CONFIG_DIR, f"{name}.yaml")
    jgc, gc = JaxGlobalConfig.from_file(path), GlobalConfig.from_file(path)
    return jgc, jax_build_scenario_setup(jgc), gc, build_scenario_setup(gc)


def port_config(cfg_jax) -> CILQRConfig:
    return CILQRConfig.from_dict(dataclasses.asdict(cfg_jax))


def port_weights(w_jax, dtype=torch.float64) -> CILQRWeights:
    d = {f.name: np.asarray(getattr(w_jax, f.name)) for f in dataclasses.fields(w_jax)}
    return CILQRWeights.from_numpy(d, dtype=dtype)


def port_demo_params(p_jax, dtype=torch.float64):
    """The port's ``DemoCILQRParams`` with the JAX demo params' values."""
    from ilqr_tpu_torch.solvers.cilqr_demo import DemoCILQRParams

    return DemoCILQRParams.from_numpy(
        {f.name: np.asarray(getattr(p_jax, f.name)) for f in dataclasses.fields(p_jax)},
        dtype=dtype)


def port_tracker_params(p_jax, dtype=torch.float64):
    """The port's ``TrackerParams`` with the JAX tracker params' values."""
    from ilqr_tpu_torch.solvers.lqr_tracking import TrackerParams

    return TrackerParams.from_numpy({k: np.asarray(v) for k, v in p_jax._asdict().items()},
                                    dtype=dtype)


def t64(a):
    """A float64 CPU tensor of a numpy or JAX array."""
    return torch.as_tensor(np.array(a, dtype=np.float64))


def small_problem(name, B, seed, max_iter=6, weights=None, **cfg_over):
    """A cold batch of ``B`` perturbed starts of a shipped scenario at N = 6
    (the sizes of ``tests/test_pallas_kernel.py``): the JAX config, weights,
    starts and batched scenario, and the port's config, weights and batched
    scenario. ``weights`` and ``cfg_over`` override weights and config
    fields in both packages."""
    jgc, jst, _, st = load_both(name)
    jcfg = dataclasses.replace(JaxConfig.from_global_config(jgc, max_iter=max_iter), N=6,
                               use_last_solution=False, **cfg_over)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    if weights:
        jw = dataclasses.replace(jw, **{k: jnp.asarray(v, jnp.float64)
                                        for k, v in weights.items()})
    x0 = perturbed_initial_states(jst.ego_x0, B, seed=seed)
    jsc = jax.tree.map(lambda a: jnp.stack([a] * B),
                       jst.device_scenario(tick=0, horizon=jcfg.N, dtype=jnp.float64))
    sc = st.device_scenario(tick=0, horizon=jcfg.N, dtype=torch.float64, batch=B)
    return jcfg, jw, x0, jsc, port_config(jcfg), port_weights(jw), sc


def jax_batch(jcfg, jw, x0, jsc, carry=None):
    """The JAX XLA solve, vmapped over the rows."""
    axes = (None, None, 0, 0, None if carry is None else 0)
    return jax.jit(jax.vmap(jax_solve, in_axes=axes), static_argnums=0)(
        jcfg, jw, jnp.asarray(x0), jsc, carry)


def port_solve(cfg, w, x0, sc, **kw):
    """``cilqr_solve_cuda`` on CPU tensors (its plain version), window 256,
    w_back 24; checks that no kernel launched."""
    before = sum(ck.launches.values())
    out = ck.cilqr_solve_cuda(cfg, w, t64(x0), sc, window=WINDOW, w_back=W_BACK, **kw)
    assert sum(ck.launches.values()) == before  # CPU tensors never launch the kernel
    return out


def check_solution(u, x, stats, ju, jx, jstats):
    """Exact iterations, statuses and convergence flags; u, x and the final
    cost within TOL."""
    np.testing.assert_array_equal(stats.iters.numpy(), np.asarray(jstats.iters))
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(jstats.status))
    np.testing.assert_array_equal(stats.converged.numpy(), np.asarray(jstats.converged))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=TOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    np.testing.assert_allclose(stats.final_cost.numpy(), np.asarray(jstats.final_cost),
                               rtol=TOL)
