"""Shared helpers of the tests that hold ``ilqr_tpu_torch`` against ``ilqr_tpu``.

Parameters cross between the packages as numpy, so both compute with
identical values: the config through ``dataclasses.asdict``, the weights
field by field, scenario arrays as float64 arrays.
"""

import dataclasses
import functools
import os

import numpy as np
import torch

from ilqr_tpu.config import GlobalConfig as JaxGlobalConfig
from ilqr_tpu.sim.scenario import build_scenario_setup as jax_build_scenario_setup
from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.sim.scenario import build_scenario_setup
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

from tests.conftest import CONFIG_DIR

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


def t64(a):
    """A float64 CPU tensor of a numpy or JAX array."""
    return torch.as_tensor(np.array(a, dtype=np.float64))
