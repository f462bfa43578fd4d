"""What a run may load: no JAX and no JAX package, compared by whole
top-level names (the port's name starts with the JAX package's); the
reference loads nothing of the port either."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmarks import harness

PROBE = ("import importlib, json, sys; importlib.import_module({mod!r}); "
         "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")


def _top_level(mod):
    out = subprocess.run([sys.executable, "-c", PROBE.format(mod=mod)], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", ["benchmarks.run", "benchmarks.reference.judge",
                                 "benchmarks.kinds.mpc_episodes",
                                 "benchmarks.kinds.cold_sweep"])
def test_no_jax(mod):
    assert not _top_level(mod) & {"jax", "jaxlib", "flax", "ilqr_tpu"}


@pytest.mark.parametrize("mod", ["benchmarks.reference", "benchmarks.reference.cilqr",
                                 "benchmarks.reference.judge"])
def test_reference_loads_nothing_of_the_port(mod):
    assert not _top_level(mod) & {"jax", "ilqr_tpu", "ilqr_tpu_torch"}
