"""The PyTorch port imports neither JAX, flax nor the JAX package, and
nothing of it needs matplotlib to import.

A fresh interpreter in which importing ``jax``, ``flax``, ``ilqr_tpu`` or
``matplotlib`` raises imports every module of ``ilqr_tpu_torch``, the
chip smoke script and the oracle checks it runs on the card
(``tests/test_torch_oracle.py``). The renderer and the apps import
matplotlib only when they draw, so the port runs where it is not
installed.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "ilqr_tpu", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises ImportError
import ilqr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ilqr_tpu_torch.__path__, "ilqr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.repo_tests_module("test_torch_oracle")  # the oracle checks it runs on the card
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
