"""The port's public surface against the JAX package's, without a solve.

For every module of ``ilqr_tpu`` outside ``ops/pallas/`` (the TPU kernel,
whose counterpart is ``ops/cuda/``), the port has a module at the same
path, and every public name the JAX module defines at its top level (a
function, a class, an assignment; in an ``__init__.py`` also what it
re-exports) and every name of its ``__all__`` is an attribute of the port's
module. The JAX side is read with ``ast``, so JAX is not imported; the
port's modules are imported. The only exceptions are the TPU-only names of
``TPU_ONLY``, each with its counterpart.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "ilqr_tpu")
# TPU-only name -> (port module, its counterpart there)
TPU_ONLY = {
    "time_jax": ("ilqr_tpu_torch.utils.timing", "time_torch"),
    "cilqr_solve_pallas": ("ilqr_tpu_torch.ops.cuda.cilqr_kernel", "cilqr_solve_cuda"),
}
# modules a name may be re-exported from without being the port's to match
JAX_ONLY_MODULES = ("jax", "jaxlib", "flax", "typing")
SUBPACKAGES = ("models", "ops", "sim", "solvers")


def _jax_modules():
    """(path relative to ilqr_tpu/, port module name) of every JAX module
    outside ops/pallas/."""
    out = []
    for dirpath, dirnames, filenames in os.walk(JAX_ROOT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        rel_dir = os.path.relpath(dirpath, JAX_ROOT)
        if rel_dir.replace(os.sep, "/").startswith("ops/pallas"):
            continue
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            rel = os.path.normpath(os.path.join(rel_dir, name))
            parts = rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out.append((rel, ".".join(["ilqr_tpu_torch", *parts])))
    return out


def _public_names(path: str) -> set:
    """The names a JAX module makes public: its top-level definitions and
    assignments, its ``__all__``, and in a package's ``__init__.py`` the
    names it imports from the package."""
    tree = ast.parse(open(path).read())
    init = os.path.basename(path) == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if target.id == "__all__":
                        names |= {ast.literal_eval(e) for e in node.value.elts}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif init and isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] not in JAX_ONLY_MODULES:
                names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


MODULES = _jax_modules()


def test_every_jax_module_is_listed():
    assert len(MODULES) >= 40
    assert ("solvers/cilqr.py", "ilqr_tpu_torch.solvers.cilqr") in MODULES


@pytest.mark.parametrize("rel,port_name", MODULES, ids=[m[0] for m in MODULES])
def test_port_has_every_public_name(rel, port_name):
    port = importlib.import_module(port_name)
    missing = []
    for name in sorted(_public_names(os.path.join(JAX_ROOT, rel))):
        if name in TPU_ONLY:
            mod, counterpart = TPU_ONLY[name]
            assert hasattr(importlib.import_module(mod), counterpart), (name, counterpart)
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{port_name} lacks {missing} (ilqr_tpu/{rel})"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_all_matches_jax(sub):
    port = importlib.import_module(f"ilqr_tpu_torch.{sub}")
    tree = ast.parse(open(os.path.join(JAX_ROOT, sub, "__init__.py")).read())
    jax_all = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                   and any(getattr(t, "id", None) == "__all__" for t in n.targets))
    assert list(port.__all__) == list(jax_all)
    namespace = {}
    exec(f"from ilqr_tpu_torch.{sub} import *", namespace)
    assert set(jax_all) <= set(namespace)


def test_from_sim_import_run_mpc():
    from ilqr_tpu_torch.sim import run_mpc, run_mpc_scan
    from ilqr_tpu_torch.sim.mpc import run_mpc as direct
    from ilqr_tpu_torch.solvers import solve_batch

    assert run_mpc is direct and callable(run_mpc_scan) and callable(solve_batch)
