"""The port's sweep entry point (``ilqr_tpu_torch.apps.sweep``) on the CPU.

Mirrors ``tests/test_apps.py``'s sweep tests (a smoke run and a checkpoint
resume) with ``--device cpu --engine eager``, and holds the JSON line to
the JAX sweep's (``--engine xla``) at the same batch, seed and device count.

Both sweeps solve in float32. ``total_solves``, ``devices`` and
``converged_frac`` are equal; ``mean_iters`` is held to 1.0 iteration:
row 4 of step 0 (``perturbed_initial_states(seed=1000)``) never converges,
and its float32 paths part, 17 iterations in the JAX package against 21 in
the port, 8 iterations apart over 8 rows at most allowed. In float64 both
packages take the same iterations on every row, 25 on row 4
(``test_sweep_rows_agree_in_float64``), so the difference is float32
divergence, not a fault.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_tpu.solvers.cilqr import solve as jax_solve
from ilqr_tpu.types import CILQRConfig as JaxConfig
from ilqr_tpu.types import CILQRWeights as JaxWeights
from ilqr_tpu_torch.apps import sweep
from ilqr_tpu_torch.parallel import make_mesh, sharded_solve_fn
from ilqr_tpu_torch.sim.scenario import perturbed_initial_states

from tests.conftest import CONFIG_DIR
from tests.torch_parity import check_solution, load_both, port_config, port_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(CONFIG_DIR, "scenario_two_straight.yaml")
CPU = ["--device", "cpu", "--engine", "eager"]
MEAN_ITERS_TOL = 1.0  # float32 path divergence on non-converging rows


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_sweep():
    """The port's sweep, one step of 8 solves over 8 CPU devices: its JSON
    line and what ``on_step`` saw."""
    steps, out = [], io.StringIO()
    with contextlib.redirect_stdout(out):
        assert sweep.main(["-c", CFG, "--batch", "8", "--steps", "1", "--devices", "8", *CPU],
                          on_step=lambda *a: steps.append(a)) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), steps


def test_sweep_app_matches_jax_sweep(port_sweep, capsys):
    """The port's JSON line against the JAX sweep's (8 virtual devices),
    and against the stats it solved."""
    got, steps = port_sweep
    from ilqr_tpu.apps.sweep import main as jax_main

    assert jax_main(["-c", CFG, "--batch", "8", "--steps", "1", "--engine", "xla"]) == 0
    want = _last_json(capsys)
    assert set(got) == set(want)
    assert (got["total_solves"], got["devices"]) == (want["total_solves"], want["devices"])
    assert got["converged_frac"] == want["converged_frac"]
    assert abs(got["mean_iters"] - want["mean_iters"]) <= MEAN_ITERS_TOL
    assert got["solves_per_sec"] > 0
    [(step, stats, summary, seconds)] = steps
    assert step == 0 and seconds > 0 and stats.iters.shape == (8,)
    assert got["mean_iters"] == float(stats.iters.double().mean())
    assert got["converged_frac"] == float(stats.converged.double().mean())
    assert summary["num_solves"] == 8.0


def test_sweep_multihost_two_gloo_ranks(port_sweep):
    """``--multihost`` with two ranks (gloo; rank, world size and a
    localhost rendezvous from the environment): each rank solves half the
    rows, and both print the one-process line over 2 devices."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port), "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "ilqr_tpu_torch.apps.sweep", "-c", CFG, "--batch", "8",
           "--steps", "1", "--multihost", *CPU]
    procs = [subprocess.Popen(cmd, cwd=REPO, env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    lines = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want = {**port_sweep[0], "devices": 2}
    for line in lines:
        assert {k: v for k, v in line.items() if k != "solves_per_sec"} == {
            k: v for k, v in want.items() if k != "solves_per_sec"}


def test_sweep_rows_agree_in_float64():
    """The sweep's step-0 rows in float64 through the port's sharded eager
    solve (2-way CPU mesh) and the JAX solver: the same iterations and
    statuses on every row, trajectories to 1e-8."""
    jgc, jst, _, _ = load_both("scenario_two_straight")
    jcfg = JaxConfig.from_global_config(jgc)
    jw = JaxWeights.from_global_config(jgc, dtype=jnp.float64)
    x0 = perturbed_initial_states(jst.ego_x0, 8, seed=1000)
    jsc = jax.tree.map(lambda a: jnp.stack([a] * 8), jst.device_scenario(tick=0))
    ju, jx, jstats, _ = jax.jit(jax.vmap(jax_solve, in_axes=(None, None, 0, 0, None)),
                                static_argnums=0)(jcfg, jw, jnp.asarray(x0), jsc, None)
    sc = load_both("scenario_two_straight")[3].device_scenario(tick=0, batch=8)
    u, x, stats, _ = sharded_solve_fn(make_mesh(2), port_config(jcfg))(
        port_weights(jw), torch.as_tensor(x0), sc)
    check_solution(u, x, stats, ju, jx, jstats)
    assert int(stats.iters[4]) == 25 and not bool(stats.converged[4])


def test_sweep_app_checkpoint_resume(tmp_path, capsys):
    """Sweep cursor checkpointing: a resumed run skips completed steps."""
    ckpt = str(tmp_path / "ckpt")
    args = ["-c", CFG, "--batch", "8", "--steps", "1", "--checkpoint-dir", ckpt, *CPU]
    assert sweep.main(args) == 0
    assert _last_json(capsys)["total_solves"] == 8
    assert os.listdir(ckpt) == ["cursor"]  # no temporary file left behind
    # second run: step 0 already done -> zero new solves
    assert sweep.main(args) == 0
    result = _last_json(capsys)
    assert result["total_solves"] == 0 and result["devices"] == 1


def test_sweep_defaults(capsys, caplog):
    """The card is the default device (it raises here, where there is
    none); ``auto`` picks the eager engine on the CPU; the default schedule
    parses to one launch."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep.main(["-c", CFG, "--batch", "8", "--steps", "0"])
    with caplog.at_level("INFO"):
        assert sweep.main(["-c", CFG, "--batch", "8", "--steps", "0", "--device", "cpu"]) == 0
    assert "devices=1 engine=eager batch=8 steps=0" in caplog.text
    assert _last_json(capsys) == {"total_solves": 0, "solves_per_sec": 0.0,
                                  "converged_frac": 0.0, "mean_iters": 0.0, "devices": 1}
    assert sweep.parse_caps(sweep.DEFAULT_STRAGGLER_CAP) == 0
    assert sweep.parse_caps("8,16,32") == (8, 16, 32)
    assert sweep.parse_caps("24") == 24
