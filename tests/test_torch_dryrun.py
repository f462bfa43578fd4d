"""The port's dry run (``ilqr_tpu_torch/apps/dryrun.py``) on the CPU.

``dryrun_multichip`` over four copies of the CPU is bitwise equal, leg by
leg, to the same calls over the whole batch with no mesh
(``single_device_legs``), and so is a two-rank gloo run (each rank its own
rows, ``tests/torch_multiprocess.py``); ``entry`` runs the batched solve;
the CLI defaults to the card and raises without one.
"""

import os
import subprocess
import sys

import pytest
import torch

from ilqr_tpu_torch.apps import dryrun as dr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def one_process():
    """dryrun_multichip(4) and dryrun_multichip(2) on the CPU, and the
    single-device legs over the 8 rows of the first."""
    return (dr.dryrun_multichip(4, "cpu"),
            dr.dryrun_multichip(2, "cpu"),
            dr.single_device_legs(8, "cpu"))


@pytest.mark.parametrize("leg", "abcd")
def test_dryrun_legs_bitwise_single_device(one_process, leg):
    sharded, _, single = one_process
    got, want = dr.leg_tensors(sharded[leg]), dr.leg_tensors(single[leg])
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_dryrun_shapes_and_summaries(one_process, capsys):
    sharded, _, _ = one_process
    u, x, stats, summary = sharded["a"]
    assert u.shape == (8, 30, 2) and x.shape == (8, 31, 4)
    assert float(summary["num_solves"]) == 8 and 8 <= float(summary["total_iters"]) <= 24
    ego, us, _ = sharded["d"]
    assert ego.shape == (5, 8, 4) and us.shape == (4, 8, 6, 2)
    assert bool(torch.isfinite(ego).all())
    capsys.readouterr()
    dr.dryrun_multichip(1, "cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(s.startswith("dryrun_multichip(1): ") for s in lines)


def test_entry_runs():
    fn, args = dr.entry(device="cpu")
    w, x0, sc = args
    assert x0.shape == (8, 4) and x0.dtype == torch.float32
    u, x, iters, converged = fn(*args)
    assert u.shape == (8, 30, 2) and x.shape == (8, 31, 4)
    assert bool(torch.isfinite(u).all()) and bool((iters >= 1).all())
    assert bool(((iters < 100) | ~converged).all())


def test_cli_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    out = subprocess.run([sys.executable, "-m", "ilqr_tpu_torch.apps.dryrun"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dr.dryrun_multichip(1)


def test_dryrun_two_process_gloo(one_process, tmp_path):
    """Two gloo ranks, each running dryrun_multichip(1) on its two rows:
    together bitwise the one-process dryrun_multichip(2), with the same
    all-reduced summaries."""
    _, whole, _ = one_process
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    worker = os.path.join(REPO, "tests", "torch_multiprocess.py")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(tmp_path / "store"), outs[r]],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=150)
            assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(o) for o in outs]
    for leg in "abcd":
        dim = 0 if leg in "ab" else 1  # episodes lead with the tick axis
        want = dr.leg_tensors(whole[leg])
        for i, b in enumerate(want):
            assert torch.equal(torch.cat([r["legs"][leg][i] for r in ranks], dim), b), (leg, i)
    for leg in "ab":
        one = {k: float(v) for k, v in whole[leg][3].items()}
        assert ranks[0]["summaries"][leg] == ranks[1]["summaries"][leg] == one
