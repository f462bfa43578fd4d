"""One rank of the port's two-process test (``tests/test_torch_parallel.py``).

Imports only the port, so a rank starts without JAX:

    python tests/torch_multiprocess.py RANK STORE_FILE [OUT_FILE]

joins a two-rank gloo group through the file rendezvous ``STORE_FILE``,
solves its half of ``problem``'s rows with both engines, and prints
``RESULT {"eager": summary, "kernel": summary}``. Given ``OUT_FILE``, it
runs the dry run instead (``apps.dryrun.dryrun_multichip(1, "cpu")``, its
two rows of the four) and saves each leg's tensors there
(``torch.save``: {leg: [tensors]}, and the summaries of legs a and b).
"""

import dataclasses
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from ilqr_tpu_torch.config import GlobalConfig  # noqa: E402
from ilqr_tpu_torch.parallel import make_mesh, sharded_kernel_solve_fn, sharded_solve_fn  # noqa: E402
from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states  # noqa: E402
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights  # noqa: E402

KERNEL_KW = dict(window=256, w_back=24, straggler_cap=3)


def problem(batch):
    """A cold batch of 8 starts (N = 6, max_iter 8, float32) of the main
    path's scenario: (cfg, w, x0 (8, 4), the scenario of ``batch`` rows)."""
    gc = GlobalConfig.from_file(os.path.join(REPO, "configs", "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, max_iter=8), N=6)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float32)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, 8, seed=7), dtype=torch.float32)
    return cfg, w, x0, st.device_scenario(tick=0, horizon=cfg.N, dtype=torch.float32,
                                          batch=batch)


def summaries(mesh, cfg, w, x0, sc):
    """Each engine's summary of the rows ``x0`` (a tensor, or its shards) on
    ``mesh``, as floats."""
    rows = sum(t.shape[0] for t in x0) if isinstance(x0, list) else x0.shape[0]
    out = {}
    for name, fn in (("eager", sharded_solve_fn(mesh, cfg)),
                     ("kernel", sharded_kernel_solve_fn(mesh, cfg, **KERNEL_KW))):
        u, _, _, summary = fn(w, x0, sc)
        assert u.shape[0] == rows  # this process's rows, in order
        out[name] = {k: float(v) for k, v in summary.items()}
    return out


def dryrun(out_file):
    """This rank's dry run, saved to ``out_file``."""
    from ilqr_tpu_torch.apps import dryrun as dr

    out = dr.dryrun_multichip(1, "cpu")
    torch.save({"legs": {k: dr.leg_tensors(v) for k, v in out.items()},
                "summaries": {k: {n: float(t) for n, t in out[k][3].items()} for k in "ab"}},
               out_file)


def main(rank, store, out_file=None):
    from ilqr_tpu_torch.parallel.mesh import initialize_distributed
    from ilqr_tpu_torch.parallel.sharding import shard_batch_multihost

    initialize_distributed(f"file://{store}", num_processes=2, process_id=rank)
    if out_file is not None:
        dryrun(out_file)
        torch.distributed.destroy_process_group()
        return
    mesh = make_mesh()
    assert (mesh.world_size, mesh.rank, mesh.global_size) == (2, rank, 2)
    cfg, w, x0, sc = problem(4)
    local = x0[rank * 4:(rank + 1) * 4]
    out = summaries(mesh, cfg, w, shard_batch_multihost(mesh, local),
                    shard_batch_multihost(mesh, sc))
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), *sys.argv[2:4])
