"""Benchmark of the port: batched CILQR throughput on the card, in full
30-step scenario solves per second.

Counterpart of the repository's ``bench.py``, on the port alone:

    python -m ilqr_tpu_torch.apps.bench              # on a machine with a CUDA GPU
    BENCH_MODE=cold python -m ilqr_tpu_torch.apps.bench

Prints one JSON line on stdout, ``{"metric", "value", "unit": "solves/s",
"min", "max"}``: the median over ``BENCH_ITERS`` timed runs after one
warm-up run (which builds the kernel and captures the episode graphs),
each run ended by ``torch.cuda.synchronize()``; min and max are the
runs' extremes. stderr gets the mean iterations, the mean final ego x
(mpc) or the converged fraction (cold), and the card's name and power
limit from ``nvidia-smi``.

Workload (``BENCH_MODE=mpc``, the default): the reference's own, batched
receding-horizon episodes of ``configs/scenario_two_straight.yaml`` from
``perturbed_initial_states(seed=0)``, float32, with the shifted-u warm
start (``BENCH_WARM=0`` turns it off); ``run_mpc_kernel_chunked`` in
chunks of ``BENCH_CHUNK`` ticks when there are more than 20 ticks, else
``run_mpc_kernel_scan``. Metric ``cilqr_mpc_solves_per_sec``: batch x
ticks solves per run. ``BENCH_MODE=cold``: one ``cilqr_solve_cuda`` of
the batch, cold; metric ``cilqr_solves_per_sec``.

Settings (environment): ``BENCH_BATCH`` (8192 mpc, 16384 cold),
``BENCH_TICKS`` (120), ``BENCH_ITERS`` (10), ``BENCH_WINDOW`` (384),
``BENCH_WBACK`` (24), ``BENCH_PROJ`` (-1: ``derive_proj_rows``, 0: the
whole window), ``BENCH_CHUNK`` (10), ``BENCH_CAP`` / ``BENCH_CAP_WARM``
(straggler schedules, "8,16,32" or one cap; "0" and "" are off, the
default), ``BENCH_DEVICE`` (``cuda``; ``cpu`` runs the plain version, a
smoke test and no measurement of the card). The modes are the device's
(``ILQR_PROJ_DOT`` / ``ILQR_LS_CHUNK`` / ``ILQR_PROJ_FOLD`` override them).
Raises when no GPU is found and ``BENCH_DEVICE`` is not ``cpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_chunked, run_mpc_kernel_scan
from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, entry_device

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "scenario_two_straight.yaml"
SCAN_TICKS = 20  # longer episodes run in chunks


def parse_caps(text: str):
    """A straggler schedule from its setting: "" is None, "8,16,32" a
    tuple, "24" one cap (0 is off)."""
    if not text:
        return None
    if "," in text:
        return tuple(int(c) for c in text.split(",") if c)
    return int(text)


def build(env, device):
    """(run, solves per run, metric): ``run()`` solves the workload once
    and returns (iterations, the mean final ego x or converged fraction)."""
    mode = env.get("BENCH_MODE", "mpc")
    if mode not in ("mpc", "cold"):
        raise ValueError(f"BENCH_MODE={mode!r}: expected mpc or cold")
    dtype = torch.float32
    gc = GlobalConfig.from_file(str(CONFIG))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=dtype, device=device)
    batch = int(env.get("BENCH_BATCH", "8192" if mode == "mpc" else "16384"))
    window = int(env.get("BENCH_WINDOW", "384"))
    w_back = int(env.get("BENCH_WBACK", "24"))
    rows = int(env.get("BENCH_PROJ", "-1"))
    if rows < 0:
        rows = ck.derive_proj_rows(gc["vehicle/target_velocity"], gc["delta_t"])
    cap = parse_caps(env.get("BENCH_CAP", "0")) or 0
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, batch, seed=0), dtype=dtype,
                         device=device)
    sc = st.device_scenario(tick=0, horizon=cfg.N, dtype=dtype, device=device, batch=batch)
    kw = dict(window=window, w_back=w_back, proj_rows_per_step=rows, straggler_cap=cap)
    if mode == "cold":
        def run():
            _, _, stats = ck.cilqr_solve_cuda(cfg, w, x0, sc, **kw)
            return stats.iters, stats.converged.float().mean()

        return run, batch, "cilqr_solves_per_sec"
    if env.get("BENCH_WARM", "1") == "1":
        cfg = dataclasses.replace(cfg, use_last_solution=True)
    ticks = int(env.get("BENCH_TICKS", "120"))
    chunk = int(env.get("BENCH_CHUNK", "10"))
    obs = st.obs_preds_array(np.float32)
    need = ticks + cfg.N + 1
    if obs.shape[1] < need:  # hold the last prediction
        obs = np.concatenate([obs, np.repeat(obs[:, -1:], need - obs.shape[1], axis=1)], 1)
    obs_b = torch.as_tensor(obs, device=device).expand(batch, *obs.shape)
    args = (cfg, w, x0, sc.ref_line, sc.ref_velo, obs_b, sc.road_borders, ticks)
    kw["straggler_cap_warm"] = parse_caps(env.get("BENCH_CAP_WARM", ""))

    def run():
        if ticks > SCAN_TICKS:
            ego, _, stats = run_mpc_kernel_chunked(*args, chunk=chunk, **kw)
        else:
            ego, _, stats = run_mpc_kernel_scan(*args, **kw)
        return stats.iters, ego[-1, :, 0].mean()

    return run, batch * ticks, "cilqr_mpc_solves_per_sec"


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if device.type != "cuda":
        return "cpu (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def measure(env=None):
    """Run the benchmark: (the result line's dict, the auxiliary fields)."""
    env = os.environ if env is None else env
    device = entry_device(env.get("BENCH_DEVICE", "cuda"))
    iters = int(env.get("BENCH_ITERS", "10"))
    run, solves, metric = build(env, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = run()  # warm-up: the build and the captures
    sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = run()
        sync()
        samples.append(time.perf_counter() - t0)
    rates = solves / np.asarray(samples)
    result = {"metric": metric, "value": float(solves / np.median(samples)),
              "unit": "solves/s", "min": float(rates.min()), "max": float(rates.max())}
    aux_name = "final_ego_x_mean" if metric == "cilqr_mpc_solves_per_sec" else "converged"
    aux = {"mean_iters": float(out[0].float().mean()), aux_name: float(out[1]),
           "median_run_s": float(np.median(samples)), "runs": iters,
           "card": card_line(device)}
    return result, aux


def main() -> int:
    result, aux = measure()
    print(json.dumps(result), flush=True)
    print("# " + json.dumps(aux), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
