#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ilqr_tpu_torch``) on one GPU.

Builds the fused CILQR kernel from this checkout's sources, holds it against
its plain PyTorch version, and drives the port's main path through it:
120-tick receding-horizon episodes of ``configs/scenario_two_straight.yaml``
at batch 8192 (perturbed starts, seed 0), float32, with the shifted-u warm
start between ticks.

    python3 chip_smoke.py          # from the repository root, one CUDA GPU

Phases, one printed line each; any failure raises, so the script exits
non-zero and prints no final line:

0. environment: torch / CUDA versions, the card's name and power limit,
   nvcc and triton presence, the kernel build time and its ptxas summary;
1. float64 semantics: the double kernel against ``cilqr_solve_ref`` in
   double on the card, cold solve, batch 256 -- iters and status equal on
   >= 99% of rows, u and x within 1e-6 on those rows;
2. float32 against the float64 truth (``tools/f64_anchors.json``), batch
   1024, the gate of ``tools/validate_kernel_tpu.py``: convergence
   fraction and per-row status agreement with the float64 anchor at least
   as good as the plain float32 version's, solution agreement on rows
   converged in both (cost p90 < 1e-3, position p90 < 5e-2 m), and two
   kernel runs bitwise equal;
2b. the same comparison at the main path's shape (batch 8192, first tick);
3. the main path: ``run_mpc_kernel``, batch 8192, 120 ticks; one kernel
   launch per tick, finite outputs, and the float64-confirmed
   car-following equilibrium (mean final ego x 52.70 m, within 0.05 m).

The last two lines are a JSON object describing the kernel and
``{"ok": true, "device": {...}}``.
"""

import importlib.util
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "scenario_two_straight.yaml"
ANCHORS = REPO / "tools" / "f64_anchors.json"
KERNEL_SOURCE = "ilqr_tpu_torch/csrc/cilqr_kernel.cu"
REPLACES = "ilqr_tpu/ops/pallas/cilqr_kernel.py:166"
WINDOW = 384  # reference-line window rows (the JAX bench's default)
W_BACK = 24  # window rows behind the initial projection (ditto)
BATCH = 8192
TICKS = 120
EGO_X_ANCHOR = 52.70  # float64 car-following equilibrium, metres
EGO_X_TOL = 0.05
DEVICE = "cuda"


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def say(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def setup(dtype, batch, warm=False):
    import torch
    from ilqr_tpu_torch.config import GlobalConfig
    from ilqr_tpu_torch.ops.cuda.cilqr_kernel import derive_proj_rows
    from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
    from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

    gc = GlobalConfig.from_file(str(CONFIG))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, use_last_solution=warm)
    w = CILQRWeights.from_global_config(gc, dtype=dtype, device=DEVICE)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, batch, seed=0), dtype=dtype,
                         device=DEVICE)
    rows = derive_proj_rows(gc["vehicle/target_velocity"], gc["delta_t"])
    return st, cfg, w, x0, rows


def packed_cold(dtype, batch):
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    st, cfg, w, x0, rows = setup(dtype, batch)
    scenario = st.device_scenario(tick=0, dtype=dtype, device=DEVICE, batch=batch)
    return cfg, w, ck.pack_problem(cfg, x0, scenario, WINDOW, None, W_BACK, rows)


def time_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_env():
    import torch

    check(torch.cuda.is_available(), "no CUDA device (torch.cuda.is_available() is false)")
    import ilqr_tpu_torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    check(Path(ilqr_tpu_torch.__file__).resolve().is_relative_to(REPO),
          f"ilqr_tpu_torch imported from outside this checkout: {ilqr_tpu_torch.__file__}")
    line = gpu_line()
    print(line, flush=True)
    t0 = time.perf_counter()
    _, log = ck.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [s.strip() for s in log.splitlines()
             if "registers" in s or "stack frame" in s or "spill" in s]
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=line, nvcc=shutil.which("nvcc") or ck._nvcc(),
        triton=importlib.util.find_spec("triton") is not None,
        build_seconds=round(build_s, 3), ptxas=ptxas)
    return line


def phase_semantics_f64(batch=256):
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    cfg, w, p = packed_cold(torch.float64, batch)
    uk, xk, sk = ck.cilqr_solve_kernel(cfg, w, p)
    torch.cuda.synchronize()
    ur, xr, sr = ck.cilqr_solve_ref(cfg, w, p)
    same = (sk[0] == sr[0]) & (sk[1] == sr[1])
    n_same = int(same.sum())
    check(n_same >= 0.99 * batch, f"f64 iters/status agree on {n_same}/{batch} rows")
    err_u = float((uk - ur).abs()[:, :, same].max())
    err_x = float((xk - xr).abs()[:, :, same].max())
    err = max(err_u, err_x)
    say("phase1_f64", batch=batch, iters_status_equal=n_same, rows=batch,
        max_abs_err_u=err_u, max_abs_err_x=err_x, tol=1e-6)
    check(err <= 1e-6, f"f64 kernel vs plain max abs err {err:.3e} > 1e-6")
    return err


def _agreement(sk, xk, sr, xr):
    """Convergence and solution agreement of two float32 builds: rows
    converged in both, cost relative error p90, position p90."""
    conv_k = (sk[2] > 0.5).cpu().numpy()
    conv_r = (sr[2] > 0.5).cpu().numpy()
    both = conv_k & conv_r
    cost_k, cost_r = sk[4].cpu().numpy(), sr[4].cpu().numpy()
    rel = np.abs(cost_k - cost_r) / np.maximum(np.abs(cost_r), 1e-3)
    pos = np.abs(xk[:2].cpu().numpy() - xr[:2].cpu().numpy())[:, :, both]
    cost_p90 = float(np.percentile(rel[both], 90)) if both.any() else float("inf")
    pos_p90 = float(np.percentile(pos, 90)) if both.any() else float("inf")
    return conv_k, conv_r, cost_p90, pos_p90


def phase_f32_anchor(batch=1024):
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    anchor = json.loads(ANCHORS.read_text())["scenario_two_straight"]
    check(int(anchor["batch"]) == batch and int(anchor["seed"]) == 0, "anchor batch/seed")
    f64_rows = np.array([int(c) for c in anchor["status_rows"]])
    conv_f64 = float(anchor["conv"])
    cfg, w, p = packed_cold(torch.float32, batch)
    ms_k, (uk, xk, sk) = time_ms(lambda: ck.cilqr_solve_kernel(cfg, w, p), reps=3)
    uk2, xk2, sk2 = ck.cilqr_solve_kernel(cfg, w, p)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(uk, uk2) and torch.equal(xk, xk2) and torch.equal(sk, sk2))
    t0 = time.perf_counter()
    ur, xr, sr = ck.cilqr_solve_ref(cfg, w, p)
    torch.cuda.synchronize()
    ms_r = (time.perf_counter() - t0) * 1e3
    conv_k, conv_r, cost_p90, pos_p90 = _agreement(sk, xk, sr, xr)
    stat_k, stat_r = sk[1].cpu().numpy().astype(int), sr[1].cpu().numpy().astype(int)
    agree_k = float(np.mean(stat_k == f64_rows))
    agree_r = float(np.mean(stat_r == f64_rows))
    gap_k = abs(float(conv_k.mean()) - conv_f64)
    gap_r = abs(float(conv_r.mean()) - conv_f64)
    say("phase2_f32_anchor", batch=batch, conv_f64=conv_f64, conv_kernel=float(conv_k.mean()),
        conv_plain=float(conv_r.mean()), agree_f64_kernel=agree_k, agree_f64_plain=agree_r,
        cost_relerr_p90=cost_p90, pos_absdiff_p90=pos_p90, bitwise_repeat=bitwise,
        mean_iters_kernel=float(sk[0].mean()), mean_iters_plain=float(sr[0].mean()),
        kernel_ms=ms_k, plain_ms=ms_r)
    check(gap_k <= max(0.03, gap_r), f"conv gap to f64 {gap_k:.4f} > max(0.03, {gap_r:.4f})")
    check(agree_k >= agree_r - 0.01, f"f64 status agreement {agree_k:.4f} < {agree_r:.4f}-0.01")
    check(cost_p90 < 1e-3, f"cost relerr p90 {cost_p90:.3e} >= 1e-3")
    check(pos_p90 < 5e-2, f"position p90 {pos_p90:.3e} >= 5e-2 m")
    check(bitwise, "two kernel runs differ")
    return ms_k, ms_r


def phase_f32_main_shape(batch=BATCH):
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    cfg, w, p = packed_cold(torch.float32, batch)
    ms_k, (uk, xk, sk) = time_ms(lambda: ck.cilqr_solve_kernel(cfg, w, p), reps=3)
    t0 = time.perf_counter()
    ur, xr, sr = ck.cilqr_solve_ref(cfg, w, p)
    torch.cuda.synchronize()
    ms_r = (time.perf_counter() - t0) * 1e3
    conv_k, conv_r, cost_p90, pos_p90 = _agreement(sk, xk, sr, xr)
    gap = abs(float(conv_k.mean()) - float(conv_r.mean()))
    say("phase2b_f32_main_shape", batch=batch, conv_kernel=float(conv_k.mean()),
        conv_plain=float(conv_r.mean()), cost_relerr_p90=cost_p90, pos_absdiff_p90=pos_p90,
        kernel_ms=ms_k, plain_ms=ms_r)
    check(gap <= 0.03, f"conv fraction kernel vs plain differs by {gap:.4f} > 0.03")
    check(cost_p90 < 1e-3, f"cost relerr p90 {cost_p90:.3e} >= 1e-3")
    check(pos_p90 < 5e-2, f"position p90 {pos_p90:.3e} >= 5e-2 m")
    return ms_k, ms_r


def phase_main_path(card, batch=BATCH, ticks=TICKS):
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.sim.mpc import run_mpc_kernel

    st, cfg, w, x0, rows = setup(torch.float32, batch, warm=True)
    sc = st.device_scenario(tick=0, dtype=torch.float32, device=DEVICE, batch=batch)
    obs = torch.as_tensor(st.obs_preds_array(np.float32), device=DEVICE)
    check(obs.shape[1] >= ticks + cfg.N + 1, "obstacle predictions shorter than the episode")
    obs_b = obs.expand(batch, *obs.shape)
    torch.cuda.synchronize()
    ck.launches = 0
    t0 = time.perf_counter()
    ego, us, stats = run_mpc_kernel(cfg, w, x0, sc.ref_line, sc.ref_velo, obs_b,
                                    sc.road_borders, ticks, window=WINDOW,
                                    proj_rows_per_step=rows, w_back=W_BACK)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ck.launches
    final_x = float(ego[-1, :, 0].mean())
    say("phase3_main_path", card=card, batch=batch, ticks=ticks, total_s=total,
        ms_per_tick=total / ticks * 1e3, solves_per_s=batch * ticks / total,
        mean_iters=float(stats.iters.float().mean()), final_ego_x_mean=final_x,
        conv_frac=float(stats.converged.float().mean()), launches=launches)
    check(launches == ticks, f"{launches} kernel launches in {ticks} ticks")
    check(tuple(ego.shape) == (ticks + 1, batch, 4), f"ego shape {tuple(ego.shape)}")
    check(tuple(us.shape) == (ticks, batch, cfg.N, 2), f"u shape {tuple(us.shape)}")
    check(bool(torch.isfinite(ego).all() and torch.isfinite(us).all()), "non-finite episode")
    check(abs(final_x - EGO_X_ANCHOR) <= EGO_X_TOL,
          f"final_ego_x_mean {final_x:.4f} not within {EGO_X_TOL} of {EGO_X_ANCHOR}")
    return launches


def main():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = phase_env()
    err = phase_semantics_f64()
    phase_f32_anchor()
    ms_k, ms_r = phase_f32_main_shape()
    launches = phase_main_path(card)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "cilqr_solve", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": err,
        "ms": ms_k, "plain_ms": ms_r}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
