"""Four-scenario validation of the fused CUDA solve against float64 anchors.

Counterpart of ``tools/validate_kernel_tpu.py``. For each shipped scenario:
a cold float32 solve of 1024 perturbed starts (seed 0) with the config's
own penalty family and reference point, window 384, w_back 24 and the
derived per-step search bound, in the modes the card resolves
(``ck.resolve_modes``: the dot-form projection and chunks of 4 unless the
``ILQR_*`` variables or ``--no-proj-dot`` say otherwise, so a plain run
validates the shipped configuration); the kernel and the plain float32
version run on the same packed inputs in those modes, and both are held
to the per-row float64 exit statuses of ``tools/f64_anchors.json``. The
gate:

- convergence fraction within max(0.03, the plain version's gap) of the
  anchor's;
- per-row status agreement with the anchor at least the plain version's
  minus 0.01;
- on rows converged in both builds, final-cost relative error p90 < 1e-3
  and position p90 < 5e-2 m;
- two kernel runs bitwise equal.

Usage, on a machine with one CUDA GPU:

    python -m ilqr_tpu_torch.apps.validate_kernel [--scenarios NAME ...] [--no-proj-dot]

prints one JSON line per scenario and exits 1 if any fails. The cold
problems (``problem``, ``packed_cold``) and the float64 case table of the
kernel's instantiations (``CASES``) serve ``chip_smoke.py`` and the GPU
tests too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights, entry_device

REPO = Path(__file__).resolve().parents[2]
ANCHORS = REPO / "tools" / "f64_anchors.json"
SCENARIOS = ("scenario_two_straight", "scenario_two_borrow", "scenario_three_straight",
             "scenario_three_bend")
WINDOW = 384
W_BACK = 24


# float64 cases holding each kernel instantiation to its plain version:
# instantiation -> (scenario, config overrides, weight overrides)
CASES = {
    "rear_barrier": ("scenario_two_straight", {}, {}),
    "gravity_barrier": ("scenario_two_borrow", {}, {}),
    "rear_alm": ("scenario_two_straight", {"solve_type": "alm"}, {}),
    "gravity_alm": ("scenario_two_borrow", {"solve_type": "alm"}, {}),
    # line searches exhaust: mu moves and rho grows on most rows
    "gravity_alm_duals_move": ("scenario_three_bend", {"solve_type": "alm"},
                               dict(alm_gamma=0.3, max_rho=40.0)),
    # 8 agents at the published weights, the most of the shipped
    # scenarios: C = 24 constraint columns
    "three_straight_barrier": ("scenario_three_straight", {}, {}),
}


def problem(name: str, batch: int, dtype=torch.float32, device="cuda", weights=None,
            **cfg_overrides):
    """(scenario setup, cfg, weights, x0 (batch, 4), per-step search bound)
    of ``batch`` perturbed starts (seed 0) of a shipped scenario;
    ``weights`` and ``cfg_overrides`` override the yaml's values."""
    gc = GlobalConfig.from_file(str(REPO / "configs" / f"{name}.yaml"))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, **cfg_overrides)
    w = CILQRWeights.from_global_config(gc, dtype=dtype, device=device, **(weights or {}))
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, batch, seed=0), dtype=dtype,
                         device=device)
    rows = ck.derive_proj_rows(gc["vehicle/target_velocity"], gc["delta_t"])
    return st, cfg, w, x0, rows


def packed_cold(name: str, batch: int, dtype=torch.float32, device="cuda", weights=None,
                modes=None, **cfg_overrides):
    """(cfg, weights, PackedProblem) of a cold solve of ``problem``'s
    starts on the first tick's validation window, in ``modes`` (None: the
    device's resolved modes, ``ck.resolve_modes``)."""
    st, cfg, w, x0, rows = problem(name, batch, dtype, device, weights,
                                   **{**cfg_overrides, "use_last_solution": False})
    scenario = st.device_scenario(tick=0, dtype=dtype, device=device, batch=batch)
    modes = ck.resolve_modes(device) if modes is None else modes
    return cfg, w, ck.pack_problem(cfg, x0, scenario, WINDOW, None, W_BACK, rows, modes=modes)


def time_ms(fn, reps: int):
    """Mean milliseconds per call over ``reps`` calls after one warm-up
    (CUDA events), and the last call's result."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def agreement(k: ck.PackedSolution, r: ck.PackedSolution):
    """Rows converged in each build, and on rows converged in both the p90
    of the final-cost relative error and of the position difference."""
    conv_k = (k.stats[2] > 0.5).cpu().numpy()
    conv_r = (r.stats[2] > 0.5).cpu().numpy()
    both = conv_k & conv_r
    cost_k, cost_r = k.stats[4].cpu().numpy(), r.stats[4].cpu().numpy()
    rel = np.abs(cost_k - cost_r) / np.maximum(np.abs(cost_r), 1e-3)
    pos = np.abs(k.x[:2].cpu().numpy() - r.x[:2].cpu().numpy())[:, :, both]
    cost_p90 = float(np.percentile(rel[both], 90)) if both.any() else float("inf")
    pos_p90 = float(np.percentile(pos, 90)) if both.any() else float("inf")
    return conv_k, conv_r, cost_p90, pos_p90


def validate(name: str, proj_dot=None) -> dict:
    """Run and gate one scenario at its anchors' batch, with ``proj_dot``
    and the other modes as the card resolves them; the result's
    ``failures`` lists what failed (empty when it passes)."""
    anchor = json.loads(ANCHORS.read_text())[name]
    if int(anchor["seed"]) != 0:
        raise ValueError(f"{name}: anchors are for seed {anchor['seed']}, not 0")
    batch = int(anchor["batch"])
    f64_rows = np.array([int(c) for c in anchor["status_rows"]])
    conv_f64 = float(anchor["conv"])
    cfg, w, p = packed_cold(name, batch, modes=ck.resolve_modes("cuda", proj_dot))
    kernel_ms, k = time_ms(lambda: ck.cilqr_solve_kernel(cfg, w, p), reps=3)
    k2 = ck.cilqr_solve_kernel(cfg, w, p)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(k[:3], k2[:3]))
    t0 = time.perf_counter()
    r = ck.cilqr_solve_ref(cfg, w, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    conv_k, conv_r, cost_p90, pos_p90 = agreement(k, r)
    stat_k = k.stats[1].cpu().numpy().astype(int)
    stat_r = r.stats[1].cpu().numpy().astype(int)
    agree_k = float(np.mean(stat_k == f64_rows))
    agree_r = float(np.mean(stat_r == f64_rows))
    gap_k = abs(float(conv_k.mean()) - conv_f64)
    gap_r = abs(float(conv_r.mean()) - conv_f64)
    failures = []
    if gap_k > max(0.03, gap_r):
        failures.append(f"conv gap to f64 {gap_k:.4f} > max(0.03, {gap_r:.4f})")
    if agree_k < agree_r - 0.01:
        failures.append(f"f64 status agreement {agree_k:.4f} < {agree_r:.4f}-0.01")
    if not cost_p90 < 1e-3:
        failures.append(f"cost relerr p90 {cost_p90:.3e} >= 1e-3")
    if not pos_p90 < 5e-2:
        failures.append(f"position p90 {pos_p90:.3e} >= 5e-2 m")
    if not bitwise:
        failures.append("two kernel runs differ")
    return dict(
        scenario=name, variant=ck.variant(cfg, torch.float32, p.modes), batch=batch,
        conv_f64=conv_f64, conv_kernel=float(conv_k.mean()), conv_plain=float(conv_r.mean()),
        agree_f64_kernel=agree_k, agree_f64_plain=agree_r, cost_relerr_p90=cost_p90,
        pos_absdiff_p90=pos_p90, bitwise_repeat=bitwise,
        mean_iters_kernel=float(k.stats[0].mean()), mean_iters_plain=float(r.stats[0].mean()),
        kernel_ms=kernel_ms, plain_ms=plain_ms, failures=failures)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenarios", nargs="+", default=list(SCENARIOS),
                        choices=SCENARIOS)
    parser.add_argument("--proj-dot", action=argparse.BooleanOptionalAction, default=None,
                        help="dot-form projection on or off (default: ILQR_PROJ_DOT, else on)")
    args = parser.parse_args(argv)
    entry_device("cuda")
    ok = True
    for name in args.scenarios:
        res = validate(name, args.proj_dot)
        ok = ok and not res["failures"]
        print(json.dumps({"pass": not res["failures"], **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
