#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ilqr_tpu_torch``) on one GPU.

Builds the fused CILQR kernel (every instantiation: float32/float64 x rear/
gravity center x barrier/ALM) from this checkout's sources, holds it
against its plain PyTorch version, and drives the port's paths through it
with ``run_mpc_kernel``, float32, batch 8192 perturbed starts (seed 0):

- the main path: 120-tick episodes of ``configs/scenario_two_straight.yaml``
  (rear center, barrier) with the shifted-u warm start;
- path (a): 150-tick episodes of ``configs/scenario_three_bend.yaml``
  (gravity center, barrier, cold ticks as the yaml sets it);
- path (b): 150-tick ALM episodes of ``configs/scenario_two_borrow.yaml``
  (gravity center, rho_init 20) with the warm start and the duals carried
  across ticks (they stay at the cold reset there: no line search
  exhausts);
- path (b2): ALM episodes of ``configs/scenario_three_bend.yaml`` with
  gamma 0.3 and max_rho 40, warm, duals carried: line searches exhaust, so
  mu moves and rho grows, in float32 at full batch. Cut to 50 ticks.

    python3 chip_smoke.py          # from the repository root, one CUDA GPU

Phases, one printed line each; any failure raises, so the script exits
non-zero and prints no final line:

0. environment: torch / CUDA versions, the card's name and power limit,
   nvcc and triton presence, the kernel build time and each
   instantiation's registers, stack and spills from ptxas;
1. float64 semantics: each double instantiation against
   ``cilqr_solve_ref`` in double on the card, cold solve, batch 256 --
   iters and status equal on >= 99% of rows, u, x (and the duals) within
   1e-6 on those rows: rear/barrier (two_straight), gravity/barrier
   (two_borrow), rear/ALM (two_straight), gravity/ALM (two_borrow), and
   gravity/ALM with moving duals (three_bend, its rho_init 20 and max_mu
   100 with gamma 0.3 and max_rho 40: line searches exhaust, mu moves and
   rho grows on most rows);
2. float32 against the float64 truth (``tools/f64_anchors.json``), batch
   1024, all four scenarios through ``ilqr_tpu_torch.apps.validate_kernel``
   (the gate of ``tools/validate_kernel_tpu.py``): convergence fraction and
   per-row status agreement with the float64 anchor at least as good as
   the plain float32 version's, solution agreement on rows converged in
   both (cost p90 < 1e-3, position p90 < 5e-2 m), two kernel runs bitwise
   equal;
2b. the same comparison with the plain version at each path's shape
   (batch 8192, first tick, cold), in ALM mode with the final duals too
   (rho equal on >= 99% of the rows of equal iterations and statuses, and
   the p90 over those rows of each row's largest mu difference < 1e-2):
   the float32 kernels' times;
3. the main path: one kernel launch per tick, finite outputs, and the
   float64-confirmed car-following equilibrium (mean final ego x 52.70 m,
   within 0.05 m);
4. paths (a), (b) and (b2): one launch per tick, finite outputs and
   duals, and on (b2) duals that moved;
5. float64 episodes, batch 256, 5 warm ticks, ``run_mpc_kernel`` against
   the same episodes written out over the plain version on the card:
   per-tick iterations and statuses equal on >= 99% of rows, trajectories
   and final duals within 1e-6 on them -- each double instantiation, the
   ALM ones with the duals carried across ticks (also the phase 1
   three_bend case, whose duals move).

The last three lines are the card's name and power limit, a JSON object
describing each kernel instantiation that ran, and
``{"ok": true, "device": {...}}``.
"""

import collections
import importlib.util
import json
import re
import shutil
import subprocess
import time
from pathlib import Path


REPO = Path(__file__).resolve().parent
KERNEL_SOURCE = "ilqr_tpu_torch/csrc/cilqr_kernel.cu"
REPLACES = "ilqr_tpu/ops/pallas/cilqr_kernel.py:166"
BATCH = 8192
TICKS = 120
EGO_X_ANCHOR = 52.70  # float64 car-following equilibrium, metres
EGO_X_TOL = 0.05
DEVICE = "cuda"
# card peaks for the bounds (NVIDIA H100 SXM data sheet): vector float32
# and float64 operations per second, device-memory bytes per second
PEAK_OPS = {"f32": 67e12, "f64": 34e12}
PEAK_BYTES = 3.35e12

# the weights under which three_bend's line searches exhaust in ALM mode:
# mu moves and rho grows (ilqr_tpu_torch.apps.validate_kernel.CASES)
DUALS_MOVE = dict(alm_gamma=0.3, max_rho=40.0)
# float32 paths: name -> (scenario, config and weight overrides, ticks)
PATHS = {
    "main": ("scenario_two_straight", {"use_last_solution": True}, TICKS),
    "a_three_bend": ("scenario_three_bend", {}, 150),
    "b_alm_two_borrow": ("scenario_two_borrow", {"solve_type": "alm",
                                                 "use_last_solution": True}, 150),
    # 150 ticks cut to 50 (about 0.7 s a tick; batch and N as shipped)
    "b2_alm_duals_move": ("scenario_three_bend", {"solve_type": "alm", "use_last_solution": True,
                                                  "weights": DUALS_MOVE}, 50),
}
FULL_TICKS = {"b2_alm_duals_move": 150}  # a path's episode length before its cut
DUALS_MOVE_PATHS = ("b2_alm_duals_move",)  # paths that fail unless their duals move
# phase 5: float64 episodes (scenario, config overrides), warm, duals carried
EPISODES_F64 = {
    "rear_barrier": ("scenario_two_straight", {"use_last_solution": True}),
    "gravity_barrier": ("scenario_two_borrow", {"use_last_solution": True}),
    "rear_alm": ("scenario_two_straight", {"solve_type": "alm", "use_last_solution": True}),
    "gravity_alm": ("scenario_two_borrow", {"solve_type": "alm", "use_last_solution": True}),
    # duals that move, carried across ticks (the phase 1 case, warm)
    "gravity_alm_duals_move": ("scenario_three_bend", {
        "solve_type": "alm", "use_last_solution": True,
        "weights": DUALS_MOVE}),
}
EPISODE_F64_BATCH = 256
EPISODE_F64_TICKS = 5

# Operations per unit of the kernel's work, counted from csrc/cilqr_kernel.cu:
# each add, multiply, divide, compare and transcendental is one operation,
# and a branch counts its cheaper side. Per horizon step unless noted.
OPS = dict(
    prop_rear=15, prop_gravity=29,    # propagate
    feedback=24,                      # forward: u + K (x' - x) + alpha d
    row=6,                            # one window row of a projection scan
    cost_track=15,                    # total_cost: tracking, steps 0..N
    cost_ctrl=30,                     # control cost and 4 penalties, 0..N-1
    cost_state=41,                    # velocity/border penalties, lateral, discs, 1..N
    cost_obs=44,                      # per obstacle: two ellipse penalties, 1..N
    deriv_base=16, deriv_ctrl=46, deriv_state=75, deriv_obs=126,  # step_derivs
    riccati_rear=432, riccati_gravity=502,                        # backward, per step
    dual_col=4,                       # one dual step, per column and step
)


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


def ptxas_summary(log):
    """{instantiation: registers, stack and spill bytes} from nvcc -Xptxas -v."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            m = re.search(r"cilqr_solve_kernelI([fd])Lb([01])ELb([01])E", line)
            cur = None if m is None else "cilqr_solve_{}_{}_{}".format(
                "f32" if m[1] == "f" else "f64", ("rear", "gravity")[int(m[2])],
                ("barrier", "alm")[int(m[3])])
            if cur:
                out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if cur and m:
            out[cur].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            out[cur]["registers"] = int(m[1])
    return out


def bound(cfg, dtype, shape, work):
    """(bound_ms, bound_by): the least time the card could take for the
    work these inputs needed -- each input read and each output written
    once over the memory rate, against the operations (``OPS``) of this
    run's iterations, line-search trials and dual updates over the peak
    rate of the type."""
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    B, N, M, W = shape["B"], shape["N"], shape["M"], shape["W"]
    dt, gravity, alm = ck.instantiation(cfg, dtype)
    size = 4 if dt == "f32" else 8
    C = 8 + 2 * M
    o = OPS
    prop = o["prop_gravity"] if gravity else o["prop_rear"]
    cost = (N + 1) * o["cost_track"] + N * (o["cost_ctrl"] + o["cost_state"] + M * o["cost_obs"])
    deriv = (N + 1) * o["deriv_base"] + N * (o["deriv_ctrl"] + o["deriv_state"]
                                             + M * o["deriv_obs"])
    riccati = o["riccati_gravity"] if gravity else o["riccati_rear"]
    proj = o["row"] * sum(shape["row_limits"])
    init = N * prop + proj + cost
    trial = N * (o["feedback"] + prop) + proj + cost
    ops = (B * init + work["iters"] * (deriv + N * riccati) + work["trials"] * trial
           + work["dual_updates"] * (2 * cost + C * N * o["dual_col"]))
    elems = (8 + 2 * N + 3 * W + 3 * M * (N + 1)) + (2 * N + 4 * (N + 1) + 6)
    if alm:
        elems += 2 * (C * N + 1)
    t_ops = ops / PEAK_OPS[dt] * 1e3
    t_bytes = elems * B * size / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def shape_of(cfg, p):
    return dict(B=p.x0.shape[1], N=cfg.N, M=p.ox.shape[0], W=p.rx.shape[0],
                row_limits=list(p.row_limits))


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
    ptxas = ptxas_summary(log)
    check(len(ptxas) == 8 and all(len(v) == 4 for v in ptxas.values()),
          f"ptxas summary incomplete: {ptxas}")
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=line, nvcc=shutil.which("nvcc") or ck._nvcc(),
        triton=importlib.util.find_spec("triton") is not None,
        build_seconds=round(build_s, 3), ptxas=ptxas)
    return line, ptxas


def phase_semantics_f64(case, batch=256):
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    name, over, wover = vk.CASES[case]
    cfg, w, p = vk.packed_cold(name, batch, torch.float64, weights=wover, **over)
    ms_k, k = vk.time_ms(lambda: ck.cilqr_solve_kernel(cfg, w, p), reps=1)
    work = {}
    t0 = time.perf_counter()
    r = ck.cilqr_solve_ref(cfg, w, p, work=work)
    torch.cuda.synchronize()
    ms_r = (time.perf_counter() - t0) * 1e3
    same = (k.stats[0] == r.stats[0]) & (k.stats[1] == r.stats[1])
    n_same = int(same.sum())
    errs = {"u": float((k.u - r.u).abs()[:, :, same].max()),
            "x": float((k.x - r.x).abs()[:, :, same].max())}
    if cfg.solve_type == "alm":
        errs["mu"] = float((k.mu - r.mu).abs()[:, :, same].max())
        errs["rho"] = float((k.rho - r.rho).abs()[same].max())
    err = max(errs.values())
    fields = dict(variant=ck.variant(cfg, torch.float64), scenario=name, batch=batch,
                  iters_status_equal=n_same, rows=batch,
                  **{f"max_abs_err_{key}": v for key, v in errs.items()}, tol=1e-6,
                  kernel_ms=ms_k, plain_ms=ms_r, plain_work=work,
                  mean_iters=float(r.stats[0].mean()))
    if cfg.solve_type == "alm":
        fields.update(dual_rows_moved=int((r.mu.flatten(0, 1) > 0).any(0).sum()),
                      rho_max=float(r.rho.max()))
    say("phase1_f64" if case == "rear_barrier" else f"phase1_f64_{case}", **fields)
    check(n_same >= 0.99 * batch, f"{case}: f64 iters/status agree on {n_same}/{batch} rows")
    check(err <= 1e-6, f"{case}: f64 kernel vs plain max abs err {err:.3e} > 1e-6")
    if case == "gravity_alm_duals_move":
        check(fields["dual_rows_moved"] > 0 and fields["rho_max"] > 20.0,
              "the duals did not move")
    work["iters"] = int(r.stats[0].sum())
    return dict(variant=fields["variant"], cfg=cfg, dtype=torch.float64, err=err, ms=ms_k,
                plain_ms=ms_r, work=work, shape=shape_of(cfg, p))


def phase_f32_anchor():
    from ilqr_tpu_torch.apps import validate_kernel as vk

    for name in vk.SCENARIOS:
        res = vk.validate(name)
        failures = res.pop("failures")
        say("phase2_f32_anchor", **res)
        check(not failures, f"{name}: " + "; ".join(failures))


def phase_f32_path_shape(path, batch=BATCH):
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    name, over, _ = PATHS[path]
    over = dict(over)
    wover = over.pop("weights", None)
    cfg, w, p = vk.packed_cold(name, batch, weights=wover, **over)
    ms_k, k = vk.time_ms(lambda: ck.cilqr_solve_kernel(cfg, w, p), reps=3)
    work = {}
    t0 = time.perf_counter()
    r = ck.cilqr_solve_ref(cfg, w, p, work=work)
    torch.cuda.synchronize()
    ms_r = (time.perf_counter() - t0) * 1e3
    conv_k, conv_r, cost_p90, pos_p90 = vk.agreement(k, r)
    gap = abs(float(conv_k.mean()) - float(conv_r.mean()))
    same = (k.stats[0] == r.stats[0]) & (k.stats[1] == r.stats[1])
    errs = {"x": float((k.x - r.x).abs()[:, :, same].max())}
    duals = {}
    if cfg.solve_type == "alm":
        dmu = (k.mu - r.mu).abs()[:, :, same].flatten(0, 1).amax(0)  # each row's largest
        rho_equal = float((k.rho == r.rho)[same].float().mean())
        errs.update(mu=float(dmu.max()), rho=float((k.rho - r.rho).abs()[same].max()))
        duals = dict(mu_absdiff_p90=float(torch.quantile(dmu.double(), 0.9)),
                     rho_equal_frac=rho_equal,
                     dual_rows_moved=int(((r.mu.flatten(0, 1) > 0).any(0)
                                          | (r.rho > w.alm_rho_init)).sum()),
                     rho_max=float(r.rho.max()))
    err = max(errs.values())
    say("phase2b_f32_main_shape" if path == "main" else f"phase2b_f32_{path}",
        variant=ck.variant(cfg, torch.float32), scenario=name, batch=batch,
        conv_kernel=float(conv_k.mean()), conv_plain=float(conv_r.mean()),
        cost_relerr_p90=cost_p90, pos_absdiff_p90=pos_p90,
        iters_status_equal=int(same.sum()),
        **{f"max_abs_err_{key}_on_equal_rows": v for key, v in errs.items()}, **duals,
        kernel_ms=ms_k, plain_ms=ms_r, plain_work=work)
    check(gap <= 0.03, f"{path}: conv fraction kernel vs plain differs by {gap:.4f} > 0.03")
    check(cost_p90 < 1e-3, f"{path}: cost relerr p90 {cost_p90:.3e} >= 1e-3")
    check(pos_p90 < 5e-2, f"{path}: position p90 {pos_p90:.3e} >= 5e-2 m")
    if duals:
        check(duals["rho_equal_frac"] >= 0.99,
              f"{path}: rho equal on {duals['rho_equal_frac']:.4f} of equal rows < 0.99")
        check(duals["mu_absdiff_p90"] < 1e-2,
              f"{path}: mu abs diff p90 {duals['mu_absdiff_p90']:.3e} >= 1e-2")
    if path in DUALS_MOVE_PATHS:
        check(duals["dual_rows_moved"] > 0 and duals["rho_max"] > float(w.alm_rho_init),
              f"{path}: the duals did not move")
    work["iters"] = int(r.stats[0].sum())
    return dict(variant=ck.variant(cfg, torch.float32), cfg=cfg, dtype=torch.float32, err=err,
                ms=ms_k, plain_ms=ms_r, work=work, shape=shape_of(cfg, p))


def run_path(name, over, dtype, batch, ticks):
    """One batch of episodes through ``run_mpc_kernel`` on the card, with the
    launch counts set to 0 just before and read just after. Also returns
    the episode's inputs."""
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.sim.mpc import run_mpc_kernel

    st, cfg, w, x0, rows = vk.problem(name, batch, dtype, DEVICE, **over)
    sc = st.device_scenario(tick=0, dtype=dtype, device=DEVICE, batch=batch)
    obs = torch.as_tensor(st.obs_preds_array(), device=DEVICE).to(dtype)
    check(obs.shape[1] >= ticks + cfg.N + 1, "obstacle predictions shorter than the episode")
    obs_b = obs.expand(batch, *obs.shape)
    torch.cuda.synchronize()
    ck.launches.clear()
    t0 = time.perf_counter()
    out = run_mpc_kernel(cfg, w, x0, sc.ref_line, sc.ref_velo, obs_b, sc.road_borders, ticks,
                         window=384, proj_rows_per_step=rows, w_back=24,
                         return_alm=cfg.solve_type == "alm")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return cfg, out, total, dict(ck.launches), (w, x0, sc, obs_b, rows)


def plain_episode(cfg, w, x0, sc, obs_b, rows, ticks):
    """The same episodes through the plain version on the card, written
    out independently of ``run_mpc_kernel``: each tick solves on the
    prediction window at that tick from the shifted previous controls and,
    in ALM mode, the previous duals (both only under use_last_solution),
    and applies the second planned state. Returns (ego, u, iters, status,
    final (mu, rho) or None)."""
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.types import Scenario

    warm, alm = cfg.use_last_solution, cfg.solve_type == "alm"
    ego, u_prev, duals = x0, None, (None, None)
    egos, us, iters, status = [ego], [], [], []
    for t in range(ticks):
        scenario = Scenario(ref_line=sc.ref_line, ref_velo=sc.ref_velo,
                            obs_preds=obs_b[:, :, t:t + cfg.N + 1],
                            road_borders=sc.road_borders)
        u_init = (torch.cat([u_prev[:, 1:], u_prev[:, -1:]], dim=1)
                  if warm and u_prev is not None else None)
        mu0, rho0 = duals if warm else (None, None)
        p = ck.pack_problem(cfg, ego, scenario, 384, u_init, 24, rows, mu0, rho0)
        r = ck.cilqr_solve_ref(cfg, w, p)
        u_prev = r.u.permute(2, 1, 0)
        ego = r.x[:, 1].T
        egos.append(ego)
        us.append(u_prev)
        iters.append(r.stats[0])
        status.append(r.stats[1])
        if alm:
            duals = (r.mu[:cfg.num_constraints].permute(2, 1, 0), r.rho)
    return (torch.stack(egos), torch.stack(us), torch.stack(iters), torch.stack(status),
            duals if alm else None)


def phase_path(path, card, batch=BATCH):
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    name, over, ticks = PATHS[path]
    cfg, out, total, launches, inputs = run_path(name, over, torch.float32, batch, ticks)
    ego, us, stats = out[:3]
    variant = ck.variant(cfg, torch.float32)
    final_x = float(ego[-1, :, 0].mean())
    fields = dict(card=card, scenario=name, variant=variant, batch=batch, ticks=ticks,
                  ticks_cut_from=FULL_TICKS.get(path, ticks), total_s=total,
                  ms_per_tick=total / ticks * 1e3,
                  solves_per_s=batch * ticks / total,
                  mean_iters=float(stats.iters.float().mean()), final_ego_x_mean=final_x,
                  conv_frac=float(stats.converged.float().mean()), launches=launches)
    finite = bool(torch.isfinite(ego).all() and torch.isfinite(us).all())
    if len(out) == 4:
        mu, rho = out[3]
        moved = (mu.flatten(1) > 0).any(1) | (rho > inputs[0].alm_rho_init)
        fields.update(mu_max=float(mu.max()), rho_mean=float(rho.mean()),
                      rho_max=float(rho.max()), dual_rows_moved=int(moved.sum()))
        finite = finite and bool(torch.isfinite(mu).all() and torch.isfinite(rho).all())
    say("phase3_main_path" if path == "main" else f"phase4_path_{path}", **fields)
    check(launches == {variant: ticks}, f"{path}: launches {launches} in {ticks} ticks")
    check(tuple(ego.shape) == (ticks + 1, batch, 4), f"{path}: ego shape {tuple(ego.shape)}")
    check(tuple(us.shape) == (ticks, batch, cfg.N, 2), f"{path}: u shape {tuple(us.shape)}")
    check(finite, f"{path}: non-finite episode")
    if path == "main":
        check(abs(final_x - EGO_X_ANCHOR) <= EGO_X_TOL,
              f"final_ego_x_mean {final_x:.4f} not within {EGO_X_TOL} of {EGO_X_ANCHOR}")
    if path in DUALS_MOVE_PATHS:
        check(fields["dual_rows_moved"] > 0, f"{path}: the duals did not move")
    return launches


def phase_episode_f64(case, batch=EPISODE_F64_BATCH, ticks=EPISODE_F64_TICKS):
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    name, over = EPISODES_F64[case]
    cfg, ko, k_s, launches, inputs = run_path(name, over, torch.float64, batch, ticks)
    t0 = time.perf_counter()
    ego_r, u_r, it_r, st_r, duals_r = plain_episode(cfg, *inputs, ticks)
    torch.cuda.synchronize()
    r_s = time.perf_counter() - t0
    variant = ck.variant(cfg, torch.float64)
    same = ((ko[2].iters == it_r) & (ko[2].status == st_r)).all(dim=0)
    n_same = int(same.sum())
    errs = {"ego": float((ko[0] - ego_r).abs()[:, same].max()),
            "u": float((ko[1] - u_r).abs()[:, same].max())}
    extra = {}
    if cfg.solve_type == "alm":
        errs["mu"] = float((ko[3][0] - duals_r[0]).abs()[same].max())
        errs["rho"] = float((ko[3][1] - duals_r[1]).abs()[same].max())
        extra = dict(mu_max=float(duals_r[0].max()), rho_max=float(duals_r[1].max()))
    err = max(errs.values())
    say(f"phase5_f64_episode_{case}", variant=variant, scenario=name, batch=batch,
        ticks=ticks, rows_iters_status_equal_every_tick=n_same,
        **{f"max_abs_err_{key}": v for key, v in errs.items()}, tol=1e-6,
        kernel_s=k_s, plain_s=r_s, launches=launches, **extra)
    check(launches == {variant: ticks}, f"{case}: launches {launches} in {ticks} ticks")
    check(n_same >= 0.99 * batch, f"{case}: per-tick iters equal on {n_same}/{batch} rows")
    check(err <= 1e-6, f"{case}: f64 episode max abs err {err:.3e} > 1e-6")
    return launches


def main():
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    card, ptxas = phase_env()
    f64 = [phase_semantics_f64(case) for case in vk.CASES]
    phase_f32_anchor()
    f32 = [phase_f32_path_shape(path) for path in PATHS]
    launches = collections.Counter()  # summed over the runs, each counted from 0
    for path in PATHS:
        launches.update(phase_path(path, card))
    for case in EPISODES_F64:
        launches.update(phase_episode_f64(case))
    # one entry per instantiation: its time on its first case's inputs,
    # its error the largest of its cases'
    measured = {}
    for res in f64 + f32:
        first = measured.setdefault(res["variant"], res)
        first["err"] = max(first["err"], res["err"])
    check(set(measured) == set(launches), f"{sorted(measured)} vs {sorted(launches)}")
    kernels = []
    for name, res in sorted(measured.items()):
        bound_ms, bound_by = bound(res["cfg"], res["dtype"], res["shape"], res["work"])
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": launches[name], "max_abs_err": res["err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "batch": res["shape"]["B"], **ptxas[name]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
