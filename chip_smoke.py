#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ilqr_tpu_torch``) on one GPU.

Builds the fused CILQR kernel (a warp per scenario; every instantiation:
float32/float64 x rear/gravity center x barrier/ALM, each with its resume
entry; the projection modes and the line search's chunk width are runtime
arguments), the thread-per-scenario kernel it replaced (for comparison
only) and the ``tools/debug`` repro kernels from this checkout's sources,
one nvcc per source, started together; holds every kernel against its
plain PyTorch version, and drives the port's paths through it with
``run_mpc_kernel`` (the host loop), the graph-captured episode program
(``run_mpc_kernel_chunked`` / ``run_mpc_kernel_scan``, phase 8) and the
sweep entry point with the parallel layer (``apps.sweep``, phase 9),
float32, batch 8192 perturbed starts (seed 0), in the modes the card
resolves (``ck.resolve_modes``: the dot-form projection and chunks of 4
alphas, as the JAX package ran its main path on its chip):

- the main path: 120-tick episodes of ``configs/scenario_two_straight.yaml``
  (rear center, barrier) with the shifted-u warm start; in four mode
  configurations (phase 6), once with the JAX bench's straggler schedule
  (8, 16, 32) on the first tick and (6, 12, 24) on warm ticks (bench.py:86,
  :95), bitwise equal to the run without, and once with the pair-fold
  projection on (``proj_fold``, the JAX package's ``ILQR_PROJ_FOLD=1``);
- path (a): episodes of ``configs/scenario_three_bend.yaml`` (gravity
  center, barrier, cold ticks as the yaml sets it), once without and once
  with the schedule (8, 16, 32) on every tick. Cut from 150 to 12 ticks;
- path (b): 150-tick ALM episodes of ``configs/scenario_two_borrow.yaml``
  (gravity center, rho_init 20) with the warm start and the duals carried
  across ticks (they stay at the cold reset there: no line search
  exhausts); no schedule;
- path (b2): ALM episodes of ``configs/scenario_three_bend.yaml`` with
  gamma 0.3 and max_rho 40, warm, duals carried: line searches exhaust, so
  mu moves and rho grows, in float32 at full batch, and the duals cross
  the resume; the bench's schedule. Cut from 150 to 20 ticks.

    python3 chip_smoke.py          # from the repository root, one CUDA GPU

Phases, one printed line each; any failure raises, so the script exits
non-zero and prints no final line:

0. environment: torch / CUDA versions, the card's name and power limit,
   nvcc and triton presence, the kernels' build time, each instantiation's
   registers, stack and spills from ptxas (the warp kernel's and the
   thread kernel's), and the main path's launch plan with its resident
   scenarios per SM;
1. float64 semantics, batch 256, cold: each double instantiation against
   ``cilqr_solve_ref`` in double on the card, in the same modes -- iters
   and status equal on >= 99% of rows, u, x (and the duals) within 1e-6
   on those rows, and the same gate against the thread kernel on the same
   inputs: rear/barrier (two_straight), gravity/barrier
   (two_borrow), rear/ALM (two_straight), gravity/ALM (two_borrow), each
   with the squared distance and the serial line search, and with the dot
   form, the fold and both (chunks of 4); gravity/ALM with moving duals
   (three_bend, its rho_init 20 and max_mu 100 with gamma 0.3 and max_rho
   40: line searches exhaust, mu moves and rho grows on most rows) with the
   squared distance. In every case chunks of 3, 4 and 8 bitwise equal to
   the serial kernel (dot form on), compaction at (8, 16, 32) and at
   (2, 5) in the card's modes, and at (2, 5) with the fold (alone, and
   with the dot form and chunks of 4), bitwise equal to one launch, and the resume
   entry in those modes against the resumed plain version (the kernel's
   solve capped at 2 iterations, resumed to 5) with the same gate;
2. float32 against the float64 truth (``tools/f64_anchors.json``), batch
   1024, all four scenarios through ``ilqr_tpu_torch.apps.validate_kernel``
   (the gate of ``tools/validate_kernel_tpu.py``): convergence fraction and
   per-row status agreement with the float64 anchor at least as good as
   the plain float32 version's, solution agreement on rows converged in
   both (cost p90 < 1e-3, position p90 < 5e-2 m), two kernel runs bitwise
   equal; with the dot form (the card's default) and without;
2b. the same comparison with the plain version at each path's shape
   (batch 8192, first tick, cold, the card's modes), in ALM mode with the
   final duals too (rho equal on >= 99% of the rows of equal iterations
   and statuses, and the p90 over those rows of each row's largest mu
   difference < 1e-2): the float32 kernels' times; on the main path's
   shape also the squared distance and the serial line search (the
   configurations of phase 6; each serial kernel against the serial plain
   version, and bitwise equal to its chunked kernel), the fold, and the
   thread kernel in the card's modes and squared / serial; on the
   paths with a schedule,
   the resume entry's time at the shape of the second phase (the kernel's
   solve capped at 8 iterations, its stragglers resumed to 16) against the
   resumed plain version;
2c. for every float32 instantiation (the phase 1 cases), batch 8192, first
   tick cold: chunks of 4 bitwise equal to the serial kernel (dot form
   on), and compaction (8, 16, 32) in the card's modes bitwise equal to one
   launch;
3. the main path: one kernel launch per tick, finite outputs, and the
   float64-confirmed car-following equilibrium (mean final ego x 52.70 m,
   within 0.05 m) in every configuration of phase 6 and with the fold; with
   the schedule, one first-phase launch per tick, at most 3 resume
   launches per tick, and every tick's ego, u and stats bitwise equal to
   the run without;
4. paths (a), (b) and (b2): one launch per tick, finite outputs and
   duals, and on (b2) duals that moved; (a) and (b2) with the schedule as
   the main path, duals included;
5. float64 episodes, batch 128, 3 ticks (cut from 256 and 5), the first
   cold, ``run_mpc_kernel`` in the card's modes with the schedule (2, 5) on
   every tick (so every double resume entry runs) against the same
   episodes written out over the plain version without compaction on the
   card: per-tick iterations and statuses equal on >= 99% of rows,
   trajectories and final duals within 1e-6 on them -- each double
   instantiation, the ALM ones with the duals carried across ticks (also
   the phase 1 three_bend case, whose duals move);
6. the main path under four configurations -- squared distance / serial,
   dot form / serial, squared distance / chunks of 4, dot form / chunks of
   4 -- in the order ABCD DCBA, and in A and D also through the thread
   kernel (A: warp then thread, D: warp then thread; mirrored in DCBA):
   episode wall time and per-tick kernel ms (CUDA events around each
   launch; sum, p50, p90, max, tick 0) of each pair, the warp kernel
   faster than the thread kernel in every pair of D and both at 52.70 m;
   the chunked runs bitwise equal to the serial ones of the same
   projection; then the card's default configuration once more under
   ``torch.profiler``: the device's busy time and idle share;
8. the graph drivers: the main path through ``run_mpc_kernel_chunked``
   (chunks of 10) and ``run_mpc_kernel_scan`` (all 120 ticks one graph),
   path (a) through the scan with its schedule (every phase relaunching
   the sorted batch) and path (b) through both with the duals carried,
   each captured, then replayed, and every run bitwise equal to the host
   loop's episode of phases 3-4 (the scan's final duals too; the main path
   at 52.70 m); a replay counts one launch a tick; the host loop against
   the chunked driver on the main path in the order host, graph, graph,
   host (the graph driver must win both pairs), each once more under
   ``torch.profiler`` (the solve kernel's device ms, the busy time, and
   the idle share against the unprofiled wall); compaction off, on, on,
   off through the graph driver on the main path (the bench's schedule)
   and path (a) ((8, 16, 32)), bitwise equal; and the line of
   ``python -m ilqr_tpu_torch.apps.bench`` (mean final ego x 52.70 m);
9. the sweep entry point and the parallel layer: ``apps.sweep.main`` on
   the main path's scenario (batch 8192, 4 cold steps, kernel engine,
   window 384, its default schedule), each step's stats bitwise equal to
   ``cilqr_solve_cuda`` called directly on that step's starts, one launch
   a step, and ``cold_solves_per_sec`` (the mean of steps 1-3); on step
   0's starts the schedule (8, 16, 32) bitwise equal to one launch and
   both timed off, on, on, off; one step under ``torch.profiler`` (device
   busy time, idle share, kernel ms); a one-rank NCCL group (a file rendezvous,
   no socket) whose all-reduced ``sharded_kernel_solve_fn`` summary equals
   the local ``aggregate_stats``; and ``run_mpc_chunked_sharded`` on a
   one-card mesh bitwise equal to ``run_mpc_kernel_chunked`` over 30 ticks
   of the main path;
7. (run right after phase 0, while the host is quiet) the ``tools/debug``
   repro kernels: each flow once with the counts at 0,
   then each kernel bitwise equal to its plain version and to the repro's
   closed form; every kernel (``carry`` with 0, 1 and 2 trips) bitwise
   (int32 views) at 1, 5, 2047, 2048 and 2049 columns, on the repros'
   inputs and on planted -0, +-inf and NaN, one launch each; each library
   call of ``debug_repros.LIBRARY`` bitwise its plain version; each
   kernel's time per call (200 calls between CUDA events, the launch path
   included) and device time (``torch.profiler``'s device spans of 200
   calls; a window that records none is opened again, up to three, then
   the calls are timed between CUDA events queued behind a spin kernel,
   each counted in ``profiler_misses``; that fallback's time of every
   kernel is printed beside) against its library call's, in the order
   kernel, library, library, kernel, twice; the plain version's time per
   call; every kernel's device time in blocks of 32, 64 and 128; the grid
   and block of ``torch.add``'s kernel beside ``dataflow_k2``'s, from the
   trace;
10. the demos and the eager solver's options, plain PyTorch in float64 on
   the card (no kernel of this script), each held to the port's own CPU
   run: (a) ``lqr_demo_batch_x0`` over 8192 seeded starts of the reference
   system, the first 16 rows equal to a CPU run within 1e-10 (relative
   and absolute) and P* within 1e-6 of a numpy fixed-point oracle; (b)
   the tracking ``simulate`` over 1024 seeded starts, row 0 the demo's
   zero start reaching its goal on the CPU run's tick, steering within
   max_steer; (c) the demo CILQR ``solve`` over 4096 seeded starts
   (max_iter 50), row 0 against the CPU solve (equal iterations and
   convergence, J and x within the bars of
   ``tests/test_torch_cilqr_demo.py``), the last row a copy of row 0 and
   bitwise equal to it; (d) ``riccati_impl="pscan"`` against ``"scan"``
   on scenario_two_straight, batch 1024, cold: at lambda 0, N = 12,
   max_iter 20 every row that converges in either ends on the same
   trajectory in both (u and x within rtol 1e-6 / atol 1e-8), row 0 (the
   unperturbed start of ``tests/test_riccati.py:112``) also with equal
   iterations and status, and the rows whose exit differs are listed
   (their convergence test, |decay| against the threshold at the solution,
   falls the other way); at the shipped lambda both converge on comparable
   shares of rows (the criteria of ``tests/test_riccati.py:147``); each
   solve's wall printed (lambda 0 in the order scan, pscan, pscan, scan
   after a warm-up of each), and the two backward passes alone on the
   shipped problem's first iteration timed scan, pscan, pscan, scan (CUDA
   events);
   (e) ``projection="hier"`` bitwise equal to ``"exact"`` in the eager
   solve on all four scenarios (batch 64, cold, one process a scenario);
   (f) the three demo apps (``lqr_demo``, ``lqr_tracking``,
   ``cilqr_demo``) with ``--no-viz`` as subprocesses on the card, beside
   (e): each exits 0 and prints its lines, with the CPU runs' numbers. No
   matplotlib is imported.
11. the dry run and the port's surface (``apps.dryrun``): the card's name
   and power limit; ``entry()`` (8 starts, float32, max_iter 100, the
   eager ``solve_batch``); ``dryrun_multichip(1)`` with the kernel's counts
   at 0 -- (a) the sharded eager solve, (b) the sharded kernel (barrier,
   cold, cap 2), (c) a 2-tick ALM warm episode through the scan, (d) the
   chunked sharded episode (4 ticks, chunks of 2, cap 2); the kernel must
   launch in (b)-(d), the barrier instantiation in (b) and the ALM one in
   (c) and (d), and each leg's rows must be bitwise those of the same call
   over the whole batch with no mesh (``single_device_legs``); each leg's
   wall; the oracle checks of ``tests/test_torch_oracle.py`` on the card in
   float64 (first tick and ALM at 1e-8, three MPC ticks and the warm start
   at 1e-7); ``solve_batch(weights_batched=True)`` in float64 on the
   yaml-parameter sweep of tests/test_cilqr.py:135-162, each row within
   1e-9 of a 0-d-weight solve with equal iterations and statuses; the
   kernel path refusing those weights with a ``ValueError`` and no launch;
   and the ALM instantiation against its plain version at leg (d)'s first
   tick (and its resume entry at the cap), for the kernels line.

Cut to stay under eight minutes: the host loop's off/on/on/off compaction
timing of the main path and path (a) is gone (phase 8 times compaction
through the graph driver), so path (a) runs twice through the host loop
instead of five times and the main path's compaction runs once there;
phase 6 times the modes instead. Phase 1 runs the dot form and the fold against the plain
version on the four instantiations and not on the moving-dual case, which
shares gravity/ALM's instantiation (its dot form is held to the plain
version by the phase 5 episodes).

The last three lines are the card's name and power limit, a JSON object
describing each kernel that ran on the paths (by instantiation and modes:
a ``_dot``, ``_fold`` or ``_ls`` suffix per mode on; the resume entries;
the repro kernels), and ``{"ok": true, "device": {...}}``.
"""

import collections
import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path


REPO = Path(__file__).resolve().parent
KERNEL_SOURCE = "ilqr_tpu_torch/csrc/cilqr_kernel.cu"
_PALLAS = "ilqr_tpu/ops/pallas/cilqr_kernel.py"
# what each kernel of the line replaces: the TPU kernel, its resume entry
# (host :1596), and the modes this port added, by the mode that marks it
REPLACES = {"base": f"{_PALLAS}:166", "resume": f"{_PALLAS}:1156", "fold": f"{_PALLAS}:368",
            "ls": f"{_PALLAS}:844", "dot": f"{_PALLAS}:267"}
REPRO_SOURCE = "ilqr_tpu_torch/csrc/debug_repros.cu"
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
    # 150 ticks cut to 12 (0.4-0.6 s a tick; batch and N as shipped)
    "a_three_bend": ("scenario_three_bend", {}, 12),
    "b_alm_two_borrow": ("scenario_two_borrow", {"solve_type": "alm",
                                                 "use_last_solution": True}, 150),
    # 150 ticks cut to 20 (0.4-0.6 s a tick, run twice; batch and N as shipped)
    "b2_alm_duals_move": ("scenario_three_bend", {"solve_type": "alm", "use_last_solution": True,
                                                  "weights": DUALS_MOVE}, 20),
}
FULL_TICKS = {"a_three_bend": 150, "b2_alm_duals_move": 150}  # episode lengths before the cuts
DUALS_MOVE_PATHS = ("b2_alm_duals_move",)  # paths that fail unless their duals move
# straggler compaction: the JAX bench's schedule (bench.py:86, :95), cold
# first tick and warm ticks; path (a) is cold on every tick
COLD_CAPS, WARM_CAPS = (8, 16, 32), (6, 12, 24)
BENCH_SCHEDULE = dict(straggler_cap=COLD_CAPS, straggler_cap_warm=WARM_CAPS)
SCHEDULES = {"main": BENCH_SCHEDULE, "a_three_bend": dict(straggler_cap=COLD_CAPS),
             "b2_alm_duals_move": BENCH_SCHEDULE}
# float64: caps low enough that every case has rows to resume
F64_CAPS = (2, 5)
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
# cut from 256 rows and 5 ticks: the plain episodes, eager PyTorch bound by
# the host, took a third of the script's time
EPISODE_F64_BATCH = 128
EPISODE_F64_TICKS = 3
EPISODE_F64_SCHEDULE = dict(straggler_cap=F64_CAPS)
# the chunk widths held bitwise to the serial line search
CHUNK_WIDTHS = (3, 4, 8)
# ticks per chunk of the graph driver (the JAX bench's BENCH_CHUNK)
GRAPH_CHUNK = 10
# phase 9: the sweep's steps, and the sharded episode's ticks (cut from 120)
SWEEP_STEPS = 4
SWEEP_EPISODE_TICKS = 30

# Operations per unit of the kernel's work, counted from csrc/cilqr_kernel.cu:
# each add, multiply, divide, compare and transcendental is one operation
# (an FMA is two), and a branch counts its cheaper side. Per horizon step
# unless noted. The fold takes as many compares as the first minimum.
OPS = dict(
    prop_rear=15, prop_gravity=29,    # propagate
    feedback=24,                      # forward: u + K (x' - x) + alpha d
    row=6,                            # one window row of a projection scan, squared distance
    row_dot=5,                        # one window row, dot form: 2 products, 2 sums, a compare
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


def ptxas_summary(log, name_of):
    """{kernel: registers, stack and spill bytes} from nvcc -Xptxas -v;
    ``name_of`` maps a ptxas line naming an entry function to the kernel's
    name (None for another function)."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            cur = name_of(line)
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


def solve_kernel_name(line):
    m = re.search(r"cilqr_solve_kernelI([fd])Lb([01])ELb([01])E", line)
    return None if m is None else "cilqr_solve_{}_{}_{}".format(
        "f32" if m[1] == "f" else "f64", ("rear", "gravity")[int(m[2])],
        ("barrier", "alm")[int(m[3])])


def repro_kernel_name(line):
    m = re.search(r"\d(resume_echo|dataflow_k1|dataflow_k2|carry)E", line)
    return None if m is None else m[1]


def compiled_name(name):
    """The instantiation (ptxas entry) a kernel name of the line runs."""
    return re.sub(r"_(dot|fold|ls|resume)", "", name)


def replaces(name):
    """What a kernel of the line replaces, by the mode that marks it."""
    for key in ("resume", "fold", "ls", "dot"):
        if f"_{key}" in name:
            return REPLACES[key]
    return REPLACES["base"]


def bound(cfg, dtype, shape, work):
    """(bound_ms, bound_by): the least time the card could take for the
    work these inputs needed -- each input read and each output written
    once over the memory rate, against the operations (``OPS``) of this
    run's iterations, line-search rollouts (a chunk's wasted ones
    included), trials projected and costed, and dual updates over the peak
    rate of the type."""
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    B, N, M, W = shape["B"], shape["N"], shape["M"], shape["W"]
    modes = shape["modes"]
    dt, gravity, alm = ck.instantiation(cfg, dtype, modes)
    size = 4 if dt == "f32" else 8
    C = 8 + 2 * M
    o = OPS
    prop = o["prop_gravity"] if gravity else o["prop_rear"]
    cost = (N + 1) * o["cost_track"] + N * (o["cost_ctrl"] + o["cost_state"] + M * o["cost_obs"])
    deriv = (N + 1) * o["deriv_base"] + N * (o["deriv_ctrl"] + o["deriv_state"]
                                             + M * o["deriv_obs"])
    riccati = o["riccati_gravity"] if gravity else o["riccati_rear"]
    proj = (o["row_dot"] if modes.proj_dot else o["row"]) * sum(shape["row_limits"])
    init = N * prop + proj + cost
    ops = (B * init + work["iters"] * (deriv + N * riccati)
           + work["trials"] * N * (o["feedback"] + prop) + work["evals"] * (proj + cost)
           + work["dual_updates"] * (2 * cost + C * N * o["dual_col"]))
    elems = (8 + 2 * N + 3 * W + 3 * M * (N + 1)) + (2 * N + 4 * (N + 1) + 6)
    if modes.proj_dot:
        elems += 3 * W  # the dot form's window terms
    if alm:
        elems += 2 * (C * N + 1)
    t_ops = ops / PEAK_OPS[dt] * 1e3
    t_bytes = elems * B * size / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def shape_of(cfg, p):
    return dict(B=p.x0.shape[1], N=cfg.N, M=p.ox.shape[0], W=p.window,
                row_limits=list(p.row_limits), modes=p.modes)


def phase_env():
    import torch

    check(torch.cuda.is_available(), "no CUDA device (torch.cuda.is_available() is false)")
    import ilqr_tpu_torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel_thread as ckt
    from ilqr_tpu_torch.ops.cuda import debug_repros as dr

    check(Path(ilqr_tpu_torch.__file__).resolve().is_relative_to(REPO),
          f"ilqr_tpu_torch imported from outside this checkout: {ilqr_tpu_torch.__file__}")
    line = gpu_line()
    print(line, flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:  # one nvcc per source, together
        builds = [pool.submit(f) for f in (ck.load_library, ckt.load_library, dr.load_library)]
        (_, log), (_, thread_log), (_, repro_log) = (b.result() for b in builds)
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(log, solve_kernel_name)
    thread_ptxas = ptxas_summary(thread_log, solve_kernel_name)
    for tag, summary in (("", ptxas), (" of the thread kernel", thread_ptxas)):
        check(len(summary) == 8 and all(len(v) == 4 for v in summary.values()),
              f"ptxas summary{tag} incomplete: {summary}")
    for name, v in ptxas.items():  # the warp kernel keeps its state on chip
        if name.startswith("cilqr_solve_f32"):
            check(v["spill_stores"] == 0 and v["stack"] < 1024, f"{name}: ptxas {v}")
    repro_ptxas = ptxas_summary(repro_log, repro_kernel_name)
    check(len(repro_ptxas) == 4 and all(len(v) == 4 for v in repro_ptxas.values()),
          f"ptxas summary of the repro kernels incomplete: {repro_ptxas}")
    # the main path's launch plan at batch 8192 in the card's modes, and
    # the scenarios registers and shared memory let one SM hold
    cfg, _, p = vk.packed_cold(PATHS["main"][0], 8, modes=ck.resolve_modes(DEVICE))
    plan = ck.launch_plan(BATCH, cfg.N, p.ox.shape[0], max(p.row_limits), torch.float32, p.modes)
    main_plan = dict(grid=plan.grid, block=plan.block, shared_bytes=plan.shared_bytes,
                     resident_scenarios_per_sm=ck.resident_scenarios(cfg, torch.float32, plan))
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=line, nvcc=shutil.which("nvcc") or ck._nvcc(),
        triton=importlib.util.find_spec("triton") is not None,
        build_seconds=round(build_s, 3), ptxas=ptxas, thread_kernel_ptxas=thread_ptxas,
        repro_ptxas=repro_ptxas, main_path_plan=main_plan)
    return line, ptxas


def fields_of(sol):
    """The tensors of a ``PackedSolution`` (the duals in ALM mode only)."""
    return [t for t in sol if t is not None]


def bitwise(a, b):
    """Two ``PackedSolution``s equal bit for bit."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(fields_of(a), fields_of(b)))


def with_modes(p, proj_dot=False, ls_chunk=0, proj_fold=False):
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    return dataclasses.replace(p, modes=ck.Modes(proj_dot, ls_chunk, proj_fold))


def differences(k, r, alm):
    """Rows of equal iterations and statuses in two ``PackedSolution``s,
    and the largest differences of u, x (and the duals) on them."""
    same = (k.stats[0] == r.stats[0]) & (k.stats[1] == r.stats[1])
    errs = {"u": float((k.u - r.u).abs()[:, :, same].max()),
            "x": float((k.x - r.x).abs()[:, :, same].max())}
    if alm:
        errs["mu"] = float((k.mu - r.mu).abs()[:, :, same].max())
        errs["rho"] = float((k.rho - r.rho).abs()[same].max())
    return same, errs


def against_plain(cfg, w, p, reps):
    """The kernel (mean ms of ``reps`` launches after a warm-up) and the
    plain version (host clock, synchronised) on the same packed problem:
    (kernel solution, plain solution, record). The record's ``errs`` are
    the largest differences on the rows of equal iterations and statuses."""
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    ms_k, k = vk.time_ms(lambda: ck.cilqr_solve_kernel(cfg, w, p), reps=reps)
    work = {}
    t0 = time.perf_counter()
    r = ck.cilqr_solve_ref(cfg, w, p, work=work)
    torch.cuda.synchronize()
    ms_r = (time.perf_counter() - t0) * 1e3
    same, errs = differences(k, r, cfg.solve_type == "alm")
    rec = dict(variant=ck.variant(cfg, p.x0.dtype, p.modes), cfg=cfg, dtype=p.x0.dtype,
               err=max(errs.values()), errs=errs, ms=ms_k, plain_ms=ms_r, work=work,
               shape=shape_of(cfg, p), same=same, plain_solution=r)
    return k, r, rec


def compaction_bitwise(cfg, w, p, one, caps):
    """The kernel with compaction at ``caps`` against ``one``, the same
    problem's one-launch solution: (bitwise equal in every output, resume
    launches, the rows each later phase resumed)."""
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    name = ck.variant(cfg, p.x0.dtype, p.modes) + "_resume"
    before = ck.launches[name]
    comp = ck.solve_packed(cfg, w, p, caps)
    torch.cuda.synchronize()
    resumed = [int((one.stats[0] > c).sum()) for c in ck.straggler_schedule(caps, cfg.max_iter)[:-1]]
    return bitwise(one, comp), ck.launches[name] - before, resumed


def resume_measure(cfg, w, p, caps, reps):
    """The resume entry at the shape of a compacted solve's second phase:
    the kernel's own solve capped at caps[0], its stragglers resumed up to
    caps[1]; kernel ms (CUDA events) against the resumed plain version on
    the same inputs, compared on rows of equal iterations and statuses.
    None when no row is left to resume."""
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    dtype = p.x0.dtype
    first = ck.cilqr_solve_kernel(cfg, w, p, max_iter=caps[0])
    rows = ck.stragglers(first)
    if rows.numel() == 0:
        return None
    sub = ck.resume_problem(p, first, rows, caps[0])
    ms_k, k = vk.time_ms(lambda: ck.cilqr_solve_kernel(cfg, w, sub, max_iter=caps[1]), reps=reps)
    work = {}
    t0 = time.perf_counter()
    r = ck.cilqr_solve_ref(cfg, w, sub, work=work, max_iter=caps[1])
    torch.cuda.synchronize()
    ms_r = (time.perf_counter() - t0) * 1e3
    same, errs = differences(k, r, cfg.solve_type == "alm")
    return dict(variant=ck.variant(cfg, dtype, p.modes) + "_resume", cfg=cfg, dtype=dtype,
                err=max(errs.values()), errs=errs, ms=ms_k, plain_ms=ms_r, work=work,
                shape=shape_of(cfg, sub), rows=int(rows.numel()),
                iters_status_equal=int(same.sum()), it0=caps[0], max_iter=caps[1])


def f64_gate(tag, rec, rows):
    n_same = int(rec["same"].sum())
    check(n_same >= 0.99 * rows, f"{tag}: f64 iters/status agree on {n_same}/{rows} rows")
    check(rec["err"] <= 1e-6, f"{tag}: f64 kernel vs plain max abs err {rec['err']:.3e} > 1e-6")


def brief(rec):
    """The printable fields of a kernel-against-plain record."""
    return dict(variant=rec["variant"], iters_status_equal=int(rec["same"].sum()),
                **{f"max_abs_err_{key}": v for key, v in rec["errs"].items()},
                kernel_ms=rec["ms"], plain_ms=rec["plain_ms"], plain_work=rec["work"])


def phase_semantics_f64(case, batch=256):
    """1: one float64 case. Returns its records (kernel against plain) of
    the kernels the paths run, and those of the modes the paths do not run."""
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel_thread as ckt

    name, over, wover = vk.CASES[case]
    cfg, w, p = vk.packed_cold(name, batch, torch.float64, weights=wover, modes=ck.Modes(),
                               **over)
    card = ck.resolve_modes(DEVICE)
    p_card = dataclasses.replace(p, modes=card)
    # squared distance, serial line search; and the thread kernel on the
    # same inputs, under the same gate
    k, r, base = against_plain(cfg, w, p, reps=1)
    f64_gate(case, base, batch)
    same_t, errs_t = differences(k, ckt.solve(cfg, w, p), cfg.solve_type == "alm")
    vs_thread = dict(iters_status_equal=int(same_t.sum()),
                     **{f"max_abs_err_{key}": v for key, v in errs_t.items()})
    check(int(same_t.sum()) >= 0.99 * batch and max(errs_t.values()) <= 1e-6,
          f"{case}: f64 warp kernel vs thread kernel: {vs_thread}")
    # the modes: dot form, fold, both; chunks of 4 (bitwise the serial line
    # search, below), which also speeds up the plain version
    modes, records, sols = {}, [base], {}
    if case != "gravity_alm_duals_move":
        for tag, m in (("dot", card._replace(proj_fold=False)),
                       ("fold", card._replace(proj_dot=False, proj_fold=True)),
                       ("dot_fold", card._replace(proj_fold=True))):
            sols[m], _, rec = against_plain(cfg, w, dataclasses.replace(p, modes=m), reps=1)
            f64_gate(f"{case} {tag}", rec, batch)
            modes[tag] = brief(rec)
            records.append(rec)
    one = sols[card] if card in sols else ck.cilqr_solve_kernel(cfg, w, p_card)
    # chunks bitwise equal to the serial line search, dot form on
    serial = ck.cilqr_solve_kernel(cfg, w, with_modes(p, proj_dot=True))
    chunks = {cw: bitwise(serial, ck.cilqr_solve_kernel(cfg, w, with_modes(p, True, cw)))
              for cw in CHUNK_WIDTHS}
    comp = {caps: compaction_bitwise(cfg, w, p_card, one, caps) for caps in (COLD_CAPS, F64_CAPS)}
    # compaction with the fold on: the resume entry folds the resumed rows
    # again, with a scratch sized and strided for the sub-batch
    fold_comp = {}
    for tag, m in (("fold", ck.Modes(False, 0, True)), ("dot_fold_ls", ck.Modes(True, 4, True))):
        pm = dataclasses.replace(p, modes=m)
        fold_one = sols[m] if m in sols else ck.cilqr_solve_kernel(cfg, w, pm)
        fold_comp[tag] = compaction_bitwise(cfg, w, pm, fold_one, F64_CAPS)
    res = resume_measure(cfg, w, p_card, F64_CAPS, reps=1)
    fields = dict(**brief(base), scenario=name, batch=batch, rows=batch, tol=1e-6,
                  mean_iters=float(r.stats[0].mean()), against_thread_kernel=vs_thread,
                  modes_against_plain=modes,
                  chunk_bitwise_serial=chunks, card_modes=card._asdict(),
                  compaction_bitwise={str(c): b[0] for c, b in comp.items()},
                  compaction_resume_launches={str(c): b[1] for c, b in comp.items()},
                  compaction_rows_resumed={str(c): b[2] for c, b in comp.items()},
                  fold_compaction_bitwise={t: b[0] for t, b in fold_comp.items()},
                  fold_compaction_resume_launches={t: b[1] for t, b in fold_comp.items()},
                  resume=None if res is None else {
                      key: res[key] for key in ("variant", "rows", "it0", "max_iter",
                                                "iters_status_equal", "errs", "ms",
                                                "plain_ms")})
    if cfg.solve_type == "alm":
        fields.update(dual_rows_moved=int((r.mu.flatten(0, 1) > 0).any(0).sum()),
                      rho_max=float(r.rho.max()))
    say("phase1_f64" if case == "rear_barrier" else f"phase1_f64_{case}", **fields)
    if case == "gravity_alm_duals_move":
        check(fields["dual_rows_moved"] > 0 and fields["rho_max"] > 20.0,
              "the duals did not move")
    check(all(chunks.values()), f"{case}: f64 chunked line search differs from serial: {chunks}")
    for caps, (equal, n_resume, _) in comp.items():
        check(equal, f"{case}: f64 compaction {caps} differs from one launch")
        check(n_resume <= len(caps), f"{case}: {n_resume} resume launches at {caps}")
    for tag, (equal, n_resume, resumed) in fold_comp.items():
        check(equal, f"{case}: f64 compaction {F64_CAPS} with {tag} differs from one launch")
        check(n_resume == sum(n > 0 for n in resumed),
              f"{case} {tag}: {n_resume} resume launches for rows {resumed}")
    check(res is not None, f"{case}: no row left to resume after {F64_CAPS[0]} iterations")
    check(res["iters_status_equal"] >= 0.99 * res["rows"] and res["err"] <= 1e-6,
          f"{case}: f64 resume vs plain: {res['iters_status_equal']}/{res['rows']} rows equal, "
          f"max abs err {res['err']:.3e}")
    return records + [res]


def phase_f32_anchor():
    from ilqr_tpu_torch.apps import validate_kernel as vk

    for name in vk.SCENARIOS:
        for proj_dot in (None, False):  # the card's default (dot form on), then off
            res = vk.validate(name, proj_dot)
            failures = res.pop("failures")
            say("phase2_f32_anchor", **res)
            check(not failures, f"{name} ({res['variant']}): " + "; ".join(failures))


def f32_against_plain(path, tag, cfg, w, p, reps):
    """2b: one float32 kernel against its plain version at a path's shape,
    under the agreement gates; returns (kernel solution, record)."""
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk

    k, r, rec = against_plain(cfg, w, p, reps)
    rec["kernel_solution"] = k
    conv_k, conv_r, cost_p90, pos_p90 = vk.agreement(k, r)
    gap = abs(float(conv_k.mean()) - float(conv_r.mean()))
    same = rec["same"]
    fields = dict(variant=rec["variant"], batch=p.x0.shape[1], conv_kernel=float(conv_k.mean()),
                  conv_plain=float(conv_r.mean()), cost_relerr_p90=cost_p90,
                  pos_absdiff_p90=pos_p90, iters_status_equal=int(same.sum()),
                  **{f"max_abs_err_{key}_on_equal_rows": v for key, v in rec["errs"].items()},
                  kernel_ms=rec["ms"], plain_ms=rec["plain_ms"], plain_work=rec["work"])
    if cfg.solve_type == "alm":
        dmu = (k.mu - r.mu).abs()[:, :, same].flatten(0, 1).amax(0)  # each row's largest
        fields.update(mu_absdiff_p90=float(torch.quantile(dmu.double(), 0.9)),
                      rho_equal_frac=float((k.rho == r.rho)[same].float().mean()),
                      dual_rows_moved=int(((r.mu.flatten(0, 1) > 0).any(0)
                                           | (r.rho > w.alm_rho_init)).sum()),
                      rho_max=float(r.rho.max()))
    check(gap <= 0.03, f"{path} {tag}: conv fraction kernel vs plain differs by {gap:.4f} > 0.03")
    check(cost_p90 < 1e-3, f"{path} {tag}: cost relerr p90 {cost_p90:.3e} >= 1e-3")
    check(pos_p90 < 5e-2, f"{path} {tag}: position p90 {pos_p90:.3e} >= 5e-2 m")
    if cfg.solve_type == "alm":
        check(fields["rho_equal_frac"] >= 0.99,
              f"{path} {tag}: rho equal on {fields['rho_equal_frac']:.4f} of equal rows < 0.99")
        check(fields["mu_absdiff_p90"] < 1e-2,
              f"{path} {tag}: mu abs diff p90 {fields['mu_absdiff_p90']:.3e} >= 1e-2")
    if path in DUALS_MOVE_PATHS:
        check(fields["dual_rows_moved"] > 0 and fields["rho_max"] > float(w.alm_rho_init),
              f"{path}: the duals did not move")
    return k, rec, fields


def phase_f32_path_shape(path, batch=BATCH):
    """2b: the path's kernel in the card's modes against the plain version
    at the path's shape; on the main path also the squared distance and
    the serial line search (phase 6's configurations) and the fold."""
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel_thread as ckt

    name, over, _ = PATHS[path]
    over = dict(over)
    wover = over.pop("weights", None)
    card = ck.resolve_modes(DEVICE)
    cfg, w, p = vk.packed_cold(name, batch, weights=wover, modes=card, **over)
    _, rec, fields = f32_against_plain(path, "card modes", cfg, w, p, reps=3)
    records, extra = [rec], {}
    if path == "main":
        # the squared distance against its plain version (chunks of 4 on
        # both sides), the fold, and the serial line search of each
        # projection against the serial plain version, each bitwise equal to
        # its chunked kernel
        for tag, m in (("squared", card._replace(proj_dot=False)),
                       ("dot_fold", card._replace(proj_fold=True))):
            _, r2, f2 = f32_against_plain(path, tag, cfg, w, dataclasses.replace(p, modes=m), 3)
            records.append(r2)
            extra[tag] = f2
            if tag == "squared":
                sq_rec = r2
        for chunked in (sq_rec, rec):
            m = chunked["shape"]["modes"]._replace(ls_chunk=0)
            tag = ck.variant(cfg, torch.float32, m)
            k_serial, serial, f_serial = f32_against_plain(
                path, tag, cfg, w, dataclasses.replace(p, modes=m), 3)
            equal = bitwise(k_serial, chunked["kernel_solution"])
            check(equal, f"main: {chunked['variant']} differs from the serial line search")
            records.append(serial)
            extra[tag] = dict(kernel_ms=serial["ms"], plain_ms=serial["plain_ms"],
                              plain_work=serial["work"], bitwise_chunked=equal,
                              cost_relerr_p90=f_serial["cost_relerr_p90"])
        # the thread kernel on the same inputs, in the card's modes and in
        # squared distance / serial (phase 6's D and A), against the plain
        # version and the warp kernel
        thread = {}
        for rec_w in [r for r in records if r["shape"]["modes"] in (card, ck.Modes())]:
            pm = dataclasses.replace(p, modes=rec_w["shape"]["modes"])
            ms_t, k_t = vk.time_ms(lambda: ckt.solve(cfg, w, pm), reps=3)
            same_t, errs_t = differences(k_t, rec_w["plain_solution"], False)
            rec_t = dict(rec_w, variant=rec_w["variant"] + "_thread", ms=ms_t,
                         err=max(errs_t.values()), errs=errs_t, same=same_t)
            records.append(rec_t)
            thread[rec_w["variant"]] = dict(warp_ms=rec_w["ms"], thread_ms=ms_t,
                                            thread_over_warp=ms_t / rec_w["ms"],
                                            thread_iters_status_equal_plain=int(same_t.sum()),
                                            thread_max_abs_err_plain=max(errs_t.values()))
        extra["thread_kernel"] = thread
    res = resume_measure(cfg, w, p, COLD_CAPS, reps=3) if path in SCHEDULES else None
    resume = {} if res is None else dict(resume={
        key: res[key] for key in ("variant", "rows", "it0", "max_iter", "iters_status_equal",
                                  "errs", "ms", "plain_ms")})
    say("phase2b_f32_main_shape" if path == "main" else f"phase2b_f32_{path}",
        scenario=name, modes=card._asdict(), **fields, **extra, **resume)
    if path in SCHEDULES:
        check(res is not None, f"{path}: no row left to resume after {COLD_CAPS[0]} iterations")
    return records + [res]


def phase_bitwise_f32(batch=BATCH):
    """2c: for every float32 instantiation (the phase 1 cases), chunks of 4
    against the serial line search (dot form on), and compaction at the
    bench's cold caps in the card's modes against one launch, bitwise."""
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    card = ck.resolve_modes(DEVICE)
    for case, (name, over, wover) in vk.CASES.items():
        cfg, w, p = vk.packed_cold(name, batch, weights=wover, modes=card, **over)
        chunk_equal = bitwise(ck.cilqr_solve_kernel(cfg, w, with_modes(p, proj_dot=True)),
                              ck.cilqr_solve_kernel(cfg, w, with_modes(p, True, 4)))
        one = ck.cilqr_solve_kernel(cfg, w, p)
        equal, n_resume, resumed = compaction_bitwise(cfg, w, p, one, COLD_CAPS)
        say(f"phase2c_f32_bitwise_{case}", variant=ck.variant(cfg, p.x0.dtype, p.modes),
            scenario=name, batch=batch, chunk4_bitwise_serial=chunk_equal, caps=COLD_CAPS,
            compaction_bitwise=equal, resume_launches=n_resume, rows_resumed=resumed)
        check(chunk_equal, f"{case}: f32 chunks of 4 differ from the serial line search")
        check(equal, f"{case}: f32 compaction {COLD_CAPS} differs from one launch")
        check(n_resume == sum(n > 0 for n in resumed),
              f"{case}: {n_resume} resume launches for rows {resumed}")


class LaunchTimer:
    """Records a CUDA event pair around every launch of the solve kernel
    (``cilqr_solve_kernel``, which the compaction calls once per phase) and
    the batch of each; a launch not through the resume entry starts a new
    tick."""

    def __enter__(self):
        import torch
        from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

        self.ticks, self._ck, self._launch = [], ck, ck.cilqr_solve_kernel

        def timed(cfg, w, p, max_iter=None):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._launch(cfg, w, p, max_iter)
            end.record()
            if p.stats is None:
                self.ticks.append([])
            self.ticks[-1].append((start, end, p.x0.shape[1]))
            return out

        ck.cilqr_solve_kernel = timed
        return self

    def __exit__(self, *exc):
        self._ck.cilqr_solve_kernel = self._launch

    def kernel_ms(self):
        """Each tick's launches' device time, summed."""
        import torch

        torch.cuda.synchronize()
        return [sum(s.elapsed_time(e) for s, e, _ in t) for t in self.ticks]

    def resumed_rows(self, phases):
        """rows[t][i]: the rows the (i + 1)-th phase of tick t resumed (0
        when it was skipped)."""
        return [[t[i + 1][2] if i + 1 < len(t) else 0 for i in range(phases)] for t in self.ticks]


def run_path(name, over, dtype, batch, ticks, schedule=None, modes=None, driver="host"):
    """One batch of episodes on the card, with the launch counts set to 0
    just before and read just after; ``schedule`` holds its straggler caps,
    ``modes`` (None: the card's) its modes. ``driver``: ``"host"``, the host
    loop ``run_mpc_kernel`` (the final duals in ALM mode); ``"scan"``,
    ``run_mpc_kernel_scan``, every tick one graph (the final duals in ALM
    mode); ``"chunked"``, ``run_mpc_kernel_chunked`` in chunks of
    ``GRAPH_CHUNK`` (no duals). Also returns the episode's inputs."""
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.sim.mpc import (run_mpc_kernel, run_mpc_kernel_chunked,
                                        run_mpc_kernel_scan)

    st, cfg, w, x0, rows = vk.problem(name, batch, dtype, DEVICE, **over)
    sc = st.device_scenario(tick=0, dtype=dtype, device=DEVICE, batch=batch)
    obs = torch.as_tensor(st.obs_preds_array(), device=DEVICE).to(dtype)
    check(obs.shape[1] >= ticks + cfg.N + 1, "obstacle predictions shorter than the episode")
    obs_b = obs.expand(batch, *obs.shape)
    modes = ck.resolve_modes(DEVICE) if modes is None else modes
    alm = cfg.solve_type == "alm"
    args = (cfg, w, x0, sc.ref_line, sc.ref_velo, obs_b, sc.road_borders, ticks)
    kw = dict(window=384, proj_rows_per_step=rows, w_back=24, **(schedule or {}),
              **modes._asdict())
    torch.cuda.synchronize()
    ck.launches.clear()
    t0 = time.perf_counter()
    if driver == "host":
        out = run_mpc_kernel(*args, return_alm=alm, **kw)
    elif driver == "scan":
        ego, us, stats, carry = run_mpc_kernel_scan(*args, with_carry=True, **kw)
        out = (ego, us, stats) + (((carry[1], carry[2]),) if alm else ())
    else:
        out = run_mpc_kernel_chunked(*args, chunk=GRAPH_CHUNK, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return cfg, out, total, dict(ck.launches), (w, x0, sc, obs_b, rows, modes)


def episode_tensors(out):
    """Every tensor of a ``run_mpc_kernel`` result: ego, u, the six stats
    and (ALM) the duals."""
    ego, us, st = out[:3]
    return [ego, us, st.iters, st.status, st.converged, st.lamb_overflow, st.final_cost,
            st.final_lamb] + (list(out[3]) if len(out) == 4 else [])


def episodes_equal(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(episode_tensors(a), episode_tensors(b)))


def check_schedule_launches(tag, variant, launches, ticks, caps):
    resume = launches.get(variant + "_resume", 0)
    check(launches.get(variant) == ticks and set(launches) <= {variant, variant + "_resume"},
          f"{tag}: launches {launches} in {ticks} ticks")
    check(0 < resume <= ticks * caps, f"{tag}: {resume} resume launches in {ticks} ticks")


def profile_run(fn):
    """Run ``fn`` under ``torch.profiler``: wall seconds, the device's busy
    seconds (the union of its kernels' and copies' spans) and idle share,
    and the device ms of the largest kernels by name. The share is None
    when the trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = collections.Counter()
    kernel_ms = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
            if "cilqr_solve_kernel" in e.name:
                kernel_ms += e.time_range.elapsed_us() / 1e3
    busy = busy_us / 1e6
    return dict(wall_s=wall, device_busy_s=busy if spans else None,
                idle_share=1.0 - busy / wall if spans else None,
                solve_kernel_ms=kernel_ms if spans else None,
                top_device_ms=dict(by_name.most_common(6)))


# profiled windows ``device_ms`` opens before it gives up on the profiler:
# now and then one records no device span on a fresh machine; the empty
# windows and the fallbacks are counted here and printed by phase 7
PROFILE_TRIES = 3
QUEUE_SPIN_CYCLES = 100_000_000  # ~50 ms at the card's clock: longer than the host queues
profiler_misses = collections.Counter()


def device_ms(fn, reps):
    """Device milliseconds a call of ``fn`` takes, without the host's launch
    path: over ``reps`` calls after a warm-up, per name of the device spans
    (kernels, copies, fills) that ``torch.profiler`` records, the mean of
    the middle 80% of its spans times the spans of that name a call makes,
    summed. Per name and rounded, the count stands against spans the
    profiler drops (a sum over the recorded spans per call read a dropped
    span as a fast call, below the launch floor); the trimmed mean against
    outliers, and unlike the median it resolves below the spans' 32 ns
    timestamp step. A window with no device span is opened again, up to
    ``PROFILE_TRIES`` windows; then ``queued_ms`` times the calls."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans[e.name].append(e.time_range.elapsed_us())
        if spans:
            break
        profiler_misses["empty_windows"] += 1
    else:
        profiler_misses["queued_fallbacks"] += 1
        return queued_ms(fn, reps)
    total = 0.0
    for v in spans.values():
        v = np.sort(v)
        cut = len(v) // 10
        total += float(v[cut:len(v) - cut].mean()) * max(1, round(len(v) / reps))
    return total / 1e3


def queued_ms(fn, reps):
    """Device milliseconds a call of ``fn`` takes between two CUDA events,
    its ``reps`` calls queued behind a spin kernel so the host's launch
    path is off the clock (the device's gaps between kernels are on it).
    Fails if the host took longer to queue them than the spin lasted."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spin.record()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    check(queued_s * 1e3 < spin.elapsed_time(start),
          f"queued_ms: the host queued for {queued_s * 1e3:.3f} ms, longer than the spin")
    return start.elapsed_time(end) / reps


def stats_ms(values):
    import numpy as np

    v = np.asarray(values, dtype=float)
    return dict(sum=float(v.sum()), mean=float(v.mean()), p50=float(np.percentile(v, 50)),
                p90=float(np.percentile(v, 90)), max=float(v.max()))


class ThreadKernel:
    """Routes ``ck.cilqr_solve_kernel`` to the thread-per-scenario kernel
    inside the block (the comparison runs of phase 6), its launches counted
    in ``ckt.launches``."""

    def __enter__(self):
        from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
        from ilqr_tpu_torch.ops.cuda import cilqr_kernel_thread as ckt

        self._ck, self._launch = ck, ck.cilqr_solve_kernel
        ckt.launches.clear()
        ck.cilqr_solve_kernel = ckt.solve
        return ckt.launches

    def __exit__(self, *exc):
        self._ck.cilqr_solve_kernel = self._launch


def path_gates(path, card, cfg, out, total, launches, inputs, tag):
    """The phase 3 / 4 gates of one run of a path; prints its line."""
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    name, _, ticks = PATHS[path]
    batch = out[0].shape[1]
    modes = inputs[-1]
    ego, us, stats = out[:3]
    variant = ck.variant(cfg, torch.float32, modes)
    final_x = float(ego[-1, :, 0].mean())
    fields = dict(card=card, scenario=name, variant=variant, modes=modes._asdict(), batch=batch,
                  ticks=ticks, ticks_cut_from=FULL_TICKS.get(path, ticks), total_s=total,
                  ms_per_tick=total / ticks * 1e3, solves_per_s=batch * ticks / total,
                  mean_iters=float(stats.iters.float().mean()), final_ego_x_mean=final_x,
                  conv_frac=float(stats.converged.float().mean()), launches=launches)
    finite = bool(torch.isfinite(ego).all() and torch.isfinite(us).all())
    if len(out) == 4:
        mu, rho = out[3]
        moved = (mu.flatten(1) > 0).any(1) | (rho > inputs[0].alm_rho_init)
        fields.update(mu_max=float(mu.max()), rho_mean=float(rho.mean()),
                      rho_max=float(rho.max()), dual_rows_moved=int(moved.sum()))
        finite = finite and bool(torch.isfinite(mu).all() and torch.isfinite(rho).all())
    say(("phase3_main_path" if path == "main" else f"phase4_path_{path}") + tag, **fields)
    check(launches == {variant: ticks}, f"{path}: launches {launches} in {ticks} ticks")
    check(tuple(ego.shape) == (ticks + 1, batch, 4), f"{path}: ego shape {tuple(ego.shape)}")
    check(tuple(us.shape) == (ticks, batch, cfg.N, 2), f"{path}: u shape {tuple(us.shape)}")
    check(finite, f"{path}: non-finite episode")
    if path == "main":
        check(abs(final_x - EGO_X_ANCHOR) <= EGO_X_TOL,
              f"{variant}: final_ego_x_mean {final_x:.4f} not within {EGO_X_TOL} of "
              f"{EGO_X_ANCHOR}")
    if path in DUALS_MOVE_PATHS:
        check(fields["dual_rows_moved"] > 0, f"{path}: the duals did not move")
    return variant


def compaction_run(path, card, out, variant, launches_total):
    """The path once more with its schedule: bitwise equal to ``out``, the
    run without; adds the run's launches to ``launches_total``."""
    import torch

    name, over, ticks = PATHS[path]
    schedule = SCHEDULES[path]
    phases = len(schedule["straggler_cap"])
    with LaunchTimer() as timer:
        _, on, total, launches, _ = run_path(name, over, torch.float32, BATCH, ticks, schedule)
    launches_total.update(launches)
    resumed = timer.resumed_rows(phases)
    first, warm = resumed[0], resumed[1:]
    say("phase3_main_path_compaction" if path == "main" else f"phase4_path_{path}_compaction",
        scenario=name, variant=variant, schedule=schedule,
        bitwise_equal=episodes_equal(out, on), final_ego_x_mean=float(on[0][-1, :, 0].mean()),
        total_s=total, launches=launches, rows_resumed_tick0=first,
        rows_resumed_later_mean=[float(sum(t[i] for t in warm) / max(len(warm), 1))
                                 for i in range(phases)],
        rows_resumed_later_max=[max((t[i] for t in warm), default=0) for i in range(phases)])
    check(episodes_equal(out, on), f"{path}: the episode with compaction differs from the one without")
    check_schedule_launches(path, variant, launches, ticks, phases)


def phase_main(card, launches_total):
    """3 and 6: the main path in four configurations, ABCD DCBA, each run
    gated as phase 3 and timed, and in A and D the thread kernel beside the
    warp kernel (gated alike, its launches its own); the chunked runs
    bitwise equal to the serial ones; then the card's default with the
    schedule (bitwise equal), with the fold, and profiled."""
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    name, over, ticks = PATHS["main"]
    card_modes = ck.resolve_modes(DEVICE)
    configs = {"A": ck.Modes(False, 0, False), "B": ck.Modes(True, 0, False),
               "C": ck.Modes(False, 4, False), "D": ck.Modes(True, 4, False)}
    compared = ("A", "D")  # the configurations the thread kernel runs too
    order = [(key, kernel) for i, key in enumerate("ABCDDCBA")
             for kernel in (("warp", "thread") if i < 4 else ("thread", "warp"))
             if kernel == "warp" or key in compared]
    runs = []
    for key, kernel in order:
        with contextlib.ExitStack() as stack:
            thread_launches = stack.enter_context(ThreadKernel()) if kernel == "thread" else None
            timer = stack.enter_context(LaunchTimer())
            cfg, out, total, launches, inputs = run_path(name, over, torch.float32, BATCH, ticks,
                                                         modes=configs[key])
            if thread_launches is not None:
                launches = dict(thread_launches)
        if kernel == "warp":
            launches_total.update(launches)
        variant = path_gates("main", card, cfg, out, total, launches, inputs,
                             f"_{key}" + ("_thread" if kernel == "thread" else ""))
        runs.append(dict(key=key, kernel=kernel, out=out, total=total,
                         kernel_ms=timer.kernel_ms(), variant=variant))
    warp_runs = [r for r in runs if r["kernel"] == "warp"]
    first = {r["key"]: r for r in reversed(warp_runs)}  # the first run of each configuration
    chunk_equal = {"C=A": episodes_equal(first["C"]["out"], first["A"]["out"]),
                   "D=B": episodes_equal(first["D"]["out"], first["B"]["out"])}
    default = next(k for k, m in configs.items() if m == card_modes)
    prof = profile_run(lambda: run_path(name, over, torch.float32, BATCH, ticks))

    def summary(r):
        return dict(episode_s=r["total"], kernel_ms=stats_ms(r["kernel_ms"]),
                    tick0_kernel_ms=r["kernel_ms"][0],
                    final_ego_x_mean=float(r["out"][0][-1, :, 0].mean()))

    # each pair: a configuration's warp and thread runs, in run order
    pairs = []
    for key in compared:
        warp = [r for r in runs if r["key"] == key and r["kernel"] == "warp"]
        thread = [r for r in runs if r["key"] == key and r["kernel"] == "thread"]
        for i, (rw, rt) in enumerate(zip(warp, thread)):
            pairs.append(dict(config=key, pair=i, warp=summary(rw), thread=summary(rt),
                              thread_over_warp_episode=rt["total"] / rw["total"],
                              thread_over_warp_kernel_ms=(sum(rt["kernel_ms"])
                                                          / sum(rw["kernel_ms"]))))
    say("phase6_modes_timing_main", card=card, scenario=name, ticks=ticks,
        configs={k: m._asdict() for k, m in configs.items()},
        order=[f"{r['key']}_{r['kernel']}" for r in runs],
        variants=[r["variant"] for r in warp_runs], episode_s=[r["total"] for r in warp_runs],
        kernel_ms_per_tick=[stats_ms(r["kernel_ms"]) for r in warp_runs],
        tick0_kernel_ms=[r["kernel_ms"][0] for r in warp_runs],
        final_ego_x_mean=[float(r["out"][0][-1, :, 0].mean()) for r in warp_runs],
        chunk_bitwise_serial=chunk_equal, card_default=default, profiled_default=prof)
    say("phase6_warp_vs_thread_main", card=card, scenario=name, ticks=ticks, pairs=pairs)
    check(all(chunk_equal.values()), f"main: chunked episodes differ from serial: {chunk_equal}")
    for pair in pairs:
        if pair["config"] == default:
            check(pair["warp"]["episode_s"] < pair["thread"]["episode_s"],
                  f"main {default}: the warp kernel is not faster than the thread kernel: {pair}")
    compaction_run("main", card, first[default]["out"], first[default]["variant"], launches_total)
    # the fold, composed with the card's modes (ILQR_PROJ_FOLD=1 in the JAX package)
    cfg, out, total, launches, inputs = run_path(name, over, torch.float32, BATCH, ticks,
                                                 modes=card_modes._replace(proj_fold=True))
    launches_total.update(launches)
    path_gates("main", card, cfg, out, total, launches, inputs, "_fold")
    return first[default]["out"]


def phase_path(path, card, launches_total):
    """4: a path in the card's modes, and with its schedule when it has one;
    returns the episode without the schedule."""
    import torch

    name, over, ticks = PATHS[path]
    cfg, out, total, launches, inputs = run_path(name, over, torch.float32, BATCH, ticks)
    launches_total.update(launches)
    variant = path_gates(path, card, cfg, out, total, launches, inputs, "")
    if path in SCHEDULES:
        compaction_run(path, card, out, variant, launches_total)
    return out


def card_variant(cfg):
    """The float32 kernel a path of ``cfg`` launches in the card's modes."""
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    return ck.variant(cfg, torch.float32, ck.resolve_modes(DEVICE))


def graph_run(path, driver, schedule=None):
    """``path`` (float32, batch 8192, the card's modes) through the graph
    driver ``driver`` of ``run_path``: (cfg, episode, seconds, launches)."""
    import torch

    name, over, ticks = PATHS[path]
    cfg, out, total, launches, _ = run_path(name, over, torch.float32, BATCH, ticks, schedule,
                                            driver=driver)
    return cfg, out, total, launches


def graph_gates(tag, path, cfg, out, ref, launches, schedule=None):
    """A graph driver's episode against the host loop's on the same path:
    bitwise equal (the duals when both have them), finite, the main path
    at its anchor, and only this path's kernels launched. Returns the
    printable fields."""
    import torch

    variant = card_variant(cfg)
    n = min(len(out), len(ref))
    equal = episodes_equal(out[:n], ref[:n])
    final_x = float(out[0][-1, :, 0].mean())
    check(equal, f"{tag}: the graph driver's episode differs from run_mpc_kernel's")
    check(bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()),
          f"{tag}: non-finite episode")
    check(launches.get(variant, 0) >= out[1].shape[0]
          and set(launches) <= {variant, variant + "_resume"},
          f"{tag}: launches {launches} in {out[1].shape[0]} ticks")
    if schedule:
        check(launches.get(variant + "_resume", 0) > 0, f"{tag}: no resume launch")
    if path == "main":
        check(abs(final_x - EGO_X_ANCHOR) <= EGO_X_TOL,
              f"{tag}: final_ego_x_mean {final_x:.4f} not within {EGO_X_TOL} of {EGO_X_ANCHOR}")
    return dict(bitwise_host_loop=equal, duals_compared=n == 4, final_ego_x_mean=final_x,
                launches=launches)


def abba(first, second, pairs=2):
    """Time ``first`` and ``second`` (each returns (episode, seconds,
    launches)) in the order first, second, second, first per two pairs:
    [(first's seconds, second's seconds), ...] in run order, and every
    run's launches."""
    times, launches = [], []
    for i in range(pairs):
        order = (first, second) if i % 2 == 0 else (second, first)
        got = {}
        for fn in order:
            _, sec, lau = fn()
            got[fn] = sec
            launches.append(lau)
        times.append((got[first], got[second]))
    return times, launches


def phase_graph(card, launches_total, host_loop):
    """8: the graph-captured episode program. The main path through
    ``run_mpc_kernel_chunked`` (chunks of 10) and ``run_mpc_kernel_scan``
    (every tick one graph), path (a) with its schedule and path (b) with
    its duals, each bitwise equal to the host loop's episode of phases
    3-4; the host loop against the chunked driver on the main path in
    ABBA pairs (the graph driver must win every pair), each profiled once
    (kernel sum, busy time, idle share against the unprofiled wall);
    compaction off/on/on/off through the graph driver on the main path
    (bench schedule) and path (a); then the port's bench line."""
    import statistics

    import torch
    from ilqr_tpu_torch.apps import bench

    name, over, ticks = PATHS["main"]
    fields = {}
    runs = {
        "main_chunked": ("main", "chunked", None),
        "main_scan": ("main", "scan", None),
        "a_three_bend_schedule_scan": ("a_three_bend", "scan", SCHEDULES["a_three_bend"]),
        "b_alm_two_borrow_scan": ("b_alm_two_borrow", "scan", None),
        "b_alm_two_borrow_chunked": ("b_alm_two_borrow", "chunked", None),
    }
    for tag, (path, driver, schedule) in runs.items():
        cfg, out, sec, launches = graph_run(path, driver, schedule)  # captures
        cfg, again, sec2, launches2 = graph_run(path, driver, schedule)  # replays
        launches_total.update(launches)
        launches_total.update(launches2)
        fields[tag] = dict(graph_gates(tag, path, cfg, out, host_loop[path], launches, schedule),
                           first_call_s=sec, replay_s=sec2, replay_launches=launches2,
                           replay_bitwise_first=episodes_equal(out, again))
        check(fields[tag]["replay_bitwise_first"], f"{tag}: a replay differs from the capture")
        if schedule is None:
            check(launches2 == {card_variant(cfg): out[1].shape[0]},
                  f"{tag}: replay launches {launches2} in {out[1].shape[0]} ticks")
    say("phase8_graph_bitwise", card=card, chunk=GRAPH_CHUNK, runs=fields)

    def host():
        cfg, out, sec, launches, _ = run_path(name, over, torch.float32, BATCH, ticks)
        launches_total.update(launches)
        return out, sec, launches

    def graph():
        cfg, out, sec, launches = graph_run("main", "chunked")
        launches_total.update(launches)
        return out, sec, launches

    times, run_launches = abba(host, graph)
    prof_host = profile_run(host)
    prof_graph = profile_run(graph)
    walls = {"host_loop": [h for h, _ in times], "graph_chunked": [g for _, g in times]}
    drivers = {}
    for key, prof in (("host_loop", prof_host), ("graph_chunked", prof_graph)):
        wall = statistics.median(walls[key])
        busy = prof["device_busy_s"]
        drivers[key] = dict(wall_s=walls[key], wall_median_s=wall,
                            solves_per_s=BATCH * ticks / wall,
                            profiled_solve_kernel_ms=prof["solve_kernel_ms"],
                            profiled_busy_s=busy, profiled_wall_s=prof["wall_s"],
                            idle_share_unprofiled=None if busy is None else 1.0 - busy / wall,
                            top_device_ms=prof["top_device_ms"])
    say("phase8_graph_vs_host_loop_main", card=card, scenario=name, ticks=ticks, batch=BATCH,
        order="host graph graph host", pairs_s=times, run_launches=run_launches,
        graph_wins_every_pair=all(g < h for h, g in times), drivers=drivers)
    check(all(g < h for h, g in times),
          f"main: the graph driver is not faster than the host loop in every pair: {times}")

    # compaction through the graph driver: off/on/on/off, the first call
    # of each captured beforehand
    comp = {}
    for path, driver in (("main", "chunked"), ("a_three_bend", "scan")):
        schedule = SCHEDULES[path]
        _, off_out, _, lau_off = graph_run(path, driver)
        _, on_out, _, lau_on = graph_run(path, driver, schedule)
        launches_total.update(lau_off)
        launches_total.update(lau_on)
        check(episodes_equal(off_out, on_out), f"{path}: compaction through the graph differs")

        def off(path=path, driver=driver):
            _, out, sec, lau = graph_run(path, driver)
            launches_total.update(lau)
            return out, sec, lau

        def on(path=path, driver=driver, schedule=schedule):
            _, out, sec, lau = graph_run(path, driver, schedule)
            launches_total.update(lau)
            return out, sec, lau

        times_c, lau_c = abba(off, on)
        comp[path] = dict(driver=driver, schedule=schedule, pairs_off_on_s=times_c,
                          launches=lau_c, on_wins_every_pair=all(b < a for a, b in times_c))
    say("phase8_graph_compaction", card=card, order="off on on off", **comp)

    result, aux = bench.measure()
    say("phase8_bench", line=result, **aux)
    check(result["metric"] == "cilqr_mpc_solves_per_sec" and result["value"] > 0,
          f"bench: {result}")
    check(abs(aux["final_ego_x_mean"] - EGO_X_ANCHOR) <= EGO_X_TOL, f"bench: {aux}")


def phase_sweep(card, launches_total):
    """9: the sweep entry point and the parallel layer. ``apps.sweep.main``
    on the main path's scenario (batch 8192, 4 steps, kernel engine, window
    384, its default schedule): each step's stats bitwise equal to
    ``cilqr_solve_cuda`` called directly on the step's starts, one launch a
    step; on step 0's starts the bench's schedule (8, 16, 32) bitwise equal
    to one launch, and the two timed off, on, on, off (5 solves each); one
    step profiled; a one-rank NCCL group (file rendezvous):
    ``sharded_kernel_solve_fn``'s all-reduced summary equal to the local
    ``aggregate_stats``; and
    ``run_mpc_chunked_sharded`` on a one-card mesh bitwise equal to
    ``run_mpc_kernel_chunked`` on the main path (30 ticks). Every launch of
    the phase counts in ``launches_total``."""
    import dataclasses
    import statistics
    import tempfile

    import torch
    import torch.distributed as dist
    from ilqr_tpu_torch.apps import sweep
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.parallel import (aggregate_stats, make_mesh, run_mpc_chunked_sharded,
                                         sharded_kernel_solve_fn)
    from ilqr_tpu_torch.parallel.mesh import initialize_distributed
    from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_chunked

    def fields(stats):
        return [getattr(stats, f.name) for f in dataclasses.fields(stats)]

    t_phase = time.perf_counter()
    name, over, _ = PATHS["main"]
    steps = []
    torch.cuda.synchronize()
    ck.launches.clear()
    rc = sweep.main(["-c", str(REPO / "configs" / f"{name}.yaml"), "--batch", str(BATCH),
                     "--steps", str(SWEEP_STEPS), "--engine", "kernel", "--window", "384",
                     "--device", DEVICE],
                    on_step=lambda step, stats, summary, sec: steps.append(
                        (step, [t.clone() for t in fields(stats)], summary, sec)))
    torch.cuda.synchronize()
    sweep_launches = dict(ck.launches)
    check(rc == 0 and [s[0] for s in steps] == list(range(SWEEP_STEPS)),
          f"sweep: rc {rc}, steps {[s[0] for s in steps]}")
    st, cfg, w, _, rows = vk.problem(name, BATCH, torch.float32, DEVICE)
    sc = st.device_scenario(tick=0, dtype=torch.float32, device=DEVICE, batch=BATCH)
    kw = dict(window=384, proj_rows_per_step=rows)
    default = sweep.parse_caps(sweep.DEFAULT_STRAGGLER_CAP)

    def starts(step):
        return torch.as_tensor(sweep.step_starts(st.ego_x0, BATCH, step), dtype=torch.float32,
                               device=DEVICE)

    def direct(step, caps=default):
        return ck.cilqr_solve_cuda(cfg, w, starts(step), sc, straggler_cap=caps, **kw)

    stats_bitwise = [all(torch.equal(a, b) for a, b in zip(got, fields(direct(step)[2])))
                     for step, got, _, _ in steps]
    variant = card_variant(cfg)
    rates = [BATCH / sec for _, _, _, sec in steps]

    one, comp = direct(0, 0), direct(0, COLD_CAPS)
    comp_bitwise = all(torch.equal(a, b) for a, b in zip(
        list(one[:2]) + fields(one[2]), list(comp[:2]) + fields(comp[2])))

    def timed(caps, reps=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            direct(0, caps)
        torch.cuda.synchronize()
        return None, (time.perf_counter() - t0) / reps, None

    pairs, _ = abba(lambda: timed(0), lambda: timed(COLD_CAPS))
    winner = ("one_launch" if all(a < b for a, b in pairs)
              else "compaction" if all(b < a for a, b in pairs) else "split")

    # one sweep step (the sharded solve and its summary on the host) under
    # the profiler: where its time goes
    step_fn = sharded_kernel_solve_fn(make_mesh(), cfg, straggler_cap=default, **kw)
    x0_1 = starts(1)
    step_fn(w, x0_1, sc)
    prof = profile_run(lambda: torch.stack(list(step_fn(w, x0_1, sc)[3].values())).tolist())

    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", num_processes=1, process_id=0)
        try:
            backend = dist.get_backend()
            mesh = make_mesh()
            _, _, nccl_stats, summary = sharded_kernel_solve_fn(
                mesh, cfg, straggler_cap=default, **kw)(w, starts(0), sc)
            local = aggregate_stats(nccl_stats)
            nccl_equal = set(summary) == set(local) and all(
                torch.equal(summary[k], local[k]) for k in local)
            nccl_summary = {k: float(v) for k, v in summary.items()}
        finally:
            dist.destroy_process_group()

    st_m, cfg_m, w_m, x0_m, rows_m = vk.problem(name, BATCH, torch.float32, DEVICE, **over)
    sc_m = st_m.device_scenario(tick=0, dtype=torch.float32, device=DEVICE, batch=BATCH)
    obs = torch.as_tensor(st_m.obs_preds_array(), device=DEVICE).to(torch.float32)
    args = (x0_m, sc_m.ref_line, sc_m.ref_velo, obs.expand(BATCH, *obs.shape), sc_m.road_borders)
    ep_kw = dict(chunk=GRAPH_CHUNK, window=384, proj_rows_per_step=rows_m, w_back=24)
    sharded = run_mpc_chunked_sharded(make_mesh(), cfg_m, w_m, *args, ticks=SWEEP_EPISODE_TICKS,
                                      **ep_kw)
    single = run_mpc_kernel_chunked(cfg_m, w_m, *args, SWEEP_EPISODE_TICKS, **ep_kw)
    episode_equal = episodes_equal(sharded, single)
    torch.cuda.synchronize()
    phase_launches = dict(ck.launches)
    launches_total.update(phase_launches)
    say("phase9_sweep", card=card, scenario=name, batch=BATCH, steps=SWEEP_STEPS,
        default_straggler_cap=sweep.DEFAULT_STRAGGLER_CAP, variant=variant,
        step_seconds=[sec for _, _, _, sec in steps], step_solves_per_s=rates,
        cold_solves_per_sec=statistics.mean(rates[1:]),
        mean_iters=[s["mean_iters"] for _, _, s, _ in steps],
        converged_frac=[s["converged_frac"] for _, _, s, _ in steps],
        sweep_launches=sweep_launches, stats_bitwise_direct=stats_bitwise,
        compaction=dict(caps=COLD_CAPS, bitwise_one_launch=comp_bitwise,
                        max_iters=int(one[2].iters.max()), order="off on on off",
                        pairs_off_on_s=[(a, b) for a, b in pairs], wins_both_pairs=winner),
        profiled_step=prof,
        nccl=dict(backend=backend, world_size=1, summary_equals_local=nccl_equal,
                  summary=nccl_summary),
        sharded_episode=dict(ticks=SWEEP_EPISODE_TICKS, mesh_devices=1,
                             bitwise_run_mpc_kernel_chunked=episode_equal,
                             final_ego_x_mean=float(sharded[0][-1, :, 0].mean())),
        launches=phase_launches, phase_s=time.perf_counter() - t_phase)
    check(sweep_launches.get(variant) == SWEEP_STEPS
          and set(sweep_launches) <= {variant, variant + "_resume"},
          f"sweep: launches {sweep_launches} in {SWEEP_STEPS} steps")
    check(all(stats_bitwise), f"sweep: stats differ from direct solves: {stats_bitwise}")
    check(comp_bitwise, f"sweep: compaction {COLD_CAPS} differs from one launch")
    check(backend == "nccl" and nccl_equal, f"sweep: {backend} summary {nccl_summary} differs "
          "from the local aggregate")
    check(episode_equal, "sweep: run_mpc_chunked_sharded differs from run_mpc_kernel_chunked")


def plain_episode(cfg, w, x0, sc, obs_b, rows, modes, ticks, window=384, w_back=24):
    """The same episodes through the plain version on the card, written
    out independently of ``run_mpc_kernel``: each tick solves on the
    prediction window at that tick from the shifted previous controls and,
    in ALM mode, the previous duals (both only under use_last_solution),
    in ``modes``, and applies the second planned state. Returns (ego, u,
    iters, status, final (mu, rho) or None)."""
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
        p = ck.pack_problem(cfg, ego, scenario, window, u_init, w_back, rows, mu0, rho0, modes)
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


def phase_episode_f64(case, batch=EPISODE_F64_BATCH, ticks=EPISODE_F64_TICKS):
    import torch
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    name, over = EPISODES_F64[case]
    cfg, ko, k_s, launches, inputs = run_path(name, over, torch.float64, batch, ticks,
                                              EPISODE_F64_SCHEDULE)
    t0 = time.perf_counter()
    ego_r, u_r, it_r, st_r, duals_r = plain_episode(cfg, *inputs, ticks)
    torch.cuda.synchronize()
    r_s = time.perf_counter() - t0
    variant = ck.variant(cfg, torch.float64, inputs[-1])
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
        ticks=ticks, schedule=EPISODE_F64_SCHEDULE, modes=inputs[-1]._asdict(),
        rows_iters_status_equal_every_tick=n_same,
        **{f"max_abs_err_{key}": v for key, v in errs.items()}, tol=1e-6,
        kernel_s=k_s, plain_s=r_s, launches=launches, **extra)
    check_schedule_launches(case, variant, launches, ticks, len(F64_CAPS))
    check(n_same >= 0.99 * batch, f"{case}: per-tick iters equal on {n_same}/{batch} rows")
    check(err <= 1e-6, f"{case}: f64 episode max abs err {err:.3e} > 1e-6")
    return launches


# the repro kernels: name -> (what it replaces, float32 rows per column the
# function must read and write, operations per column)
REPROS = {
    "min_resume_echo": ("tools/debug/min_resume_repro.py:18", 9 * 8 + 8, 16 * 8),
    "min_dataflow_k1": ("tools/debug/min_dataflow_repro.py:25", 8 + 64 + 8, 4 * 8),
    "min_dataflow_k2": ("tools/debug/min_dataflow_repro.py:33", 8 + 8 + 8, 8),
    "min_carry": ("tools/debug/min_carry_repro.py:16", 1 + 6 + 8, 1 + 2 * 6),
    "min_zerotrip": ("tools/debug/min_zerotrip_repro.py:14", 6 + 8, 0),  # x0 is not needed
}


# widths at which every repro kernel is held bitwise to its plain version
# on the card, on the repros' inputs and on planted -0 / +-inf / NaN (odd
# ones: a quad straddles two rows), one launch each
REPRO_WIDTHS = (1, 5, 2047, 2048, 2049)
REPRO_REPS = 200
REPRO_BLOCKS = (32, 64, 128)  # blocks timed for every repro kernel
REPRO_OUTS = {"min_dataflow_k1": (64, 8)}  # output rows per column, (8,) for the others


def repro_calls(dr, ins):
    """name -> (kernel, plain version, its arguments) at the repros'
    shapes; ``dataflow_k2`` on ``k1``'s outputs."""
    x, _ = ins["dataflow"]
    x0, res = ins["carry"]
    u1, s1 = dr.dataflow_k1(x)
    return {
        "min_resume_echo": (dr.resume_echo, dr.resume_echo_ref, tuple(ins["resume"])),
        "min_dataflow_k1": (dr.dataflow_k1, dr.dataflow_k1_ref, (x,)),
        "min_dataflow_k2": (dr.dataflow_k2, dr.dataflow_k2_ref, (u1, s1)),
        "min_carry": (dr.carry, lambda a, b: dr.carry_ref(a, b, 2), (x0, res)),
        "min_zerotrip": (dr.zerotrip, lambda a, b: dr.carry_ref(a, b, 0), (x0, res)),
    }


def repro_at_block(dr, name, args, block):
    """A launch of ``name``'s kernel in blocks of ``block`` threads, through
    its C entry (no count): the block sizes' device times."""
    fns, raw_stream, _ = dr._bound()
    entry = "min_carry" if name == "min_zerotrip" else name
    Bp = args[0].shape[1]
    trips = {"min_carry": (2,), "min_zerotrip": (0,)}.get(name, ())
    plan = dr.launch_plan(entry, Bp, block)

    def run():
        outs = [args[0].new_empty((r, Bp)) for r in REPRO_OUTS.get(entry, (8,))]
        err = fns[entry](*(a.data_ptr() for a in (*args, *outs)), Bp, *trips, *plan,
                         raw_stream(0))
        check(err == 0, f"{name} at block {block}: cudaError_t {err}")
        return outs
    return run


def abba_ms(fns, reps=REPRO_REPS):
    """Each of ``fns`` (name -> call) timed per call (CUDA events over
    ``reps`` calls, the launch path included) and on the device (the
    profiler's spans of ``reps`` calls), in the given order and then
    reversed, twice: name -> {"ms": [4], "device_ms": [4]}."""
    from ilqr_tpu_torch.apps import validate_kernel as vk

    got = {k: {"ms": [], "device_ms": []} for k in fns}
    for order in (list(fns), list(fns)[::-1]) * 2:
        for k in order:
            got[k]["ms"].append(vk.time_ms(fns[k], reps)[0])
            got[k]["device_ms"].append(device_ms(fns[k], reps))
    return got


def launch_shapes(fn):
    """[(kernel name, grid, block)] of the device kernels one call of ``fn``
    launches, from ``torch.profiler``'s trace (its kernel events carry
    them)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return [(e["name"][:80], e.get("args", {}).get("grid"), e.get("args", {}).get("block"))
            for e in trace["traceEvents"] if e.get("cat") == "kernel"]


def phase_debug_repros(card):
    """7: each repro flow once with the counts at 0, then each kernel held
    bitwise to its plain version and to the repro's closed form
    (``want_*`` in tools/debug); every kernel (``carry`` with 0, 1, 2
    trips) also at ``REPRO_WIDTHS`` on the repros' inputs and on planted
    ones; each kernel timed against the one library call of its function
    (``dr.LIBRARY``) in the order kernel, library, library, kernel, twice,
    and in blocks of ``REPRO_BLOCKS``; ``torch.add``'s launch shape beside
    ``dataflow_k2``'s."""
    import numpy as np
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk
    from ilqr_tpu_torch.ops.cuda import debug_repros as dr

    t_phase = time.perf_counter()
    ins = dr.repro_inputs(DEVICE)
    x, done = ins["dataflow"]
    x0, res = ins["carry"]
    torch.cuda.synchronize()
    dr.launches.clear()
    got = dict(min_resume_echo=dr.resume_echo(*ins["resume"]), min_dataflow=dr.dataflow(x, done),
               min_carry=dr.carry(x0, res), min_zerotrip=dr.zerotrip(x0, res))
    torch.cuda.synchronize()
    launches = dict(dr.launches)
    check(launches == {name: 1 for name in REPROS}, f"repro launches {launches}")
    u, s = dr.dataflow_k1_ref(x)
    perm = torch.argsort(done, stable=True)
    plain = dict(min_resume_echo=dr.resume_echo_ref(*ins["resume"]),
                 min_dataflow=(dr.dataflow_k2_ref(u[:, perm], s[:, perm])[:, torch.argsort(perm)],
                               u, s),
                 min_carry=dr.carry_ref(x0, res, 2), min_zerotrip=dr.carry_ref(x0, res, 0))
    xn = x.cpu().numpy()
    want_u, want_s = 2.0 * xn + 1.0, 3.0 * xn - 5.0
    closed = dict(
        min_resume_echo=np.array_equal(got["min_resume_echo"].cpu().numpy(),
                                       ins["resume"][-1].cpu().numpy()),
        min_dataflow=(np.array_equal(got["min_dataflow"][1][:8].cpu().numpy(), want_u)
                      and np.array_equal(got["min_dataflow"][2].cpu().numpy(), want_s)
                      and np.array_equal(got["min_dataflow"][0].cpu().numpy(), want_s + want_u)),
        min_carry=np.array_equal(got["min_carry"][:6].cpu().numpy(), res[:6].cpu().numpy()),
        min_zerotrip=np.array_equal(got["min_zerotrip"][:6].cpu().numpy(),
                                    res[:6].cpu().numpy()))
    for key in got:
        a = got[key] if isinstance(got[key], tuple) else (got[key],)
        b = plain[key] if isinstance(plain[key], tuple) else (plain[key],)
        check(all(torch.equal(p, q) for p, q in zip(a, b)), f"{key}: kernel differs from plain")
        check(closed[key], f"{key}: differs from the repro's closed form")
    # every kernel at odd widths, on the repros' inputs and planted ones,
    # bitwise (int32 views; the card's NaN is one), one launch each
    widths = {}
    for bp in REPRO_WIDTHS:
        for planted in (False, True):
            w_ins = dr.repro_inputs(DEVICE, bp, planted)
            wx0, wres = w_ins["carry"]
            echo, wx = w_ins["resume"], w_ins["dataflow"][0]
            wu, ws = dr.dataflow_k1_ref(wx)
            cases = [(f"carry_{t}", lambda t=t: (dr.carry_trips(wx0, wres, t),),
                      (dr.carry_ref(wx0, wres, t),)) for t in (0, 1, 2)]
            cases += [("resume_echo", lambda: (dr.resume_echo(*echo),),
                       (dr.resume_echo_ref(*echo),)),
                      ("dataflow_k1", lambda: dr.dataflow_k1(wx), (wu, ws)),
                      ("dataflow_k2", lambda: (dr.dataflow_k2(wu, ws),),
                       (dr.dataflow_k2_ref(wu, ws),))]
            for tag, fn, want in cases:
                before = sum(dr.launches.values())
                out = fn()
                torch.cuda.synchronize()
                check(sum(dr.launches.values()) - before == 1, f"{tag} at {bp}: not one launch")
                check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                          for a, b in zip(out, want)),
                      f"{tag} at {bp} columns ({'planted' if planted else 'repro'} inputs) "
                      "differs from its plain version")
        widths[bp] = "bitwise, repro and planted"
    calls = repro_calls(dr, ins)
    for name, (kernel, ref, args) in calls.items():
        lib = dr.LIBRARY[name]
        if lib is not None:
            check(torch.equal(lib(*args).view(torch.int32), ref(*args).view(torch.int32)),
                  f"{name}: the library call is not its function")
    blocks = {}
    for name in ("min_resume_echo", "min_dataflow_k1", "min_dataflow_k2", "min_carry",
                 "min_zerotrip"):
        args = calls[name][2]
        blocks[name] = [(b, device_ms(repro_at_block(dr, name, args, b), REPRO_REPS))
                        for b in REPRO_BLOCKS + REPRO_BLOCKS[::-1]]
    kernels, timing = [], {}
    for name, (kernel, ref, args) in calls.items():
        fns = {"kernel": lambda k=kernel, a=args: k(*a)}
        lib = dr.LIBRARY[name]
        if lib is not None:
            fns["library"] = lambda f=lib, a=args: f(*a)
        runs = abba_ms(fns)
        timing[name] = runs
        plain_ms, _ = vk.time_ms(lambda r=ref, a=args: r(*a), REPRO_REPS)
        replaces_, rows, ops = REPROS[name]
        t_bytes = rows * dr.BP * 4 / PEAK_BYTES * 1e3
        t_ops = ops * dr.BP / PEAK_OPS["f32"] * 1e3
        mean = {k: {m: float(np.mean(v[m])) for m in v} for k, v in runs.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": REPRO_SOURCE, "replaces": replaces_,
            "launches": launches[name], "max_abs_err": 0.0, "ms": mean["kernel"]["ms"],
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": mean["library"]["ms"] if lib else None,
            "device_ms": mean["kernel"]["device_ms"],
            "library_device_ms": mean["library"]["device_ms"] if lib else None,
            "batch": dr.BP, "block": dr.launch_plan(
                "min_carry" if name == "min_zerotrip" else name, dr.BP)[1]})
    # the fallback of device_ms on every kernel, beside the profiler's time
    queued = {name: queued_ms(lambda k=kernel, a=args: k(*a), REPRO_REPS)
              for name, (kernel, _, args) in calls.items()}
    _, _, k2_args = calls["min_dataflow_k2"]
    shapes = {"min_dataflow_k2": launch_shapes(lambda: dr.dataflow_k2(*k2_args)),
              "torch.add": launch_shapes(lambda: dr.LIBRARY["min_dataflow_k2"](*k2_args))}
    say("phase7_debug_repros", card=card, launches=launches, bitwise_plain=True,
        closed_form=closed, widths_bitwise=widths, order="AB BA AB BA", timing=timing,
        block_device_ms=blocks, launch_shapes=shapes, queued_ms=queued,
        profiler_misses=dict(profiler_misses),
        phase_s=time.perf_counter() - t_phase, kernels=kernels)
    return kernels


# phase 10: batches of the demos and the eager options (float64)
LQR_BATCH = 8192
TRACKING_BATCH = 1024
DEMO_BATCH = 4096
PSCAN_BATCH = 1024
HIER_BATCH = 64
BACKWARD_REPS = 20
CPU_ROWS = 16  # rows of (a) run again on the CPU
LQR_RTOL = LQR_ATOL = 1e-10
# the full demo solve's bars, as tests/test_torch_cilqr_demo.py states them
DEMO_J_RTOL = 1e-3
DEMO_X_ATOL = 0.03
SCENARIOS = ("scenario_two_straight", "scenario_two_borrow", "scenario_three_straight",
             "scenario_three_bend")
APPS_TIMEOUT_S = 300


def oracle_dare(A, B, Q, R, max_iter=150, eps=0.01):
    """The fixed-point iteration in numpy (tests/test_demos.py:21)."""
    import numpy as np

    p = Q
    for _ in range(max_iter):
        p_next = A.T @ p @ A - A.T @ p @ B @ np.linalg.inv(R + B.T @ p @ B) @ B.T @ p @ A + Q
        if np.abs(p_next - p).max() < eps:
            return p_next
        p = p_next
    return p_next


def event_ms(fn, reps):
    """Milliseconds a call of fn over reps calls between CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_cuda(fn):
    """(fn(), seconds), the card synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_err(a, b):
    """max |a - b| / (1 + |b|): under e, a and b are allclose with rtol = atol = e."""
    return float(((a.cpu() - b).abs() / (1.0 + b.abs())).max())


def first_reached(reached):
    """Index of each row's first reached tick (-1: never)."""
    import torch

    return torch.where(reached.any(-1), reached.int().argmax(-1), torch.full_like(
        reached[..., 0], -1, dtype=torch.int64))


def demo_lqr():
    """10a: ``lqr_demo_batch_x0`` over seeded starts of the reference system."""
    import numpy as np
    import torch

    from ilqr_tpu_torch.solvers.lqr import lqr_demo_batch_x0

    f64 = torch.float64
    A0 = np.array([[1.95, -0.025, -1.6], [1.6, 1.1, -3.2], [0.425, 0.185, 0.3]])
    B0 = np.array([[0.0, 1.0], [1.0, 1.0], [0.0, 1.0]])
    system = [torch.as_tensor(a, dtype=f64) for a in (A0, B0, np.eye(3), np.eye(2))]
    x0 = torch.randn((LQR_BATCH, 3), generator=torch.Generator().manual_seed(10), dtype=f64)
    x0[0] = torch.tensor([1.0, 2.0, 3.0])  # the demo's start
    (P, K, ol, cl), wall = timed_cuda(lambda: lqr_demo_batch_x0(
        *(a.to(DEVICE) for a in system), x0.to(DEVICE), steps=50))
    cpu = lqr_demo_batch_x0(*system, x0[:CPU_ROWS], steps=50)
    pairs = dict(P=(P, cpu[0]), K=(K, cpu[1]), open_x=(ol.x, cpu[2].x), closed_x=(cl.x, cpu[3].x),
                 closed_u=(cl.u, cpu[3].u), u_norm=(cl.u_norm, cpu[3].u_norm))
    err = {k: rel_err(a[:CPU_ROWS], b) for k, (a, b) in pairs.items()}
    oracle_err = float(np.abs(P[0].cpu().numpy() - oracle_dare(A0, B0, np.eye(3), np.eye(2))).max())
    rows_same = bool((P == P[:1]).all() and (K == K[:1]).all())
    rec = dict(batch=LQR_BATCH, wall_s=wall, cpu_rows=CPU_ROWS, rel_err=err,
               oracle_err=oracle_err, open_loop_end=float(ol.x[0, -1].abs().max()),
               closed_loop_end=float(cl.x[0, -1].abs().max()))
    say("phase10a_lqr", **rec)
    check(all(e <= LQR_RTOL for e in err.values()), f"(a) lqr_demo on the card differs from "
          f"the CPU run: {err}")
    check(oracle_err < 1e-6 and rows_same, f"(a) P* {oracle_err} from the numpy oracle, rows "
          f"identical {rows_same}")
    check(rec["open_loop_end"] > 1e3 and rec["closed_loop_end"] < 1e-2,
          "(a) the open loop must diverge and the closed loop settle from the demo's start")
    return rec


def demo_tracking():
    """10b: the tracking ``simulate`` over seeded starts, row 0 the demo's."""
    import torch

    from ilqr_tpu_torch.solvers import lqr_tracking as tracking

    f64 = torch.float64
    gen = torch.Generator().manual_seed(11)
    x0 = torch.zeros((TRACKING_BATCH, 4), dtype=f64)
    x0[1:, :2] = 0.5 * torch.randn((TRACKING_BATCH - 1, 2), generator=gen, dtype=f64)
    x0[1:, 2] = 0.1 * torch.randn((TRACKING_BATCH - 1,), generator=gen, dtype=f64)
    course, goal = tracking.make_demo_course(device=DEVICE)
    p = tracking.default_params(device=DEVICE)
    (states, controls, reached), wall = timed_cuda(
        lambda: tracking.simulate(p, course, goal, x0=x0.to(DEVICE)))
    s0, _, r0 = tracking.simulate(tracking.default_params(), tracking.make_demo_course()[0], goal)
    ticks = first_reached(reached.cpu())
    rec = dict(batch=TRACKING_BATCH, wall_s=wall, reached=int((ticks >= 0).sum()),
               first_tick_min_max=[int(ticks.min()), int(ticks.max())],
               row0_tick=int(ticks[0]), row0_tick_cpu=int(first_reached(r0)),
               row0_state_err=float((states[0].cpu() - s0).abs().max()),
               steer_max=float(controls[..., 1].abs().max()), max_steer=float(p.max_steer))
    say("phase10b_tracking", **rec)
    check(rec["row0_tick"] == rec["row0_tick_cpu"] >= 0,
          f"(b) row 0 reached its goal at tick {rec['row0_tick']}, on the CPU {rec['row0_tick_cpu']}")
    check(rec["steer_max"] <= rec["max_steer"] + 1e-9 and bool(states.isfinite().all()),
          f"(b) steering {rec['steer_max']} above max_steer or non-finite states")
    return rec


def demo_cilqr():
    """10c: the demo CILQR over seeded starts; the last row repeats row 0."""
    import torch

    from ilqr_tpu_torch.apps.cilqr_demo import batch_starts
    from ilqr_tpu_torch.solvers import cilqr_demo as demo

    f64 = torch.float64
    p, x0, ref, ref_velo, obs_attrs, obs_preds = demo.demo_scenario(f64, DEVICE)
    starts = batch_starts(x0, DEMO_BATCH)
    starts[0] = starts[-1] = x0
    res, wall = timed_cuda(lambda: demo.solve(p, starts, ref, ref_velo, obs_attrs, obs_preds,
                                              max_iter=50))
    cpu = demo.solve(*demo.demo_scenario(f64), max_iter=50)
    rec = dict(batch=DEMO_BATCH, wall_s=wall, row0_iters=int(res.iters[0]),
               row0_converged=bool(res.converged[0]), row0_J=float(res.J[0]),
               cpu_iters=int(cpu.iters), cpu_converged=bool(cpu.converged), cpu_J=float(cpu.J),
               J_rel=abs(float(res.J[0]) - float(cpu.J)) / abs(float(cpu.J)),
               x_err=float((res.x[0].cpu() - cpu.x).abs().max()),
               twins_bitwise=all(torch.equal(t[0], t[-1]) for t in res),
               converged_frac=float(res.converged.double().mean()),
               mean_iters=float(res.iters.double().mean()))
    say("phase10c_cilqr_demo", **rec)
    check(rec["row0_iters"] == rec["cpu_iters"] and rec["row0_converged"] == rec["cpu_converged"],
          f"(c) row 0's exit differs from the CPU solve's")
    check(rec["J_rel"] <= DEMO_J_RTOL and rec["x_err"] <= DEMO_X_ATOL,
          f"(c) row 0 J off by {rec['J_rel']} (relative), x by {rec['x_err']} m")
    check(rec["twins_bitwise"], "(c) identical rows of the batch differ")
    return rec, cpu


def demo_pscan():
    """10d: ``riccati_impl="pscan"`` against ``"scan"`` in the eager solve."""
    import torch

    from ilqr_tpu_torch.config import GlobalConfig
    from ilqr_tpu_torch.models.bicycle import kinematic_jacobians, rollout
    from ilqr_tpu_torch.ops.cost import cost_and_derivatives
    from ilqr_tpu_torch.ops.riccati import backward_pass
    from ilqr_tpu_torch.ops.riccati_pscan import parallel_lqr_backward
    from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
    from ilqr_tpu_torch.solvers.cilqr import solve
    from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

    f64 = torch.float64
    gc = GlobalConfig.from_file(str(REPO / "configs" / "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    starts = torch.as_tensor(perturbed_initial_states(st.ego_x0, PSCAN_BATCH, seed=0), dtype=f64)
    starts[0] = torch.as_tensor(st.ego_x0)  # the start of tests/test_riccati.py:112

    def run(impl, weights, N=None, max_iter=None):
        base = CILQRConfig.from_global_config(
            gc, **({} if max_iter is None else dict(max_iter=max_iter)))
        cfg = dataclasses.replace(base, N=N or base.N, use_last_solution=False,
                                  riccati_impl=impl)
        sc = st.device_scenario(tick=0, horizon=cfg.N, dtype=f64, device=DEVICE,
                                batch=PSCAN_BATCH)
        return timed_cuda(lambda: solve(cfg, weights, starts.to(DEVICE), sc))

    w0 = CILQRWeights.from_global_config(gc, f64, DEVICE, init_lamb=0.0)
    w = CILQRWeights.from_global_config(gc, f64, DEVICE)

    # the two backward passes alone on the shipped problem's first
    # iteration, scan pscan pscan scan, CUDA events over BACKWARD_REPS calls
    cfg = dataclasses.replace(CILQRConfig.from_global_config(gc), use_last_solution=False)
    sc = st.device_scenario(tick=0, dtype=f64, device=DEVICE, batch=PSCAN_BATCH)
    x0 = starts.to(DEVICE)
    u0 = x0.new_zeros((PSCAN_BATCH, cfg.N, 2))
    x = rollout(x0, u0, w.dt, w.wheelbase, cfg.reference_point)
    _, der = cost_and_derivatives(cfg, w, u0, x, sc)
    A, Bm = kinematic_jacobians(x[:, :-1], u0, w.dt, w.wheelbase, cfg.reference_point)
    lamb = w.init_lamb.expand(PSCAN_BATCH)
    passes = dict(
        scan=lambda: backward_pass(A, Bm, der.l_x, der.l_u, der.l_xx, der.l_uu, lamb),
        pscan=lambda: parallel_lqr_backward(A, Bm, der.l_x, der.l_u, der.l_xx, der.l_uu,
                                            lamb=lamb))
    backward_ms = {"scan": [], "pscan": []}
    for impl in passes:
        passes[impl]()  # warm-up
    for impl in ("scan", "pscan", "pscan", "scan"):
        backward_ms[impl].append(event_ms(passes[impl], BACKWARD_REPS))

    # the solves, each kind warmed up first: lambda 0 scan pscan pscan scan,
    # then the shipped lambda once each
    for impl in ("scan", "pscan"):
        run(impl, w0, N=12, max_iter=1)
    lam0, shipped = {}, {}
    walls = {"scan_lamb0": [], "pscan_lamb0": []}
    for impl in ("scan", "pscan", "pscan", "scan"):
        out, wall = run(impl, w0, N=12, max_iter=20)
        lam0.setdefault(impl, out)
        walls[f"{impl}_lamb0"].append(wall)
    for impl in ("scan", "pscan"):
        shipped[impl], walls[f"{impl}_shipped"] = run(impl, w)

    def close(a, b):
        return ((a - b).abs() <= 1e-8 + 1e-6 * b.abs()).flatten(1).all(1)

    (us, xs, ss, _), (up, xp, sp, _) = lam0["scan"], lam0["pscan"]
    conv = ss.converged | sp.converged
    same_exit = (ss.iters == sp.iters) & (ss.status == sp.status)
    same_path = close(up, us) & close(xp, xs)
    cs, cp = (shipped[k][2].converged for k in ("scan", "pscan"))
    both = cs & cp
    cost_rel = ((shipped["pscan"][2].final_cost - shipped["scan"][2].final_cost).abs()
                / shipped["scan"][2].final_cost.abs())[both]
    pos = (shipped["pscan"][1] - shipped["scan"][1]).abs()[both]
    rec = dict(
        batch=PSCAN_BATCH, walls_s=walls,
        pscan_over_scan=dict(lamb0=sum(walls["pscan_lamb0"]) / sum(walls["scan_lamb0"]),
                             shipped=walls["pscan_shipped"] / walls["scan_shipped"],
                             backward=sum(backward_ms["pscan"]) / sum(backward_ms["scan"])),
        backward_ms_abba=backward_ms,
        lamb0=dict(converged_rows=int(conv.sum()), same_path=int((conv & same_path).sum()),
                   same_exit=int((conv & same_exit).sum()),
                   row0_same=bool(same_exit[0] and same_path[0]),
                   exit_differs=[[int(ss.iters[i]), int(sp.iters[i]), int(ss.status[i]),
                                  int(sp.status[i])]
                                 for i in torch.nonzero(conv & ~same_exit).flatten().tolist()]),
        shipped=dict(converged_scan=float(cs.double().mean()),
                     converged_pscan=float(cp.double().mean()),
                     mean_iters_scan=float(shipped["scan"][2].iters.double().mean()),
                     mean_iters_pscan=float(shipped["pscan"][2].iters.double().mean()),
                     median_cost_rel=float(cost_rel.median()) if both.any() else None,
                     median_pos=float(pos.median()) if both.any() else None))
    say("phase10d_pscan", **rec)
    check(rec["lamb0"]["row0_same"], "(d) lambda 0: the test's own start differs")
    check(bool(same_path[conv].all()), f"(d) lambda 0: {int((conv & ~same_path).sum())} "
          "converged rows end on other trajectories under pscan and scan")
    sh = rec["shipped"]
    check(sh["converged_scan"] > 0.4 and both.any()
          and abs(sh["converged_pscan"] - sh["converged_scan"]) <= 0.15
          and sh["median_cost_rel"] < 1e-2 and sh["median_pos"] < 0.05,
          f"(d) at the shipped lambda: {sh}")
    return rec


def hier_case(name):
    """10e, one scenario (run in its own process by ``demo_hier``): the
    eager solve with ``projection="hier"`` against ``"exact"``, cold, batch
    ``HIER_BATCH``; prints one JSON line."""
    import torch

    from ilqr_tpu_torch.config import GlobalConfig
    from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
    from ilqr_tpu_torch.solvers.cilqr import solve
    from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

    f64 = torch.float64
    gc = GlobalConfig.from_file(str(REPO / "configs" / f"{name}.yaml"))
    st = build_scenario_setup(gc)
    w = CILQRWeights.from_global_config(gc, f64, DEVICE)
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, HIER_BATCH, seed=0), dtype=f64,
                         device=DEVICE)
    sc = st.device_scenario(tick=0, dtype=f64, device=DEVICE, batch=HIER_BATCH)
    outs, walls = [], []
    for proj in ("exact", "hier"):
        cfg = dataclasses.replace(CILQRConfig.from_global_config(gc, projection=proj),
                                  use_last_solution=False)
        (u, x, stats, _), wall = timed_cuda(lambda: solve(cfg, w, x0, sc))
        outs.append([u, x, *(getattr(stats, f.name) for f in dataclasses.fields(stats))])
        walls.append(wall)
    print(json.dumps(dict(name=name, bitwise=all(torch.equal(a, b) for a, b in zip(*outs)),
                          walls_exact_hier_s=walls, mean_iters=float(outs[0][2].double().mean()))),
          flush=True)


def start_hier():
    """10e: one process a scenario, on the card together."""
    return {name: subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.hier_case({name!r})"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in SCENARIOS}


def check_hier(procs, t_start):
    """10e: every scenario's hier solve bitwise its exact one."""
    cases = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=APPS_TIMEOUT_S)
        check(proc.returncode == 0, f"(e) {name} exited {proc.returncode}: {err[-2000:]}")
        cases[name] = json.loads(out.strip().splitlines()[-1])
    rec = dict(batch=HIER_BATCH, wall_s=time.perf_counter() - t_start, cases=cases)
    say("phase10e_hier", **rec)
    check(all(c["bitwise"] for c in cases.values()), f"(e) hier differs from exact: {cases}")
    return rec


def start_apps():
    """10f: the three demo apps, headless, as subprocesses on the card."""
    return {name: subprocess.Popen(
        [sys.executable, "-m", f"ilqr_tpu_torch.apps.{name}", "--no-viz", "--device", DEVICE],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("lqr_demo", "lqr_tracking", "cilqr_demo")}


def check_apps(procs, t_start, tick0, cpu_demo):
    """10f: each app's exit and lines, against the CPU runs' numbers."""
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=APPS_TIMEOUT_S)
        out[name] = (proc.returncode, stdout, stderr)
    rec = dict(wall_s=time.perf_counter() - t_start,
               last_lines={name: (o.strip() or e.strip()).rpartition("\n")[2]
                           for name, (_, o, e) in out.items()})
    say("phase10f_apps", **rec)
    for name, (rc, _, err) in out.items():
        check(rc == 0, f"(f) {name} exited {rc}: {err[-2000:]}")
    lqr = out["lqr_demo"][1]
    check("Pstar =" in lqr and "Kstar =" in lqr, f"(f) lqr_demo printed {lqr!r}")
    goal = f"goal reached after {tick0 + 1} ticks"
    check(goal in out["lqr_tracking"][1], f"(f) lqr_tracking printed "
          f"{out['lqr_tracking'][1]!r}, expected {goal!r}")
    m = re.search(r"iters=(\d+) converged=(\w+) J=([0-9.eE+-]+)", out["cilqr_demo"][2])
    check(m is not None and int(m.group(1)) == int(cpu_demo.iters)
          and m.group(2) == str(bool(cpu_demo.converged))
          and abs(float(m.group(3)) - float(cpu_demo.J)) <= DEMO_J_RTOL * abs(float(cpu_demo.J)),
          f"(f) cilqr_demo logged {out['cilqr_demo'][2][-500:]!r}")
    return rec


def phase_demos(card):
    """10: the pedagogical track and the eager solver's options on the card
    (module docstring, phase 10); one line a path, then the phase's."""
    t_phase = time.perf_counter()
    a = demo_lqr()
    b = demo_tracking()
    c, cpu_demo = demo_cilqr()
    d = demo_pscan()
    # (e) and (f) run together, one process a scenario or an app: every
    # timed path is done
    t_procs = time.perf_counter()
    hier, apps = start_hier(), start_apps()
    try:
        e = check_hier(hier, t_procs)
        f = check_apps(apps, t_procs, b["row0_tick_cpu"], cpu_demo)
    finally:
        for proc in [*hier.values(), *apps.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    walls = dict(a_lqr=a["wall_s"], b_tracking=b["wall_s"], c_cilqr_demo=c["wall_s"],
                 **{f"d_{k}": v for k, v in d["walls_s"].items()},
                 d_backward_ms=d["backward_ms_abba"],
                 e_f_processes_together=f["wall_s"])
    say("phase10_demos", card=card, walls_s=walls, phase_s=time.perf_counter() - t_phase,
        pscan_over_scan=d["pscan_over_scan"])


# phase 11: the dry run and the port's surface on the card
DRYRUN_DEVICES = 1  # one card
# the yaml-parameter sweep of tests/test_cilqr.py:135-162, float64
SWEEP_ROWS = dict(w_yaw=(20.0, 5.0, 80.0), stl_lim=(0.12, 0.3, 0.05))
SWEEP_MAX_ITER = 15
ROW_ATOL = 1e-9
DRYRUN_REPS = 20
# the card's kernel against its plain version on the card, float32, 3
# iterations a solve: the largest abs difference of u, x, ego and mu on any
# row and tick. The ALM legs read <= 5.7e-5 (mu of (d), |mu| <= 7.3) on an
# H100. Leg (b)'s cold barrier solve ends row 0 at a cost near 7.9e3,
# where float32 rounding moves the result: u 2.0e-3 and the final cost
# 2.8e-3 relative, the order of the plain version's own float32-to-float64
# differences (``plain_f32_vs_f64`` in the phase's line: 4.1e-3, 2.5e-3).
DRYRUN_ALM_ATOL = 5e-4
DRYRUN_BARRIER_ATOL = 1e-2
DRYRUN_COST_RTOL = 1e-2  # leg (b)'s final cost, relative


def dryrun_records(card_launches):
    """11: the kernel against its plain version on leg (d)'s first tick
    (the ALM instantiation, cold, batch of the dry run, the card's modes) and
    its resume entry at the leg's cap; records for the kernels line."""
    from ilqr_tpu_torch.apps import dryrun as dr
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    cfg_e, w, x0, sc, _ = dr._problems(dr.ROWS_PER_DEVICE * DRYRUN_DEVICES, DEVICE)["d"]
    p = ck.pack_problem(cfg_e, x0, sc, dr.WINDOW, modes=ck.resolve_modes(DEVICE))
    _, _, rec = against_plain(cfg_e, w, p, DRYRUN_REPS)
    records = [rec]
    resume = resume_measure(cfg_e, w, p, (dr.STRAGGLER_CAP, cfg_e.max_iter), DRYRUN_REPS)
    if resume is not None:
        records.append(resume)
    check({r["variant"] for r in records} >= {v for v in card_launches if "_alm" in v},
          f"dry run: ALM kernels launched {sorted(card_launches)} but measured "
          f"{[r['variant'] for r in records]}")
    return records


def dryrun_against_plain(legs):
    """11: the card's legs (b)-(d) held to the plain version on the card, on
    the same inputs in the card's modes: (b) one cold solve; (c) and (d) the
    warm ALM episodes tick by tick (``plain_episode``), and (d)'s final
    duals (the same episode through ``run_mpc_kernel_scan``, which returns
    its carry and must be bitwise leg (d)). Every row of every tick must
    end at the plain version's iteration and status."""
    import torch
    from ilqr_tpu_torch.apps import dryrun as dr
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.sim.mpc import run_mpc_kernel_scan

    P = dr._problems(dr.ROWS_PER_DEVICE * DRYRUN_DEVICES, DEVICE)
    modes = ck.resolve_modes(DEVICE)
    out = {}
    cfg_k, w_k, x0_k, sc_k = P["b"]
    r = ck.cilqr_solve_ref(cfg_k, w_k, ck.pack_problem(cfg_k, x0_k, sc_k, dr.WINDOW,
                                                       modes=modes))
    u, x, stats, _ = legs["b"]
    cost_r = r.stats[4]
    out["b"] = dict(
        rows_iters_status_equal=int(((stats.iters == r.stats[0])
                                     & (stats.status == r.stats[1])).sum()),
        rows=int(u.shape[0]),
        max_abs_err=dict(u=float((u - r.u.permute(2, 1, 0)).abs().max()),
                         x=float((x - r.x.permute(2, 1, 0)).abs().max())),
        cost_relerr=float(((stats.final_cost - cost_r).abs()
                           / cost_r.abs().clamp_min(1e-3)).max()))
    # the plain version's own float32 rounding at this solve: against its
    # float64 run on the same problem
    _, cfg64, w64, x64, sc64 = dr.build_problem(torch.float64, u.shape[0], dr.MAX_ITER, DEVICE,
                                                horizon=dr.KERNEL_N)
    r64 = ck.cilqr_solve_ref(cfg64, w64, ck.pack_problem(cfg64, x64, sc64, dr.WINDOW,
                                                         modes=modes))
    out["b"]["plain_f32_vs_f64"] = dict(
        u=float((r.u.double() - r64.u).abs().max()),
        cost_relerr=float(((cost_r.double() - r64.stats[4]).abs()
                           / r64.stats[4].abs().clamp_min(1e-3)).max()))
    for leg, ticks in (("c", dr.EPISODE_TICKS), ("d", dr.CHUNKED_TICKS)):
        cfg_e, w_e, x0_e, sc_e, obs_e = P[leg]
        ego_r, u_r, it_r, st_r, (mu_r, rho_r) = plain_episode(
            cfg_e, w_e, x0_e, sc_e, obs_e, 0, modes, ticks, window=dr.WINDOW, w_back=ck.W_BACK)
        ego, us, stats = legs[leg]
        out[leg] = dict(
            rows_iters_status_equal_every_tick=int(((stats.iters == it_r)
                                                    & (stats.status == st_r)).all(0).sum()),
            rows=int(ego.shape[1]), ticks=ticks,
            max_abs_err=dict(ego=float((ego - ego_r).abs().max()),
                             u=float((us - u_r).abs().max())))
        if leg == "d":
            ego_s, us_s, _, carry = run_mpc_kernel_scan(cfg_e, w_e, x0_e,
                                                        *dr._episode_rows(sc_e, obs_e), ticks,
                                                        window=dr.WINDOW, with_carry=True)
            out[leg].update(
                scan_bitwise_leg=bool(torch.equal(ego_s, ego) and torch.equal(us_s, us)),
                mu_max=float(mu_r.max()), rho_max=float(rho_r.max()),
                rho_init=float(w_e.alm_rho_init),
                dual_rows_moved=int(((mu_r > 0).flatten(1).any(1)
                                     | (rho_r > w_e.alm_rho_init)).sum()))
            out[leg]["max_abs_err"]["mu"] = float((carry[1] - mu_r).abs().max())
            out[leg]["rho_equal"] = bool(torch.equal(carry[2], rho_r))
    return out


def dryrun_plain_gates(plain, records):
    """11: the gates of ``dryrun_against_plain`` and ``dryrun_records``."""
    for leg, rec in plain.items():
        n_equal = rec.get("rows_iters_status_equal", rec.get("rows_iters_status_equal_every_tick"))
        tol = DRYRUN_BARRIER_ATOL if leg == "b" else DRYRUN_ALM_ATOL
        check(n_equal == rec["rows"] and max(rec["max_abs_err"].values()) <= tol,
              f"dry run leg ({leg}) against the plain version on the card: {rec}")
    check(plain["b"]["cost_relerr"] <= DRYRUN_COST_RTOL,
          f"dry run leg (b): final cost against the plain version: {plain['b']}")
    check(plain["d"]["scan_bitwise_leg"] and plain["d"]["rho_equal"],
          f"dry run leg (d): duals against the plain version: {plain['d']}")
    solve, resume = records[0], records[1:]
    check(bool(solve["same"].all()) and solve["err"] <= DRYRUN_ALM_ATOL,
          f"dry run: the ALM kernel against its plain version: {solve['errs']}, iterations "
          f"and statuses equal on {int(solve['same'].sum())}/{solve['same'].numel()} rows")
    for rec in resume:
        check(rec["iters_status_equal"] == rec["rows"] and rec["err"] <= DRYRUN_ALM_ATOL,
              f"dry run: the ALM resume entry against its plain version: {rec['errs']}, "
              f"iterations and statuses equal on {rec['iters_status_equal']}/{rec['rows']} rows")


def weights_sweep_f64():
    """11: ``solve_batch(weights_batched=True)`` in float64 on the card, each
    row against a 0-d-weight solve with that row's weights; and the kernel
    path's refusal of the per-row weights (no launch)."""
    import torch
    from ilqr_tpu_torch.config import GlobalConfig
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
    from ilqr_tpu_torch.sim.scenario import build_scenario_setup
    from ilqr_tpu_torch.solvers.cilqr import solve, solve_batch
    from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights
    from ilqr_tpu_torch.utils.tree import tree_map

    f64, B = torch.float64, 3
    gc = GlobalConfig.from_file(str(REPO / "configs" / "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, max_iter=SWEEP_MAX_ITER)
    w = CILQRWeights.from_global_config(gc, f64, DEVICE)
    w_b = dataclasses.replace(tree_map(lambda a: a.expand(B).clone(), w), **{
        k: torch.tensor(v, dtype=f64, device=DEVICE) for k, v in SWEEP_ROWS.items()})
    x0 = torch.as_tensor(st.ego_x0, dtype=f64, device=DEVICE).expand(B, 4).contiguous()
    sc = st.device_scenario(tick=0, dtype=f64, device=DEVICE, batch=B)
    (u, x, stats, _), wall = timed_cuda(lambda: solve_batch(cfg, w_b, x0, sc,
                                                            weights_batched=True))
    rows = []
    for i in range(B):
        w_i = dataclasses.replace(w, **{k: getattr(w_b, k)[i] for k in SWEEP_ROWS})
        u_i, x_i, s_i, _ = solve(cfg, w_i, x0[i:i + 1], st.device_scenario(
            tick=0, dtype=f64, device=DEVICE))
        rows.append(dict(iters=int(stats.iters[i]), single_iters=int(s_i.iters[0]),
                         status=int(stats.status[i]), single_status=int(s_i.status[0]),
                         u_err=float((u[i] - u_i[0]).abs().max()),
                         x_err=float((x[i] - x_i[0]).abs().max())))
    before = sum(ck.launches.values())
    refused = None
    try:
        ck.cilqr_solve_cuda(cfg, w_b, x0, sc, window=256)
    except ValueError as err:  # the refusal is the gate
        refused = str(err)
    rec = dict(wall_s=wall, rows=rows, kernel_refused=refused,
               launches_at_refusal=sum(ck.launches.values()) - before)
    check(all(r["iters"] == r["single_iters"] and r["status"] == r["single_status"]
              and r["u_err"] <= ROW_ATOL and r["x_err"] <= ROW_ATOL for r in rows),
          f"per-row weights on the card differ from single solves: {rows}")
    check(refused is not None and rec["launches_at_refusal"] == 0,
          f"the kernel path took per-row weights (refused: {refused!r}, "
          f"launches {rec['launches_at_refusal']})")
    return rec


def repo_tests_module(name):
    """``tests/<name>.py`` of this checkout, imported as ``tests.<name>``.
    The machine may have another ``tests`` package installed (a regular
    package, which would win over this checkout's directory), so the name
    is bound to this checkout's directory first."""
    import importlib
    import types

    pkg = sys.modules.get("tests")
    if pkg is None or list(getattr(pkg, "__path__", [])) != [str(REPO / "tests")]:
        pkg = types.ModuleType("tests")
        pkg.__path__ = [str(REPO / "tests")]
        sys.modules["tests"] = pkg
        for key in [k for k in sys.modules if k.startswith("tests.")]:
            del sys.modules[key]
    mod = importlib.import_module(f"tests.{name}")
    check(Path(mod.__file__).resolve().is_relative_to(REPO),
          f"tests.{name} imported from outside this checkout: {mod.__file__}")
    return mod


def phase_dryrun(card, launches_total):
    """11: ``apps.dryrun`` on the card: ``entry()``, then
    ``dryrun_multichip(1)`` with the kernel's counts at 0 (legs (b)-(d)
    must launch it), each leg bitwise equal to the same call over the whole
    batch with no mesh (``single_device_legs``); the oracle checks of
    ``tests/test_torch_oracle.py`` on the card in float64; the per-row
    weight sweep and the kernel's refusal. Returns the kernel records of
    the ALM instantiation the dry run launches."""
    import torch
    from ilqr_tpu_torch.apps import dryrun as dr
    from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck

    t_phase = time.perf_counter()
    nvidia_smi = gpu_line()
    print(nvidia_smi, flush=True)
    fn, args = dr.entry(DEVICE)
    (u, _, iters, converged), entry_s = timed_cuda(lambda: fn(*args))
    entry_rec = dict(wall_s=entry_s, shape=list(u.shape), mean_iters=float(iters.double().mean()),
                     converged=int(converged.sum()))
    check(tuple(u.shape) == (8, 30, 2) and bool(torch.isfinite(u).all()),
          f"entry(): {entry_rec}")

    walls, leg_launches = {}, {}
    torch.cuda.synchronize()
    ck.launches.clear()
    t_leg = [time.perf_counter()]

    def on_leg(leg):
        now = time.perf_counter()
        walls[leg] = now - t_leg[0]
        leg_launches[leg] = dict(ck.launches)
        t_leg[0] = now

    legs = dr.dryrun_multichip(DRYRUN_DEVICES, DEVICE, on_leg=on_leg)
    dry_launches = dict(ck.launches)
    per_leg, prev = {}, {}
    for leg in "abcd":
        per_leg[leg] = {k: v - prev.get(k, 0) for k, v in leg_launches[leg].items()
                        if v - prev.get(k, 0)}
        prev = leg_launches[leg]
    single = dr.single_device_legs(dr.ROWS_PER_DEVICE * DRYRUN_DEVICES, DEVICE)
    bitwise = {leg: all(torch.equal(a, b) for a, b in zip(dr.leg_tensors(legs[leg]),
                                                            dr.leg_tensors(single[leg])))
               for leg in "abcd"}
    oracle_mod = repo_tests_module("test_torch_oracle")
    oracle = {}
    for name, check_fn in oracle_mod.CHECKS.items():
        rec, wall = timed_cuda(lambda: check_fn(DEVICE))
        oracle[name] = dict(rec, wall_s=wall)
    sweep = weights_sweep_f64()
    plain = dryrun_against_plain(legs)
    records = dryrun_records(dry_launches)
    launches_total.update(dry_launches)
    say("phase11_dryrun", card=card, nvidia_smi=nvidia_smi, devices=DRYRUN_DEVICES,
        entry=entry_rec, leg_walls_s=walls, leg_launches=per_leg, launches=dry_launches,
        bitwise_single_device=bitwise, against_plain=plain,
        against_plain_tol=dict(alm_atol=DRYRUN_ALM_ATOL, barrier_atol=DRYRUN_BARRIER_ATOL,
                               cost_rtol=DRYRUN_COST_RTOL),
        final_ego_x_mean=float(legs["d"][0][-1, :, 0].mean()),
        oracle=oracle, oracle_atol=dict(first_tick=oracle_mod.TICK_ATOL,
                                        alm_mode=oracle_mod.TICK_ATOL,
                                        mpc_ticks=oracle_mod.MPC_ATOL,
                                        warm_start=oracle_mod.MPC_ATOL),
        weights_batched=sweep,
        alm_kernel=[dict(variant=r["variant"], max_abs_err=r["errs"],
                         iters_status_equal=int(r["same"].sum()) if "same" in r
                         else r["iters_status_equal"], kernel_ms=r["ms"],
                         plain_ms=r["plain_ms"], plain_work=r["work"]) for r in records],
        phase_s=time.perf_counter() - t_phase)
    dryrun_plain_gates(plain, records)
    check(all(bitwise.values()), f"dry run: legs differ from the single-device calls: {bitwise}")
    check(not per_leg["a"] and all(per_leg[leg] for leg in "bcd"),
          f"dry run: the kernel must launch in legs (b)-(d) and not in (a): {per_leg}")
    check(any("_barrier" in v for v in per_leg["b"])
          and all(any("_alm" in v for v in per_leg[leg]) for leg in "cd"),
          f"dry run: (b) must launch the barrier instantiation, (c) and (d) the ALM one: "
          f"{per_leg}")
    return records


def main():
    import torch
    from ilqr_tpu_torch.apps import validate_kernel as vk

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card, ptxas = phase_env()
    repro_kernels = phase_debug_repros(card)  # first, while the host is quiet
    records = [rec for case in vk.CASES for rec in phase_semantics_f64(case)]
    phase_f32_anchor()
    records += [rec for path in PATHS for rec in phase_f32_path_shape(path)]
    phase_bitwise_f32()
    launches = collections.Counter()  # summed over the path runs, each counted from 0
    host_loop = {"main": phase_main(card, launches)}
    for path in PATHS:
        if path != "main":
            host_loop[path] = phase_path(path, card, launches)
    phase_graph(card, launches, host_loop)
    phase_sweep(card, launches)
    for case in EPISODES_F64:
        launches.update(phase_episode_f64(case))
    phase_demos(card)
    records += phase_dryrun(card, launches)
    # one entry per kernel the paths launched: its time on its first
    # record's inputs, its error the largest of its records'
    measured = {}
    for rec in [r for r in records if r is not None]:
        first = measured.setdefault(rec["variant"], dict(rec))
        first["err"] = max(first["err"], rec["err"])
    check(set(launches) <= set(measured),
          f"launched but not measured: {sorted(set(launches) - set(measured))}")
    kernels = []
    for name in sorted(launches):
        rec = measured[name]
        bound_ms, bound_by = bound(rec["cfg"], rec["dtype"], rec["shape"], rec["work"])
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces(name),
            "launches": launches[name], "max_abs_err": rec["err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "batch": rec["shape"]["B"], **ptxas[compiled_name(name)]})
    say("done", script_s=time.perf_counter() - t_start,
        measured_not_on_paths={name: dict(ms=rec["ms"], plain_ms=rec["plain_ms"],
                                          max_abs_err=rec["err"], batch=rec["shape"]["B"])
                               for name, rec in sorted(measured.items()) if name not in launches})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels + repro_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
