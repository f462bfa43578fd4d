"""K1's record -- its solves' clocks by phase and its counts of iterations,
line-search chunks, trials judged, statuses and window-scan trips -- run
on the CPU.

The CUDA kernel's source is built for the host with the emulation header,
as ``tests/test_torch_kernel_emulated.py`` builds it. There ``clock64()``
counts the reads of the calling thread, so a phase's clocks count the
marks that closed it: the record's phases then say where each mark sits
(one a solve for staging and the initial rollout, one an iteration for
the derivatives and the Riccati pass, one a chunk for the rollouts, one a
trial for the projection and for the cost). The counts are held in float64
to the plain version's tally of the same solves (``work``); in float32 the
plain version parts from the kernel by rounding, so there each launch of
one iteration through the resume entry holds the status counts to the
statuses it returns, and the trials and chunks to the bounds the statuses
set. Cells' shapes: N 30, window 384, the scenario's rows a step, the
card's modes (dot form, chunks of 4); rear and gravity center, barrier and
ALM, M = 3 and M = 8, cold and warm (the next tick's start, controls
shifted).
"""

import dataclasses
import math

import pytest
import torch

from ilqr_tpu_torch.apps.validate_kernel import packed_cold
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.solvers.cilqr import alpha_schedule
from ilqr_tpu_torch.utils import counters
from tests.test_torch_kernel_emulated import (  # noqa: F401
    _emulated, build_emulated, busiest_rows, kernel_lib)

B = 8
MODES = ck.Modes(True, 4, False)
COUNTS = ("iters", "chunks", "trials") + counters.K1_STATUSES
# (scenario, config overrides, warm)
SHAPES = {
    "two_straight_warm": ("scenario_two_straight", {}, True),
    "two_straight_cold": ("scenario_two_straight", {}, False),
    "three_bend_cold": ("scenario_three_bend", {}, False),
    "three_bend_warm": ("scenario_three_bend", {}, True),
    "three_straight_warm": ("scenario_three_straight", {}, True),
    "three_straight_cold": ("scenario_three_straight", {}, False),
    "three_bend_alm": ("scenario_three_bend", {"solve_type": "alm"}, False),
}


def _problem(shape: str, dtype):
    """(cfg, w, p) of B solves of ``shape``: a cold first tick, or the
    tick after it warm-started from the plain version's controls
    shifted by one step."""
    name, over, warm = SHAPES[shape]
    cfg, w, p = packed_cold(name, B, dtype, "cpu", modes=MODES, **over)
    if warm:
        r = ck.cilqr_solve_ref(cfg, w, p)
        p = dataclasses.replace(p, x0=torch.cat([r.x[:, 1], p.x0[4:]]),
                                uinit=torch.cat([r.u[:, 1:], r.u[:, -1:]], 1).contiguous())
    return cfg, w, p


def _run(solve, cfg, w, p, **kw):
    """``solve`` from a zeroed record; (its output, the record)."""
    counters.reset()
    out = solve(cfg, w, p, **kw)
    return out, counters.k1_totals()


def check_marks(rec: dict, rows: int) -> None:
    """The record of emulated launches: each phase's clocks count the marks
    that closed it, and the eight phases sum to the solves' clocks; the
    scan's trips are ``rows`` (the busiest lane's, ``busiest_rows``) in
    each projection, one a solve and one a trial."""
    assert rec["p0_stage"] == rec["p1_init"] == rec["solves"]
    assert rec["p2_deriv"] == rec["p3_backward"] == rec["iters"]
    assert rec["p4_forward"] == rec["chunks"]
    assert rec["p5_project"] == rec["p6_cost"] == rec["trials"]
    assert rec["p7_rest"] == rec["iters"] + rec["solves"]
    assert sum(rec[ph] for ph in counters.K1_PHASES) == rec["clocks"]
    assert rec["solve_ns"] > 0
    assert sum(rec[s] for s in counters.K1_STATUSES) == rec["iters"]
    assert rec["scan_trips"] == rows * (rec["solves"] + rec["trials"])


def check_against_plain(rec: dict, out, work: dict, rows: int) -> None:
    """The record of one launch of B solves against the plain version's
    tally of the same solves (float64: the same iterates)."""
    assert rec["solves"] == B and rec["launches"] == 1
    assert rec["iters"] == int(out.stats[0].sum())
    assert rec["converged"] == int((out.stats[2] > 0.5).sum())
    assert rec["chunks"] == work["chunks"] and rec["trials"] == work["evals"]
    assert {s: rec[s] for s in counters.K1_STATUSES} == {s: work[s] for s in
                                                        counters.K1_STATUSES}
    check_marks(rec, rows)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("shape", ["two_straight_cold", "three_bend_warm",
                                   "three_straight_cold", "three_bend_alm"])
def test_record_equals_plain_tally_f64(kernel_lib, shape):
    """Float64: the iterations are the stats' summed ``iters``, and the
    chunks, trials and statuses the plain version's tally."""
    cfg, w, p = _problem(shape, torch.float64)
    out, rec = _run(_emulated(kernel_lib), cfg, w, p)
    work = {}
    ref = ck.cilqr_solve_ref(cfg, w, p, work=work)
    assert torch.equal(out.stats[:2], ref.stats[:2])
    check_against_plain(rec, out, work, busiest_rows(p.row_limits))


def _bounds(rec: dict, n_alphas: int, width: int) -> None:
    """The trials and chunks the statuses allow: one trial and one chunk
    for an iteration accepted at alpha 1 or converged, every alpha for an
    exhausted search, two or more for a smaller step, none after a failed
    backward pass."""
    one = rec["accepted_full"] + rec["converged"]
    small = rec["accepted_small"]
    base = one + n_alphas * rec["ls_exhausted"]
    assert base + 2 * small <= rec["trials"] <= base + n_alphas * small
    chunks = one + math.ceil(n_alphas / width) * rec["ls_exhausted"]
    assert chunks + small <= rec["chunks"] <= chunks + math.ceil(n_alphas / width) * small


@pytest.mark.timeout(240)
@pytest.mark.parametrize("shape", ["two_straight_warm", "three_bend_cold",
                                   "three_straight_warm"])
def test_record_iteration_by_iteration_f32(kernel_lib, shape):
    """Float32: one launch's record equals the sum of the records of a
    launch an iteration (the resume entry, only the rows still running,
    bitwise the one launch); each of those counts its rows' iterations
    and, by status, the statuses they return; the trials and chunks lie
    within the statuses' bounds."""
    cfg, w, p = _problem(shape, torch.float32)
    solve = _emulated(kernel_lib)
    busiest = busiest_rows(p.row_limits)
    one, whole = _run(solve, cfg, w, p)
    assert whole["solves"] == B and whole["launches"] == 1
    assert whole["iters"] == int(one.stats[0].sum())
    check_marks(whole, busiest)
    _bounds(whole, len(alpha_schedule(cfg.min_alpha)), MODES.ls_chunk)
    out, summed = None, dict.fromkeys(COUNTS, 0)
    for it in range(cfg.max_iter):
        rows = torch.arange(B) if out is None else ck.stragglers(out)
        if rows.numel() == 0:
            break
        sub = p if out is None else ck.resume_problem(p, out, rows, it)
        part, rec = _run(solve, cfg, w, sub, max_iter=it + 1)
        assert rec["solves"] == rows.numel() and rec["iters"] == rows.numel()
        status = part.stats[1].round().long()
        assert [rec[s] for s in counters.K1_STATUSES] == torch.bincount(
            status, minlength=len(counters.K1_STATUSES)).tolist()
        check_marks(rec, busiest)
        for key in COUNTS:
            summed[key] += rec[key]
        out = part if out is None else ck.PackedSolution(
            *(None if full is None else full.index_copy(-1, rows, new)
              for full, new in zip(out, part)))
    assert all(torch.equal(a, b) for a, b in zip(one[:3], out[:3]))
    assert summed == {key: whole[key] for key in COUNTS}


@pytest.mark.timeout(240)
@pytest.mark.parametrize("shape,dtype", [("two_straight_warm", torch.float32),
                                         ("three_straight_warm", torch.float64)], ids=str)
def test_outputs_do_not_depend_on_the_record(kernel_lib, shape, dtype):
    """Two launches with the record zeroed between them: the outputs are
    equal bit for bit and so is the record, but the nanoseconds; a launch
    on a record left as it was adds to it."""
    cfg, w, p = _problem(shape, dtype)
    solve = _emulated(kernel_lib)
    a, first = _run(solve, cfg, w, p)
    b, second = _run(solve, cfg, w, p)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    first.pop("solve_ns"), second.pop("solve_ns")
    assert first == second
    solve(cfg, w, p)
    both = counters.k1_totals()
    assert both["iters"] == 2 * first["iters"] and both["launches"] == 2


@pytest.mark.timeout(240)
def test_a_skipped_trial_count_fails(tmp_path):
    """The checks catch a kernel that skips one trial's count (the first
    trial of each chunk): the same solves, another tally."""
    src = ck._SOURCE.read_text()
    count = "          count(kTrials);\n"
    assert src.count(count) == 1
    lib = build_emulated(src.replace(count, "          if (a > 0) count(kTrials);\n"), tmp_path)
    cfg, w, p = _problem("two_straight_cold", torch.float64)
    out, rec = _run(_emulated(lib), cfg, w, p)
    work = {}
    ck.cilqr_solve_ref(cfg, w, p, work=work)
    rows = busiest_rows(p.row_limits)
    with pytest.raises(AssertionError):
        check_against_plain(rec, out, work, rows)
    with pytest.raises(AssertionError):
        check_marks(rec, rows)


# projection modes and limits -> the busiest lane's rows a projection:
# the split scan at the cells' limits, serial or in chunks, squared or dot
# form; the fold, which splits nothing (the longest limit); the full
# window's uniform limits, where nothing splits and each lane scans its
# own rows
SCAN_CASES = {
    "dot_chunks": (MODES, False, 180),
    "squared_serial": (ck.Modes(), False, 180),
    "fold": (ck.Modes(True, 4, True), False, 312),
    "uniform": (MODES, True, 384),
}


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_trips_in_each_projection_mode(kernel_lib, case):
    """Float64, two iterations: ``scan_trips`` is the busiest lane's rows
    (``busiest_rows``, or the longest limit with the fold) times the
    projections, one a solve and one a trial judged; iterations and
    statuses equal the plain version's."""
    modes, uniform, rows = SCAN_CASES[case]
    cfg, w, p = packed_cold("scenario_two_straight", 4, torch.float64, "cpu", modes=modes)
    if uniform:
        p = dataclasses.replace(p, row_limits=ck.row_limits(cfg.N, p.window, p.w_back, 0))
    assert rows == (max(p.row_limits) if modes.proj_fold else busiest_rows(p.row_limits))
    out, rec = _run(_emulated(kernel_lib), cfg, w, p, max_iter=2)
    ref = ck.cilqr_solve_ref(cfg, w, p, max_iter=2)
    assert torch.equal(out.stats[:2], ref.stats[:2])
    assert rec["solves"] == 4 and rec["trials"] >= rec["iters"] > 0
    assert rec["scan_trips"] == rows * (rec["solves"] + rec["trials"])


def test_record_allocated_once_and_zeroed_in_place(monkeypatch):
    """One record a device, allocated at its first use and kept; ``reset``
    zeroes it in place; ``k1_totals`` is None before any launch."""
    monkeypatch.setattr(counters, "k1_records", {})
    assert counters.k1_totals() is None
    rec = ck.k1_record("cpu")
    assert rec is ck.k1_record(torch.device("cpu"))
    assert rec.dtype == torch.int64 and rec.shape == (len(counters.K1_FIELDS),)
    rec += 3
    assert counters.k1_totals() == dict.fromkeys(counters.K1_FIELDS, 3)
    counters.reset()
    assert ck.k1_record("cpu") is rec and not rec.any()
