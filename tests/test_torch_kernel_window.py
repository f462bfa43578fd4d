"""The kernel's own reference-line window, run on the CPU.

The CUDA kernel derives each solve's window from the line and the
solve's start: the first minimum of the squared distance over every line
row (torch.argmin's, a NaN first), ``w_back`` rows behind it, clamped at
0, rows past P - 1 repeating it, and the searched rows staged as x and y
or as the dot form's terms. Built for the host with the emulation header
(``tests/test_torch_kernel_emulated.py``), its read-back of the start and
the staged rows is held bit for bit to ``ck.window_rows`` and
``dot_terms``: on planted ties (between lanes and within one), a start
behind row ``w_back``, a window past the line's end, a NaN start and NaN
line rows, on a line the batch shares and on per-row lines.
"""

import dataclasses

import pytest
import torch

from ilqr_tpu_torch.apps.validate_kernel import CASES, packed_cold
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.ops.projection import dot_terms
from tests.test_torch_kernel_emulated import _bitwise, _emulated, kernel_lib  # noqa: F401

P, W, W_BACK = 700, 96, 24
# each solve's start (x, y) on the planted line (x = 0.5 r, rows 228..291
# a copy of rows 100..163): mid-line; nearest row 10 < w_back (start 0);
# a window past P - 1; a NaN start; equidistant from rows 120, 121 and
# their copies 248, 249 (two lanes, each twice); mid-line (its per-row line
# holds NaN rows 333 and 400)
STARTS = [(75.1, 0.3), (5.0, 0.2), (0.5 * (P - 20), -0.1), (float("nan"), 0.0),
          (60.25, 0.0), (200.05, 0.1)]
WANT_NEAREST = [150, 10, P - 20, 0, 120, 400]


def _same_bits(a, b):
    """Equal bit for bit (-0 apart from +0), every NaN counted as one."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a.masked_fill(nan, 0).view(ints),
                                                        b.masked_fill(nan, 0).view(ints))


def _line(dtype, per_row: bool):
    """The planted line, (3, P), or per row (3, P, B): row b's shifted by
    0.125 b sideways, row 5's with NaN at rows 333 and 400."""
    r = torch.arange(P, dtype=dtype)
    line = torch.stack([0.5 * r, torch.zeros_like(r), 0.001 * r])
    line[:, 228:292] = line[:, 100:164]
    if not per_row:
        return line
    B = len(STARTS)
    rows = line[:, :, None].repeat(1, 1, B)
    rows[1] += 0.125 * torch.arange(B, dtype=dtype)
    rows[0, 333, 5] = rows[0, 400, 5] = float("nan")
    return rows.contiguous()


def _problem(dtype, per_row: bool, proj_dot: bool):
    cfg, w, p = packed_cold("scenario_two_straight", len(STARTS), dtype, "cpu",
                            modes=ck.Modes(proj_dot, 0, False))
    x0 = p.x0.clone()
    x0[:2] = torch.tensor(STARTS, dtype=dtype).T
    return cfg, w, dataclasses.replace(p, x0=x0, line=_line(dtype, per_row), window=W,
                                       w_back=W_BACK, row_limits=(W,) * (cfg.N + 1))


@pytest.mark.parametrize("proj_dot", [False, True], ids=["squared", "dot"])
@pytest.mark.parametrize("lines", ["shared", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_kernel_window_bitwise_plain_derivation(kernel_lib, dtype, lines, proj_dot):
    """The start and every staged row the kernel derives equal the plain
    derivation bit for bit, and the starts are the planted ones."""
    cfg, w, p = _problem(dtype, lines == "per_row", proj_dot)
    F = 3 if proj_dot else 2
    out = torch.full((1 + F * W, len(STARTS)), 7.0, dtype=dtype)
    _emulated(kernel_lib, out)(cfg, w, p, max_iter=0)
    start = ck.window_start(p.line, p.x0, W_BACK)
    nearest = list(WANT_NEAREST)
    if lines == "per_row":
        nearest[5] = 333  # the first NaN row
    assert start.tolist() == [max(n - W_BACK, 0) for n in nearest]
    assert torch.equal(out[0], start.to(dtype))
    rx, ry, _ = ck.window_rows(p)
    assert bool((rx[-1] == rx[-2]).any())  # a tail repeating row P - 1
    staged = dot_terms(rx, ry, dim=0) if proj_dot else (rx, ry)
    for f, want in enumerate(staged):
        assert _same_bits(out[1 + f * W:1 + (f + 1) * W], want), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_kernel_window_nan_and_ties_follow_torch_argmin(kernel_lib, dtype):
    """torch.argmin's order on its own: a NaN score is the minimum and the
    first NaN wins; equal scores go to the lower row; the kernel's start
    on the same scores is that row's, less w_back."""
    d2 = torch.tensor([[3.0, float("nan"), 1.0, float("nan")], [2.0, 1.0, 1.0, 0.5],
                       [1.0, 1.0, 1.0, 1.0]], dtype=dtype)
    assert torch.argmin(d2, dim=1).tolist() == [1, 3, 0]
    cfg, w, p = _problem(dtype, False, False)
    out = torch.empty((1 + 2 * W, len(STARTS)), dtype=dtype)
    _emulated(kernel_lib, out)(cfg, w, p, max_iter=0)
    assert int(out[0, 3]) == 0 and int(out[0, 4]) == 120 - W_BACK


@pytest.mark.parametrize("case", ["rear_barrier", "gravity_alm_duals_move"])
def test_emulated_per_row_lines_match_plain_f64(kernel_lib, case):
    """Per-row (3, P, B) lines, each row's its own: the kernel against the
    plain version in float64 (iterations and statuses equal, u and x
    within 1e-9), and compaction at (2, 5), which gathers the rows'
    lines, bitwise one launch."""
    name, over, wover = CASES[case]
    cfg, w, p = packed_cold(name, 5, torch.float64, "cpu", weights=wover,
                            modes=ck.Modes(True, 4, False), **over)
    shift = torch.tensor([[0.0] * 5, [0.0, 0.05, -0.05, 0.1, 0.0], [0.0] * 5],
                         dtype=torch.float64)
    line = p.line[:, :, None] + shift[:, None]
    p = dataclasses.replace(p, line=line.contiguous())
    solve = _emulated(kernel_lib)
    k = solve(cfg, w, p)
    r = ck.cilqr_solve_ref(cfg, w, p)
    assert torch.equal(k.stats[:2], r.stats[:2])
    for a, b in zip(k, r):
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-9
    assert _bitwise(k, ck.solve_packed(cfg, w, p, (2, 5), solve=solve))
