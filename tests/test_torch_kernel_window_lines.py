"""Per-row reference lines through the kernel's source, run on the CPU.

Each row of a batch gets a line of its own, (3, P, B), and the CUDA
kernel built for the host with the emulation header
(``tests/test_torch_kernel_emulated.py``) derives every row's window from
it. In float64 it is held to the plain version (iterations and statuses
equal, u and x within 1e-9), and straggler compaction, which gathers the
rows' lines for each phase, to one launch bit for bit. The window's own
derivation is ``tests/test_torch_kernel_window.py``.
"""

import dataclasses

import pytest
import torch

from ilqr_tpu_torch.apps.validate_kernel import CASES, packed_cold
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from tests.test_torch_kernel_emulated import _bitwise, _emulated, kernel_lib  # noqa: F401


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
