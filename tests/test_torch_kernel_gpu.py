"""The CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``; skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs on a GPU machine without the JAX package's
dependencies:  python -m pytest -m gpu tests/test_torch_kernel_gpu.py -q
"""

import dataclasses

import pytest
import torch

from ilqr_tpu_torch.apps.validate_kernel import CASES, packed_cold
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _packed(case, dtype, dev, B, modes=ck.Modes()):
    """A ``CASES`` entry's cold problem; squared distance and serial line
    search unless ``modes`` says otherwise."""
    name, over, wover = CASES[case]
    return packed_cold(name, B, dtype, dev, weights=wover, modes=modes, **over)


def _same_rows_close(k, r, alm, tol=1e-6):
    """Iterations and statuses equal on >= 99% of rows, u, x and the duals
    within ``tol`` on those rows."""
    same = (k.stats[0] == r.stats[0]) & (k.stats[1] == r.stats[1])
    assert int(same.sum()) >= 0.99 * same.numel()
    assert float((k.u - r.u).abs()[:, :, same].max()) <= tol
    assert float((k.x - r.x).abs()[:, :, same].max()) <= tol
    if alm:
        assert float((k.mu - r.mu).abs()[:, :, same].max()) <= tol
        assert float((k.rho - r.rho).abs()[same].max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_gpu(cuda_device, case):
    """Double kernel vs double plain version on the main path's window:
    iterations and statuses equal on >= 99% of rows (a threshold decision
    can flip on 1e-16 sum-order differences), u, x and the duals within
    1e-6 on those rows; one launch counted, on this instantiation."""
    B = 200  # 200 blocks of one warp
    cfg, w, p = _packed(case, torch.float64, cuda_device, B)
    name = ck.variant(cfg, torch.float64)
    launches = ck.launches[name]
    k = ck.cilqr_solve_kernel(cfg, w, p)
    torch.cuda.synchronize()
    assert ck.launches[name] == launches + 1
    r = ck.cilqr_solve_ref(cfg, w, p)
    _same_rows_close(k, r, cfg.solve_type == "alm")
    if case == "gravity_alm_duals_move":
        assert float(r.mu.max()) > 0 and float(r.rho.max()) > 20.0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["gravity_barrier", "rear_alm", "gravity_alm"])
def test_float32_instantiation_runs(cuda_device, case):
    """The float32 builds launch, finish with finite outputs and agree with
    the plain float32 version on most rows (float32 chaos flips some)."""
    B = 256
    cfg, w, p = _packed(case, torch.float32, cuda_device, B)
    k = ck.cilqr_solve_kernel(cfg, w, p)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(k.u).all() and torch.isfinite(k.x).all())
    r = ck.cilqr_solve_ref(cfg, w, p)
    assert float(((k.stats[1] == r.stats[1]).float()).mean()) >= 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("modes", [ck.Modes(), ck.Modes(False, 0, True), ck.Modes(True, 4, True)],
                         ids=["squared", "fold", "dot_fold_ls"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_compaction_bitwise(cuda_device, case, dtype, modes):
    """Straggler compaction at caps (2, 5) equals one launch bit for bit, in
    every instantiation; the later phases go through the resume entry. With
    the fold on, the resume entry folds the resumed rows again, with a
    scratch sized and strided for the sub-batch."""
    B = 200
    cfg, w, p = _packed(case, dtype, cuda_device, B, modes)
    one = ck.cilqr_solve_kernel(cfg, w, p)
    resume = ck.variant(cfg, dtype, modes) + "_resume"
    before = ck.launches[resume]
    comp = ck.solve_packed(cfg, w, p, (2, 5))
    torch.cuda.synchronize()
    assert 1 <= ck.launches[resume] - before <= 2
    for a, b in zip(one, comp):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_resume_matches_plain_f64(cuda_device, case):
    """The double resume entry against the resumed plain version, from the
    same stopped state (the kernel's own solve capped at 5 iterations):
    iterations and statuses equal on >= 99% of the resumed rows, u, x and
    the duals within 1e-6 on those rows."""
    cfg, w, p = _packed(case, torch.float64, cuda_device, 200)
    first = ck.cilqr_solve_kernel(cfg, w, p, max_iter=5)
    rows = ck.stragglers(first)
    assert rows.numel() > 0
    sub = ck.resume_problem(p, first, rows, 5)
    k = ck.cilqr_solve_kernel(cfg, w, sub)
    _same_rows_close(k, ck.cilqr_solve_ref(cfg, w, sub), cfg.solve_type == "alm")


@pytest.mark.gpu
@pytest.mark.parametrize("planted", [False, True], ids=["repro", "planted"])
@pytest.mark.parametrize("bp", [1, 5, 2047, 2048, 2049])
@pytest.mark.parametrize("repro", ["resume_echo", "dataflow", "carry", "zerotrip", "carry_1trip"])
def test_debug_repro_kernels_bitwise(cuda_device, repro, bp, planted):
    """The ``tools/debug`` repro kernels equal their plain versions bit for
    bit on the repros' inputs at ``bp`` columns (odd widths: a float4 quad
    straddles two rows, and one of ``carry`` its zero rows), and on planted
    -0, +-inf and NaN (kernel and plain version both on the card, whose NaN
    is one), one launch each; ``carry`` with 2, 0 and 1 trips."""
    from ilqr_tpu_torch.ops.cuda import debug_repros as dr

    ins = dr.repro_inputs(cuda_device, bp, planted)
    before = sum(dr.launches.values())
    if repro == "resume_echo":
        got, want = (dr.resume_echo(*ins["resume"]),), (dr.resume_echo_ref(*ins["resume"]),)
    elif repro == "dataflow":
        x, done = ins["dataflow"]
        got = dr.dataflow(x, done)
        u, s = dr.dataflow_k1_ref(x)
        perm = torch.argsort(done, stable=True)
        out = dr.dataflow_k2_ref(u[:, perm], s[:, perm])[:, torch.argsort(perm)]
        want = (out, u, s)
    else:
        x0, res = ins["carry"]
        fn, trips = {"carry": (dr.carry, 2), "zerotrip": (dr.zerotrip, 0),
                     "carry_1trip": (lambda a, b: dr.carry_trips(a, b, 1), 1)}[repro]
        got = (fn(x0, res),)
        want = (dr.carry_ref(x0, res, trips),)
    torch.cuda.synchronize()
    assert sum(dr.launches.values()) - before == (2 if repro == "dataflow" else 1)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# the projection modes (ilqr_tpu/ops/pallas/cilqr_kernel.py:267, :368), with
# chunks of 4 (:844), as the card resolves them
MODES = {"dot": ck.Modes(True, 4, False), "fold": ck.Modes(False, 4, True),
         "dot_fold": ck.Modes(True, 4, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_modes_match_plain_on_gpu(cuda_device, case, mode):
    """Each projection mode of the double kernel against the double plain
    version in the same mode, under the gate of the squared distance; one
    launch counted, under the mode's name."""
    cfg, w, p = _packed(case, torch.float64, cuda_device, 200, MODES[mode])
    name = ck.variant(cfg, torch.float64, p.modes)
    assert name.endswith(f"_{mode}_ls")
    launches = ck.launches[name]
    k = ck.cilqr_solve_kernel(cfg, w, p)
    torch.cuda.synchronize()
    assert ck.launches[name] == launches + 1
    _same_rows_close(k, ck.cilqr_solve_ref(cfg, w, p), cfg.solve_type == "alm")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_chunked_line_search_bitwise(cuda_device, case, dtype):
    """Chunks of 3, 4 and 8 alphas equal the serial line search bit for bit
    (dot form on), also with compaction at (2, 5)."""
    cfg, w, p = _packed(case, dtype, cuda_device, 200, ck.Modes(proj_dot=True))
    serial = ck.cilqr_solve_kernel(cfg, w, p)
    for width in (3, 4, 8):
        pc = dataclasses.replace(p, modes=ck.Modes(True, width, False))
        for out in (ck.cilqr_solve_kernel(cfg, w, pc), ck.solve_packed(cfg, w, pc, (2, 5))):
            for a, b in zip(serial, out):
                assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_kernel_window_start_matches_torch_argmin(cuda_device, dtype):
    """At the main path's shape (8192 starts of scenario_two_straight,
    window 384, w_back 24, the derived search bound, the card's modes),
    each window start the kernel derives equals ``ck.window_start``'s
    (torch.argmin on the card, over the same line and starts) bit for bit,
    and so does every staged row (``ck.window_rows``, ``dot_terms``). The
    line holds planted copies of rows 300 and 301 at rows 345 and 365
    (tied across lanes and within one) with starts on them, and one start
    is clamped at row 0."""
    from ilqr_tpu_torch.ops.projection import dot_terms

    cfg, w, p = packed_cold("scenario_two_straight", 8192, dtype, cuda_device)
    line = p.line.clone()
    line[:, 345], line[:, 365] = line[:, 300], line[:, 301]
    x0 = p.x0.clone()
    x0[:2, 0], x0[:2, 1], x0[:2, 2] = line[:2, 300], line[:2, 301], line[:2, 5]
    p = dataclasses.replace(p, x0=x0, line=line)
    R, F = max(p.row_limits), 3 if p.modes.proj_dot else 2
    out = torch.empty((1 + F * R, 8192), dtype=dtype, device=cuda_device)
    ck.cilqr_solve_kernel(cfg, w, p, window_out=out)
    start = ck.window_start(p.line, p.x0, p.w_back)
    torch.cuda.synchronize()
    assert start[:3].tolist() == [300 - 24, 301 - 24, 0]
    assert torch.equal(out[0], start.to(dtype))
    rx, ry, _ = (t[:R] for t in ck.window_rows(p))
    staged = dot_terms(rx, ry, dim=0) if p.modes.proj_dot else (rx, ry)
    for f, want in enumerate(staged):
        assert torch.equal(out[1 + f * R:1 + (f + 1) * R], want), f



# the instantiations the cells run, each in its cell's shape: (scenario,
# warm, w_back); M = 3 but three_straight's 8 agents
CELL_SHAPES = {
    "rear_barrier_warm": ("scenario_two_straight", True, 24),
    "rear_barrier_cold_sweep": ("scenario_two_straight", False, 64),
    "gravity_barrier_cold": ("scenario_three_bend", False, 24),
    "gravity_barrier_warm_m8": ("scenario_three_straight", True, 24),
}
# every shape on its line, and the S-bend's on a line cut short (on the
# straight lines a cut that short leaves the barrier costs at 1e11 and
# more, where float32's sum order parts the kernel from the plain version)
SCAN_CASES = [(shape, False) for shape in CELL_SHAPES] + [("gravity_barrier_cold", True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cut", SCAN_CASES,
                         ids=[f"{s}-{'past_line_end' if c else 'line'}" for s, c in SCAN_CASES])
def test_split_scan_matches_plain_f32(cuda_device, shape, cut):
    """Float32 in the card's modes at the cells' row limits (window 384,
    the cell's w_back, the scenario's rows a step), where each
    projection's scan is split across lanes (a pair's limits differ);
    warm shapes start from the plain version's controls shifted by a step. ``past_line_end``: the line ends 146 rows past the
    earliest start's nearest row, so every window's tail repeats the
    line's last row, tied in every score, from before the pairs' splits
    through them. One iteration (the initial projection and every trial's
    of the line search), the kernel against the plain version from the
    same inputs: over the rows, the 90th percentile of the relative error
    of u, x and the cost under 1e-4. The emulated kernel reads at most
    9e-6 in these shapes, and with the long lanes' second runs dropped
    0.05-3e11 in four of the five. Statuses are not compared: warm starts
    sit at the line search's thresholds, where float32 flips some. The
    scan alone is held bit for bit on the card by
    ``test_torch_kernel_emulated.py::test_scan_split_bitwise_on_card``."""
    name, warm, w_back = CELL_SHAPES[shape]
    B = 512
    cfg, w, p = packed_cold(name, B, torch.float32, cuda_device, modes=ck.Modes(True, 4, False))
    rows = ck.derive_proj_rows(float(p.x0[6, 0]), float(w.dt))  # the target speed's
    assert ck.row_limits(cfg.N, p.window, p.w_back, rows) == p.row_limits
    p = dataclasses.replace(p, w_back=w_back,
                            row_limits=ck.row_limits(cfg.N, p.window, w_back, rows))
    if warm:
        r = ck.cilqr_solve_ref(cfg, w, p)
        p = dataclasses.replace(p, x0=torch.cat([r.x[:, 1], p.x0[4:]]),
                                uinit=torch.cat([r.u[:, 1:], r.u[:, -1:]], 1).contiguous())
    lim = p.row_limits
    splits = [(a + b + 1) // 2 for a, b in zip(lim, reversed(lim)) if a < b]
    assert splits
    if cut:
        start = ck.window_start(p.line, p.x0, p.w_back)
        P = int(start.min()) + w_back + 146
        p = dataclasses.replace(p, line=p.line[:, :P].contiguous())
        assert int((P - 1 - start).max()) < min(splits)
    k = ck.cilqr_solve_kernel(cfg, w, p, max_iter=1)
    r = ck.cilqr_solve_ref(cfg, w, p, max_iter=1)
    for a, b in ((k.u, r.u), (k.x, r.x), (k.stats[4:5], r.stats[4:5])):
        err = ((a - b).abs() / (1 + b.abs())).reshape(-1, B).amax(0)
        assert float(torch.quantile(err.double(), 0.9)) <= 1e-4
